"""The ``ring_rdma`` tier: the whole exact ring reduce-scatter as one kernel.

Port of ``rdma_ring_reduce_scatter`` and ``_rdma_ring_kernel`` of
``dlrover_tpu/ops/pallas/ring_reduce_scatter.py``.  The kernel lives in
``dlrover_tpu_torch/csrc/rdma_ring.cu`` (its header gives the protocol, the
bound and the design).  Where the TPU kernel copies into its neighbours'
VMEM, this one stores into their windows: device memory that each rank
allocates and the others map (``parallel/peer_memory.PeerWindow``).

Three entry points:

* ``rdma_ring_reduce_scatter(x, group, window)``: the tier as the grad sync
  runs it, one rank per card, the neighbours' windows opened over CUDA IPC.
  On a CPU tensor it takes the plain ring through ``group.shift``.
* ``rdma_ring_one_card(xs, windows)``: every rank's buffer ``(W, W,
  width)`` on one card, the W ranks run as W groups of CTAs of one
  cooperative launch over ``windows`` (``OneCardWindows``, one allocation
  that the caller builds, checks and closes).  The same device code checks
  the protocol without a second card; ``chip_smoke.py`` and the ``cuda``
  tests use it.
* ``rdma_ring_plain(xs)``: the plain version, the ring's hop-order sum for
  every rank.

A wrapper adds one to ``launches["rdma_ring"]`` per launch, and only
launches: it never waits for the card.  Every wait in the kernel is
bounded (``timeout_s``, ``TIMEOUT_S`` by default).  A wait that runs out
writes the window's error record, and every later call on that window
leaves at once, so a stuck peer costs one timeout and not one per bucket.
The windows' ``check()`` reads the records (it waits for the calls queued
so far) and raises, naming the rank, the CTA and the stage; the trainer
calls it once per step, after the grad sync and before the update.  A
window that raised stays unusable: its flags no longer count the same
generations.  The step fails, and the job restarts from its last
checkpoint, as after a collective's timeout.
"""

import ctypes
from typing import Dict, Tuple

import torch

from dlrover_tpu_torch.ops.cuda import _build
from dlrover_tpu_torch.ops.cuda import ring_reduce_scatter as ring

KERNEL_SOURCE = "rdma_ring"
# long enough for a neighbour's host stall (a checkpoint write, a slow
# batch); a peer a minute late means a failing job
TIMEOUT_S = 60.0
# the reference's lane rule for this tier (select_transport)
LANE = 128
STAGES = {1: "entry barrier", 2: "handshake with the left neighbour",
          3: "handshake with the right neighbour", 4: "packet arrival"}

# launches since the last reset_launches()
launches = {"rdma_ring": 0}


def reset_launches() -> None:
    launches["rdma_ring"] = 0


def rdma_ring_plain(xs: torch.Tensor) -> torch.Tensor:
    """``xs`` ``(W, W, width)``, rank ``r``'s buffer ``xs[r]``: every rank's
    ``(width,)`` row of the sum, ``(W, width)``, added in the ring's hop
    order (rank ``i`` starts the packet ``xs[i][(i - 1) % W]``, and after
    each right-hop adds its row ``(i - t - 2) % W``)."""
    world = xs.shape[0]
    ranks = torch.arange(world, device=xs.device)
    p = xs[ranks, (ranks - 1) % world]
    for t in range(world - 1):
        p = torch.roll(p, 1, dims=0) + xs[ranks, (ranks - t - 2) % world]
    return p


# ---------------------------------------------------------------------------
# the library
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    "dlrover_rdma_layout": [_I, _LL, ctypes.POINTER(_LL)],
    "dlrover_rdma_launch_shape": [_I, ctypes.c_double, ctypes.POINTER(_I),
                                  ctypes.POINTER(_LL)],
    "dlrover_rdma_alloc": [_LL, ctypes.POINTER(_P)],
    "dlrover_rdma_free": [_P],
    "dlrover_rdma_ipc_handle": [_P, _P],
    "dlrover_rdma_ipc_open": [_P, ctypes.POINTER(_P)],
    "dlrover_rdma_ipc_close": [_P],
    "dlrover_rdma_ipc_handle_bytes": [],
    "dlrover_rdma_copy": [_P, _P, _LL],
    "dlrover_rdma_ring": [_P] * 6 + [_LL, _LL, _LL, _I, _I, _I,
                                      ctypes.c_uint, _I, _LL, _P],
    "dlrover_rdma_errors": [_P, _LL, _I, ctypes.POINTER(ctypes.c_uint), _P],
}

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load(KERNEL_SOURCE)
        for name, argtypes in _SIGNATURES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = _I
        _lib = lib
    return _lib


def _call(name: str, *args) -> None:
    rc = getattr(_library(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")


def window_layout(ctas: int, cap: int) -> Dict[str, int]:
    """Byte offsets of one rank's window (flags, slots), the elements per
    slot and its size in bytes."""
    out = (_LL * 4)()
    _call("dlrover_rdma_layout", ctas, cap, out)
    return dict(flags_off=out[0], slots_off=out[1], slot_elems=out[2],
                total=out[3])


def launch_shape(ranks_on_card: int, timeout_s: float) -> Tuple[int, int]:
    """``(CTAs per rank, timeout cycles)`` on the current device: the CTAs
    of ``ranks_on_card`` ranks all resident at once, and about
    ``timeout_s`` of SM cycles."""
    ctas, cycles = _I(), _LL()
    _call("dlrover_rdma_launch_shape", ranks_on_card, timeout_s,
          ctypes.byref(ctas), ctypes.byref(cycles))
    return ctas.value, cycles.value


def alloc(nbytes: int) -> int:
    """``nbytes`` of zeroed device memory from ``cudaMalloc`` (not torch's
    caching allocator, whose blocks do not map one to one to IPC
    handles)."""
    ptr = _P()
    _call("dlrover_rdma_alloc", nbytes, ctypes.byref(ptr))
    return ptr.value


def free(ptr: int) -> None:
    _call("dlrover_rdma_free", ptr)


def ipc_handle(ptr: int) -> bytes:
    size = _library().dlrover_rdma_ipc_handle_bytes()
    buf = ctypes.create_string_buffer(size)
    _call("dlrover_rdma_ipc_handle", ptr, buf)
    return buf.raw


def ipc_open(handle: bytes) -> int:
    ptr = _P()
    _call("dlrover_rdma_ipc_open", ctypes.create_string_buffer(handle,
                                                                len(handle)),
          ctypes.byref(ptr))
    return ptr.value


def ipc_close(ptr: int) -> None:
    _call("dlrover_rdma_ipc_close", ptr)


def copy(dst: int, src: int, nbytes: int) -> None:
    """Synchronous ``cudaMemcpy`` between device pointers."""
    _call("dlrover_rdma_copy", dst, src, nbytes)


def _check_width(width: int) -> None:
    if width % LANE or width <= 0:
        raise ValueError(f"the rdma ring takes a width that is a positive "
                         f"multiple of {LANE}, got {width}")


def _launch(x, out, world, width, gen, ctas, cap, window_bytes,
            timeout_cycles, base=None, self_ptr=None, left=None, right=None,
            rank=0, one_card=False) -> None:
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _call("dlrover_rdma_ring", x.data_ptr(), out.data_ptr(), base,
              self_ptr, left, right, window_bytes, width, cap, rank, world,
              ctas, gen, int(one_card), timeout_cycles, stream)
    launches["rdma_ring"] += 1


def read_errors(device, base: int, window_bytes: int, windows: int,
                timeout_s: float):
    """The error records of ``windows`` windows spaced ``window_bytes``
    apart from ``base``, once the current stream's work so far is done: one
    message per window whose kernel ran out of time."""
    host = (ctypes.c_uint * (4 * windows))()
    with torch.cuda.device(device):
        _call("dlrover_rdma_errors", base, window_bytes, windows, host,
              torch.cuda.current_stream(device).cuda_stream)
    found = []
    for w in range(windows):
        stage, rank, cta, hop = host[4 * w:4 * w + 4]
        if stage:
            found.append(f"rank {rank}, CTA {cta}: {STAGES.get(stage, stage)}"
                         f" at hop {hop} timed out after ~{timeout_s} s")
    return found


# ---------------------------------------------------------------------------
# one rank per card
# ---------------------------------------------------------------------------


def rdma_ring_reduce_scatter(x: torch.Tensor, group, window) -> torch.Tensor:
    """This rank's ``(width,)`` row of ``sum_j x_j`` for ``x`` ``(world,
    width)`` fp32, as one kernel over ``window`` (this group's
    ``PeerWindow``), summed in the ring's hop order: the same bits as the
    ``ring`` tier.  It only launches: ``window.check()`` raises if a peer
    did not keep up within the kernel's time limit."""
    if x.device.type == "cpu":
        return ring.ring_reduce_scatter(x, group, accum="torch")
    world, width = x.shape
    _check_width(width)
    ring._check("x", x, torch.float32, (group.world, width), x.device, 16)
    if window is None:
        raise ValueError("ring_rdma runs over the group's PeerWindow; "
                         "build one with parallel.peer_memory.PeerWindow")
    if window.broken:
        raise RuntimeError(f"the peer window is unusable: {window.broken}")
    if width > window.cap or window.world != world:
        raise ValueError(f"a ({world}, {width}) buffer does not fit the peer "
                         f"window ({window.world} ranks, {window.cap} wide)")
    out = torch.empty(width, dtype=torch.float32, device=x.device)
    _launch(x, out, world, width, window.next_generation(), window.ctas,
            window.cap, window.window_bytes, window.timeout_cycles,
            self_ptr=window.self_ptr, left=window.left_ptr,
            right=window.right_ptr, rank=group.rank)
    return out


# ---------------------------------------------------------------------------
# W ranks on one card
# ---------------------------------------------------------------------------


class OneCardWindows:
    """The windows of ``world`` ranks on one card, in one allocation, for
    rows of up to ``cap`` fp32 elements: what ``rdma_ring_one_card`` runs
    over.  ``generation`` counts the calls made on them; ``check()`` raises
    if one ran out of time, after which they stay unusable; ``close()``
    frees them (also as a context manager)."""

    def __init__(self, device, world: int, cap: int,
                 timeout_s: float = TIMEOUT_S):
        if world < 2:
            raise ValueError(f"the rdma ring needs 2 or more ranks, got "
                             f"{world}")
        device = torch.device(device)
        if device.index is None:
            device = torch.device(device.type, torch.cuda.current_device())
        self.device, self.world, self.cap = device, world, int(cap)
        self.timeout_s = timeout_s
        with torch.cuda.device(device):
            self.ctas, self.timeout_cycles = launch_shape(world, timeout_s)
            self.window_bytes = window_layout(self.ctas, self.cap)["total"]
            self.base = alloc(world * self.window_bytes)
        self.generation = 0
        self.broken = None  # what ran out of time, once check() saw it

    def check(self) -> None:
        """Raise if a call on these windows ran out of time (waits for the
        calls queued so far)."""
        if self.broken is None:
            errors = read_errors(self.device, self.base, self.window_bytes,
                                 self.world, self.timeout_s)
            self.broken = "; ".join(errors) or None
        if self.broken:
            raise RuntimeError(f"rdma ring: {self.broken}")

    def close(self) -> None:
        if self.base is not None:
            with torch.cuda.device(self.device):
                free(self.base)
            self.base = None

    def __enter__(self) -> "OneCardWindows":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def rdma_ring_one_card(xs: torch.Tensor, windows: OneCardWindows
                       ) -> torch.Tensor:
    """``xs`` ``(W, W, width)`` fp32, rank ``r``'s buffer ``xs[r]``, all on
    one card: every rank's row of the sum, ``(W, width)``, through the
    kernel with the W ranks in one cooperative launch over ``windows``.
    It only launches: ``windows.check()`` raises on a timeout.  On a CPU
    tensor, the plain version (``windows`` unused)."""
    if xs.device.type == "cpu":
        return rdma_ring_plain(xs)
    world, _, width = xs.shape
    _check_width(width)
    ring._check("xs", xs, torch.float32, (world, world, width), xs.device,
                16)
    if windows is None:
        raise ValueError("rdma_ring_one_card runs over OneCardWindows")
    if windows.broken:
        raise RuntimeError(f"the windows are unusable: {windows.broken}")
    if (windows.world != world or width > windows.cap
            or windows.device != xs.device):
        raise ValueError(f"a ({world}, {world}, {width}) buffer on "
                         f"{xs.device} does not fit windows of "
                         f"{windows.world} ranks, {windows.cap} wide, on "
                         f"{windows.device}")
    out = torch.empty(world, width, dtype=torch.float32, device=xs.device)
    windows.generation += 1
    _launch(xs, out, world, width, windows.generation, windows.ctas,
            windows.cap, windows.window_bytes, windows.timeout_cycles,
            base=windows.base, one_card=True)
    return out
