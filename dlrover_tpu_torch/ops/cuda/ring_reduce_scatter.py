"""The per-hop kernels of the grad-sync rings and the exact ring itself.

Port of ``dlrover_tpu/ops/pallas/ring_reduce_scatter.py`` but for its
one-kernel RDMA ring (``ops/cuda/rdma_ring.py``): the fused encode
(``fused_quantize``) and the fused decode + accumulate of one
``ring_pallas_q`` hop (``fused_dequant_add``), the plain accumulate of one
``ring_pallas`` hop (``ring_add``), the exact ring (``ring_reduce_scatter``,
the ``ring`` and ``ring_pallas`` tiers) and the transport selection
(``select_transport``, ``resolve_transport``).  The five kernels live in
``dlrover_tpu_torch/csrc/ring_reduce_scatter.cu`` (its header gives the
bound and the design); beside each, this module holds its plain PyTorch
version (``*_plain``), which a wrapper takes only for tensors on the CPU.
On a CUDA tensor a wrapper launches the kernel or raises, and adds one to
``launches[<kernel>]`` per launch.

The numerics are those of the reference as it runs (jit on the CPU, Pallas
in interpret mode), bit for bit: scale = max|x| times the fp32 constant
1/qmax, codes rint(x / safe) clipped, dequant codes * scale, the quantized
accumulate one fused multiply-add (``_fma``) and the exact one an IEEE
add.  The error-feedback residual is taken from this dequant, so the
codecs of ``parallel/collectives.py`` are built on the same functions.
"""

import ctypes
from typing import Tuple

import numpy as np
import torch

from dlrover_tpu_torch.ops.cuda import _build

KERNEL_SOURCE = "ring_reduce_scatter"
#: codec formats the fused kernels implement; blockwise rides the int4
#: kernels for its base codes, its int8 refinement is plain torch
QUANT_RING_FORMATS = ("int8", "int4", "blockwise")
_QMAX = {"int8": 127, "int4": 7}
# the reference's exact-ring tiling rule (a packet of (8, 128) fp32 tiles)
_TPU_TILE_ELEMS = 8 * 128
_PART = 256  # a kernel row is taken in 256-wide parts

# launches per kernel since the last reset_launches()
launches = {"q8_encode": 0, "q4_encode": 0, "q8_accum": 0, "q4_accum": 0,
            "add": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# plain versions (CPU path, the codecs' arithmetic, and the reference the
# kernels are held against)
# ---------------------------------------------------------------------------


def _reciprocal(qmax: int) -> float:
    """fp32 1/qmax: XLA turns ``m / 127.0`` into ``m * (1/127)``."""
    return float(np.float32(1.0) / np.float32(qmax))


def quantize_plain(x: torch.Tensor, qmax: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last axis) symmetric quantization of fp32 ``x``:
    ``(int8 codes in [-qmax, qmax], fp32 scale of shape (..., 1))``.  Zero
    rows get scale 0 and codes 0."""
    scale = x.abs().amax(dim=-1, keepdim=True) * _reciprocal(qmax)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    codes = torch.clamp(torch.round(x / safe), -qmax, qmax)
    return codes.to(torch.int8), scale


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """int4 codes, two per byte: the even element in the low nibble."""
    return (codes[..., 0::2] & 0x0F) | (codes[..., 1::2] << 4)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_nibbles``; arithmetic shifts sign-extend."""
    lo = (packed << 4) >> 4
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-1).reshape(
        packed.shape[:-1] + (2 * packed.shape[-1],))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 ``a * b + c`` rounded once, as a fused multiply-add.

    The product of two fp32 values is exact in fp64.  The fp64 sum is
    rounded to odd (TwoSum gives its error exactly; an inexact sum whose
    last bit is even moves one ulp toward the exact value), and rounding a
    round-to-odd fp64 value to fp32 is the correct rounding of the exact
    value, since fp64 carries more than 24 + 2 bits."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    pv = s - c
    err = (p - pv) + (c - (s - pv))
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, np.inf),
                         torch.full_like(s, -np.inf))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def add_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` in fp32, one rounding per element: the ``_add_kernel``
    function."""
    return a + b


def encode_plain(x: torch.Tensor, fmt: str):
    """``(codes, scales, dequant)`` of ``x`` (rows, block) fp32: the
    ``_q8_encode_kernel`` / ``_q4_encode_kernel`` function."""
    codes, scale = quantize_plain(x, _QMAX[fmt])
    if fmt == "int4":
        codes = pack_nibbles(codes)
        return codes, scale, unpack_nibbles(codes).float() * scale
    return codes, scale, codes.float() * scale


def accum_plain(acc: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                fmt: str) -> torch.Tensor:
    """``acc + dequant(q, s)`` with one rounding per element: the
    ``_q8_accum_kernel`` / ``_q4_accum_kernel`` function."""
    codes = unpack_nibbles(q) if fmt == "int4" else q
    return _fma(codes.float(), s, acc)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_CODEC_SIGNATURE = [_P] * 4 + [ctypes.c_longlong, ctypes.c_int, _P]
# kernel -> (C function, argument types)
_FUNCTIONS = {
    "q8_encode": ("dlrover_rrs_q8_encode", _CODEC_SIGNATURE),
    "q4_encode": ("dlrover_rrs_q4_encode", _CODEC_SIGNATURE),
    "q8_accum": ("dlrover_rrs_q8_accum", _CODEC_SIGNATURE),
    "q4_accum": ("dlrover_rrs_q4_accum", _CODEC_SIGNATURE),
    "add": ("dlrover_rrs_add", [_P] * 3 + [ctypes.c_longlong, _P]),
}

_lib = None  # the loaded library, its functions typed once


def _library():
    global _lib
    if _lib is None:
        lib = _build.load(KERNEL_SOURCE)
        for fn, argtypes in _FUNCTIONS.values():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dtype, shape, device, align: int):
    if t.dtype != dtype:
        raise TypeError(f"ring kernels take {name} as {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {device}")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def _launch(kernel: str, device: torch.device, *args) -> None:
    """Launch on ``device`` (the inputs' card) and its current stream."""
    fn = getattr(_library(), _FUNCTIONS[kernel][0])
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
    launches[kernel] += 1


def pallas_q_supported(block: int, qformat) -> bool:
    """``ring_pallas_q`` precondition: a format the fused kernels implement
    and a block of whole 256-wide parts (int4 packing halves it to 128)."""
    return qformat in QUANT_RING_FORMATS and block % _PART == 0


def fused_quantize(x: torch.Tensor, fmt: str):
    """Encode ``x`` of shape ``(world, nblk, block)`` fp32 in one pass:
    per-block scales, nearest-rounded codes and the dequantized view the
    caller turns into the error-feedback residual.  ``fmt``: ``int8`` or
    ``int4`` (packed nibbles).  Returns ``(codes, scales, dequant)`` of
    shapes ``(world, nblk, block or block/2)``, ``(world, nblk, 1)`` and
    ``(world, nblk, block)``."""
    if fmt not in _QMAX:
        raise ValueError(f"no fused encode kernel for format {fmt!r}")
    world, nblk, block = x.shape
    rows = world * nblk
    qcols = block if fmt == "int8" else block // 2
    if x.device.type == "cpu":
        q, s, d = encode_plain(x.reshape(rows, block), fmt)
    else:
        if block % _PART or rows == 0:
            raise ValueError(f"fused encode takes a block of whole "
                             f"{_PART}-wide parts and rows > 0, got "
                             f"({rows}, {block})")
        _check("x", x, torch.float32, (world, nblk, block), x.device, 16)
        q = torch.empty(rows, qcols, dtype=torch.int8, device=x.device)
        s = torch.empty(rows, 1, dtype=torch.float32, device=x.device)
        d = torch.empty(rows, block, dtype=torch.float32, device=x.device)
        kernel = "q8_encode" if fmt == "int8" else "q4_encode"
        _launch(kernel, x.device, x.data_ptr(), q.data_ptr(), s.data_ptr(),
                d.data_ptr(), rows, block)
    return (q.reshape(world, nblk, qcols), s.reshape(world, nblk, 1),
            d.reshape(world, nblk, block))


def fused_dequant_add(acc: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                      fmt: str, out: torch.Tensor = None) -> torch.Tensor:
    """One ring hop's decode + accumulate: ``acc + dequant(q, s)`` for one
    arriving chunk, ``acc`` ``(nblk, block)`` fp32, ``q`` ``(nblk, block
    or block/2)`` int8, ``s`` ``(nblk, 1)`` fp32.  ``out`` (on the card it
    may be ``acc`` itself) receives the result; by default a new tensor."""
    if fmt not in _QMAX:
        raise ValueError(f"no fused accumulate kernel for format {fmt!r}")
    if acc.device.type == "cpu":
        result = accum_plain(acc, q, s, fmt)
        if out is None:
            return result
        return out.copy_(result)
    nblk, block = acc.shape
    if block % _PART or nblk == 0:
        raise ValueError(f"fused accumulate takes a block of whole {_PART}-"
                         f"wide parts and nblk > 0, got ({nblk}, {block})")
    qcols = block if fmt == "int8" else block // 2
    _check("acc", acc, torch.float32, (nblk, block), acc.device, 16)
    _check("q", q, torch.int8, (nblk, qcols), acc.device, 8)
    _check("s", s, torch.float32, (nblk, 1), acc.device, 4)
    if out is None:
        out = torch.empty_like(acc)
    _check("out", out, torch.float32, (nblk, block), acc.device, 16)
    kernel = "q8_accum" if fmt == "int8" else "q4_accum"
    _launch(kernel, acc.device, acc.data_ptr(), q.data_ptr(), s.data_ptr(),
            out.data_ptr(), nblk, block)
    return out


def ring_add(a: torch.Tensor, b: torch.Tensor,
             out: torch.Tensor = None) -> torch.Tensor:
    """One exact ring hop's accumulate, ``a + b`` on fp32 vectors of any
    length.  ``out`` (it may be ``a`` itself, for an in-place hop) receives
    the result; by default a new tensor.  The kernel takes contiguous,
    16-byte aligned fp32 vectors."""
    if a.device.type == "cpu":
        result = add_plain(a, b)
        if out is None:
            return result
        return out.copy_(result)
    n = a.numel()
    if a.dim() != 1 or n == 0:
        raise ValueError(f"ring_add takes non-empty vectors, got shape "
                         f"{tuple(a.shape)}")
    _check("a", a, torch.float32, (n,), a.device, 16)
    _check("b", b, torch.float32, (n,), a.device, 16)
    if out is None:
        out = torch.empty_like(a)
    _check("out", out, torch.float32, (n,), a.device, 16)
    _launch("add", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), n)
    return out


def ring_reduce_scatter(x: torch.Tensor, group, accum: str = "torch"
                        ) -> torch.Tensor:
    """Reduce-scatter ``x`` of shape ``(world, width)`` over the ranks of
    ``group`` (a ``process_group.DpGroup``) with an explicit ring of
    ``world - 1`` right-hops: rank ``r`` returns ``sum_j x_j[r]``, shape
    ``(width,)``, summed in the reference's hop order, so the ``ring`` and
    ``ring_pallas`` tiers give the reference's bits.

    The packet created on rank ``s`` carries the chunk destined for rank
    ``(s - 1) % world``; every hop sends it to the right neighbour and adds
    the local row of the packet's destination.  ``accum="kernel"`` (the
    ``ring_pallas`` tier) adds in place through :func:`ring_add`,
    ``accum="torch"`` (``ring``) with a plain add; both round once per
    element.  Which tier a bucket takes is ``select_transport``'s to
    decide."""
    world = group.world
    if world <= 1:
        return x.reshape(-1)
    use_kernel = accum == "kernel"
    me = group.rank
    p = x[(me - 1) % world]
    for t in range(world - 1):
        # shift(d=-1) sends to rank + 1 and receives from rank - 1: the
        # ppermute perm [(i, (i + 1) % world)]
        p = group.shift({"p": p}, -1)["p"]
        row = x[(me - t - 2) % world]
        p = ring_add(p, row, out=p) if use_kernel else p + row
    return p


# ---------------------------------------------------------------------------
# transport selection
# ---------------------------------------------------------------------------


def pallas_accum_supported(width: int) -> bool:
    """The reference's ``ring_pallas`` tiling rule, kept so that a policy
    resolves to the same tier in both packages."""
    return width % _TPU_TILE_ELEMS == 0


def rdma_available(world: int) -> bool:
    """The one-kernel ring needs peer memory between the ranks' cards: at
    least two CUDA devices, ``world`` dp ranks one per card (the port
    places rank ``r`` on card ``r`` when the cards suffice) and peer access
    between neighbouring cards.  The reference asks for a TPU instead.
    Ranks that share a card never qualify: their processes time-slice the
    card, and a kernel that waits on another process's kernel may stall
    for whole time slices."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world < 2 or count < max(2, world):
        return False
    return all(torch.cuda.can_device_access_peer(r, (r + 1) % world)
               and torch.cuda.can_device_access_peer((r + 1) % world, r)
               for r in range(world))


def select_transport(transport: str, quantized: bool, world: int,
                     width: int, rdma_enabled: bool,
                     multi_axis: bool = False, qformat=None,
                     rounding: str = "nearest",
                     block_size: int = 256) -> str:
    """What a policy's transport request resolves to, with the reference's
    fallback chain: one of ``all_to_all`` (the codec exchange, the
    quantized default), ``ring_pallas_q`` (the fused-quantization ring),
    ``psum_scatter`` (the stock reduce-scatter), ``ring``, ``ring_pallas``
    and ``ring_rdma``.  ``multi_axis``: the collective spans several mesh
    axes, which the rings cannot address."""
    if quantized:
        if (
            transport == "ring_pallas_q"
            and world > 1
            and not multi_axis
            and rounding == "nearest"
            and pallas_q_supported(block_size, qformat)
        ):
            return "ring_pallas_q"
        return "all_to_all"
    if world <= 1 or transport in ("auto", "all_to_all") or multi_axis:
        return "psum_scatter"
    if transport == "ring":
        return "ring"
    if transport in ("ring_pallas", "ring_pallas_q"):
        # an exact bucket has no codec to fuse: the plain accumulate ring
        # is ring_pallas_q's exact twin
        return "ring_pallas" if pallas_accum_supported(width) else "ring"
    if transport == "ring_rdma":
        if rdma_enabled and rdma_available(world) and width % 128 == 0:
            return "ring_rdma"
        return "ring_pallas" if pallas_accum_supported(width) else "ring"
    return "psum_scatter"


def resolve_transport(policy, world: int, width: int, axis="dp",
                      rdma_enabled=None, request=None) -> str:
    """THE transport resolution for a policy and a sync axis: ``request``
    overrides the policy's transport field, and the fallback chain still
    applies.  ``axis`` is one axis name, or a tuple for a multi-axis
    collective."""
    if rdma_enabled is None:
        from dlrover_tpu_torch.common import envs

        rdma_enabled = envs.get_bool("DLROVER_TPU_GRAD_RING_RDMA")
    return select_transport(
        request if request is not None else policy.transport,
        policy.quantized, world, width, bool(rdma_enabled),
        multi_axis=not isinstance(axis, str),
        qformat=policy.qformat, rounding=policy.rounding,
        block_size=policy.block_size,
    )
