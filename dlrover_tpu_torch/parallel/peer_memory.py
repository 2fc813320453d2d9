"""The peer window of a dp group: device memory the neighbours write into.

The port's counterpart of what the TPU runtime hands the reference's
one-kernel ring (``_rdma_ring_kernel``): remote refs into the neighbours'
scratch, the barrier semaphore of ``collective_id=13``, and the DMA and
regular semaphores.  Each rank allocates one window with ``cudaMalloc``
(its flag words and 2 receive slots of ``cap`` fp32 elements; layout in
``csrc/rdma_ring.cu``), the ranks exchange ``cudaIpcGetMemHandle`` bytes
with ``group.all_gather``, and each opens its left and right neighbours'
windows.  The window keeps the generation that every call of the kernel
counts its flags against, so that no flag is ever reset.

Building and closing a window are collective: every rank of the group
calls them.  The ring kernel itself (``ops/cuda/rdma_ring.py``) runs only
with one rank per card; on a card that several rank processes share, the
window can be built and written with copies, as ``chip_smoke.py`` checks,
but the kernel would spin on peers that the card time-slices away.
"""

import torch

from dlrover_tpu_torch.ops.cuda import rdma_ring


class PeerWindow:
    """This rank's window and its neighbours' over ``group`` (a
    ``process_group.DpGroup`` on CUDA devices), for buckets of up to
    ``cap`` fp32 elements per row.  A wait of the ring kernel on a
    neighbour gives up after ``rdma_ring.TIMEOUT_S``; ``check()`` then
    raises, and the window stays unusable (``rdma_ring``'s docstring)."""

    def __init__(self, group, cap: int):
        if group.device.type != "cuda":
            raise ValueError("a peer window lives in device memory: the group "
                             f"computes on {group.device}")
        if group.world < 2:
            raise ValueError("a peer window needs 2 or more ranks")
        self.device = group.device
        self.rank, self.world, self.cap = group.rank, group.world, int(cap)
        self._group = group
        with torch.cuda.device(self.device):
            self.ctas, self.timeout_cycles = rdma_ring.launch_shape(
                1, rdma_ring.TIMEOUT_S)
            layout = rdma_ring.window_layout(self.ctas, self.cap)
            self.window_bytes = layout["total"]
            self._slots_off = layout["slots_off"]
            self._slot_bytes = 4 * layout["slot_elems"]
            self.self_ptr = rdma_ring.alloc(self.window_bytes)
            handle = rdma_ring.ipc_handle(self.self_ptr)
        mine = torch.tensor(list(handle) + list(self.ctas.to_bytes(4, "little")),
                            dtype=torch.uint8, device=self.device)
        every = group.all_gather(mine).cpu()
        if not (every[:, -4:] == every[0, -4:]).all():
            self._free()
            raise RuntimeError("the ranks chose different CTA counts: the "
                               "ring needs the same card model on every rank")
        self.left_rank = (self.rank - 1) % self.world
        self.right_rank = (self.rank + 1) % self.world
        self._opened = {}
        with torch.cuda.device(self.device):
            for peer in {self.left_rank, self.right_rank}:
                self._opened[peer] = rdma_ring.ipc_open(
                    bytes(every[peer, :len(handle)].tolist()))
        self.left_ptr = self._opened[self.left_rank]
        self.right_ptr = self._opened[self.right_rank]
        self.generation = 0
        self.broken = None  # what ran out of time, once check() saw it

    def next_generation(self) -> int:
        self.generation += 1
        return self.generation

    def check(self) -> None:
        """Raise if a ring call on this window ran out of time.  It waits
        for the calls queued so far on the current stream: the trainer
        calls it once per step, after the grad sync."""
        if self.broken is None:
            errors = rdma_ring.read_errors(self.device, self.self_ptr,
                                           self.window_bytes, 1,
                                           rdma_ring.TIMEOUT_S)
            self.broken = errors[0] if errors else None
        if self.broken:
            raise RuntimeError(f"rdma ring: {self.broken}")

    def slot_ptr(self, window: int, slot: int) -> int:
        """Device address of receive slot ``slot`` (0 or 1) in ``window``:
        ``self.self_ptr``, ``self.left_ptr`` or ``self.right_ptr``."""
        return window + self._slots_off + slot * self._slot_bytes

    def write_right_slot(self, row: torch.Tensor, slot: int) -> None:
        """Copy ``row`` (fp32 on this rank's card) into the right
        neighbour's slot ``slot`` through the opened handle."""
        if row.dtype != torch.float32 or row.numel() > self.cap:
            raise ValueError("the slot takes up to cap fp32 elements")
        row = row.contiguous()
        torch.cuda.synchronize(self.device)
        with torch.cuda.device(self.device):
            rdma_ring.copy(self.slot_ptr(self.right_ptr, slot),
                           row.data_ptr(), 4 * row.numel())

    def read_slot(self, slot: int, n: int) -> torch.Tensor:
        """The first ``n`` elements of this rank's slot ``slot``."""
        out = torch.empty(n, dtype=torch.float32, device=self.device)
        torch.cuda.synchronize(self.device)
        with torch.cuda.device(self.device):
            rdma_ring.copy(out.data_ptr(), self.slot_ptr(self.self_ptr, slot),
                           4 * n)
        return out

    def _free(self) -> None:
        with torch.cuda.device(self.device):
            rdma_ring.free(self.self_ptr)
        self.self_ptr = None

    def close(self) -> None:
        """Unmap the neighbours' windows, wait until every rank has, then
        free this rank's (collective)."""
        if self.self_ptr is None:
            return
        torch.cuda.synchronize(self.device)
        with torch.cuda.device(self.device):
            for ptr in self._opened.values():
                rdma_ring.ipc_close(ptr)
        self._opened = {}
        self.left_ptr = self.right_ptr = None
        self._group.all_reduce(torch.zeros(1, device=self.device))
        self._free()
