"""The peer window of a dp group: device memory the neighbours write into.

The port's counterpart of what the TPU runtime hands the reference's
one-kernel ring (``_rdma_ring_kernel``): remote refs into the neighbours'
scratch, the barrier semaphore of ``collective_id=13``, and the DMA and
regular semaphores.  Each rank allocates one window with ``cudaMalloc``
(its flag words and a ring of chunk-sized receive slots per CTA: its size
depends on the card and the world, not on the buckets; layout in
``csrc/rdma_ring.cu``), the ranks exchange ``cudaIpcGetMemHandle`` bytes
with ``group.all_gather``, and each opens its left and right neighbours'
windows.  The window is a ``rdma_ring.RingCounters``: it keeps the
generation and the packet count that every call of the kernel counts its
flags against, so that no flag is ever reset.

Building and closing a window are collective: every rank of the group
calls them.  The ring kernel itself (``ops/cuda/rdma_ring.py``) runs only
with one rank per card; on a card that several rank processes share, the
window can be built and written with copies, as ``chip_smoke.py`` checks,
but the kernel would spin on peers that the card time-slices away.
"""

import torch

from dlrover_tpu_torch.ops.cuda import rdma_ring


class PeerWindow(rdma_ring.RingCounters):
    """This rank's window and its neighbours' over ``group`` (a
    ``process_group.DpGroup`` on CUDA devices), for buckets of any width.
    A wait of the ring kernel on a neighbour gives up after
    ``rdma_ring.TIMEOUT_S``; ``check()`` then raises, and the window stays
    unusable (``rdma_ring``'s docstring)."""

    def __init__(self, group):
        if group.device.type != "cuda":
            raise ValueError("a peer window lives in device memory: the group "
                             f"computes on {group.device}")
        if group.world < 2:
            raise ValueError("a peer window needs 2 or more ranks")
        self.device = group.device
        self.rank = group.rank
        self._group = group
        with torch.cuda.device(self.device):
            ctas, self.timeout_cycles = rdma_ring.launch_shape(
                group.world, 1, rdma_ring.TIMEOUT_S)
            super().__init__(group.world, ctas)
            layout = rdma_ring.window_layout(ctas, self.slots)
            self.window_bytes = layout["total"]
            self._slots_off = layout["slots_off"]
            # every CTA's ring of slots, one after another
            self.slot_elems = (self.window_bytes - self._slots_off) // 4
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
        self.broken = None  # what ran out of time, once check() saw it

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

    def write_right_slots(self, row: torch.Tensor) -> None:
        """Copy ``row`` (fp32 on this rank's card, up to ``slot_elems``)
        into the right neighbour's slots, from the first, through the
        opened handle."""
        if row.dtype != torch.float32 or row.numel() > self.slot_elems:
            raise ValueError(f"the slots take up to {self.slot_elems} fp32 "
                             "elements")
        row = row.contiguous()
        torch.cuda.synchronize(self.device)
        with torch.cuda.device(self.device):
            rdma_ring.copy(self.right_ptr + self._slots_off, row.data_ptr(),
                           4 * row.numel())

    def read_slots(self, n: int) -> torch.Tensor:
        """The first ``n`` elements of this rank's slots."""
        out = torch.empty(n, dtype=torch.float32, device=self.device)
        torch.cuda.synchronize(self.device)
        with torch.cuda.device(self.device):
            rdma_ring.copy(out.data_ptr(), self.self_ptr + self._slots_off,
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
