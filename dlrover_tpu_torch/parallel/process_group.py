"""The data-parallel axis: a ``torch.distributed`` group and its primitives.

The port's counterpart of the ``dp`` mesh axis of the JAX package.  Each
rank is one process; ``DpGroup`` holds its rank, world, backend and
device, and the few collectives the grad sync needs: ``all_reduce``, ``reduce_scatter``,
``all_gather``, ``all_to_all`` and ``shift`` (the ``lax.ppermute`` of the
quantized ring).

On an NCCL group the primitives pass device tensors.  On a gloo group,
whose support for CUDA tensors is partial, a CUDA tensor goes to host
memory before the collective and back after it: the choice follows the
group's backend and is made up front, never after a failure.  CPU tensors
need no staging.

``spawn`` starts one process per rank (start method ``spawn``: CUDA cannot
fork) over a ``FileStore``, runs a function of the port in each, and
returns what each returned.  Ranks of an NCCL group need a card each; ranks
of a gloo group on the card share the cards round-robin.  As every entry
point of the port, the ranks compute on the card unless the caller asks for
the CPU (``device="cpu"``), and raise without one.
"""

import datetime
import multiprocessing
import os
import queue as queue_lib
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Sequence

import torch
import torch.distributed as dist

from dlrover_tpu_torch.device import DeviceLike, resolve_device

# torch 2.13 renames the tensor forms of these collectives (same signature)
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)
_all_gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)


class DpGroup:
    """One rank's view of the data-parallel group."""

    def __init__(self, device: DeviceLike = None):
        """The default (world) group of ``torch.distributed``; ``device``
        is where this rank computes: the card unless the caller asks for
        the CPU."""
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.backend = str(dist.get_backend())
        self.device = resolve_device(device)
        # gloo exchanges host memory: CUDA tensors are staged through it
        self.host_staged = self.backend == "gloo"

    def _send(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        return t.cpu() if self.host_staged and t.is_cuda else t

    def _empty(self, shape, like: torch.Tensor) -> torch.Tensor:
        device = "cpu" if self.host_staged else like.device
        return torch.empty(shape, dtype=like.dtype, device=device)

    @staticmethod
    def _back(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return t.to(like.device)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks; returns a new tensor."""
        buf = self._send(t)
        if buf is t:
            buf = t.clone()
        dist.all_reduce(buf)
        return self._back(buf, t)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` of leading size ``world * k``: this rank's ``k`` rows of
        the sum over the ranks."""
        if t.shape[0] % self.world:
            raise ValueError(f"leading size {t.shape[0]} is not a multiple "
                             f"of the world {self.world}")
        buf = self._send(t)
        out = self._empty((t.shape[0] // self.world,) + tuple(t.shape[1:]), t)
        _reduce_scatter(out, buf)
        return self._back(out, t)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t``, stacked: ``(world, *t.shape)``."""
        buf = self._send(t).reshape(-1)
        out = self._empty((self.world * buf.numel(),), t)
        _all_gather(out, buf)
        return self._back(out.view((self.world,) + tuple(t.shape)), t)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` of leading size ``world * k``: rows ``[r*k, (r+1)*k)`` go
        to rank ``r``; returns the ``world * k`` rows received, by source
        rank (``lax.all_to_all`` tiled over axis 0)."""
        if t.shape[0] % self.world:
            raise ValueError(f"leading size {t.shape[0]} is not a multiple "
                             f"of the world {self.world}")
        buf = self._send(t)
        out = self._empty(tuple(t.shape), t)
        dist.all_to_all_single(out, buf)
        return self._back(out, t)

    def shift(self, tensors: Dict[str, torch.Tensor],
              d: int) -> Dict[str, torch.Tensor]:
        """Rank ``i`` sends each tensor to rank ``(i - d) mod world`` and
        receives its counterpart from rank ``(i + d) mod world``: the
        ``lax.ppermute`` with ``perm = [(i, (i - d) % world)]``."""
        dst = (self.rank - d) % self.world
        src = (self.rank + d) % self.world
        if dst == self.rank:
            return {k: v.clone() for k, v in tensors.items()}
        ops, received = [], {}
        for tag, (name, t) in enumerate(tensors.items()):
            buf = self._send(t)
            out = self._empty(tuple(t.shape), t)
            received[name] = (out, t)
            ops.append(dist.P2POp(dist.isend, buf, dst, tag=tag))
            ops.append(dist.P2POp(dist.irecv, out, src, tag=tag))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return {k: self._back(out, t) for k, (out, t) in received.items()}


# ---------------------------------------------------------------------------
# one process per rank
# ---------------------------------------------------------------------------


def rank_device(backend: str, device: str, rank: int) -> torch.device:
    """Where rank ``rank`` computes: the CPU, or for ``device="cuda"`` card
    ``rank`` (NCCL) or card ``rank mod count`` (gloo, which may share)."""
    if device == "cpu":
        return torch.device("cpu")
    count = torch.cuda.device_count()
    return torch.device("cuda", rank if backend == "nccl" else rank % count)


def check_placement(backend: str, device: str, world: int) -> None:
    """Raise for a placement the backend cannot run."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be gloo or nccl, got {backend!r}")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be cpu or cuda, got {device!r}")
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("an NCCL group exchanges CUDA tensors: pass "
                             "device='cuda'")
        count = torch.cuda.device_count()
        if world > count:
            raise ValueError(
                f"NCCL refuses two ranks on one device: {world} ranks need "
                f"{world} CUDA devices, found {count}; use backend='gloo' "
                "(host-staged) to share a card")
    elif device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the CPU explicitly")


def _rank_main(fn, rank: int, world: int, backend: str, device: str,
               store_path: str, timeout_s: float, args: Sequence[Any],
               results) -> None:
    torch.set_num_threads(1)
    try:
        dev = rank_device(backend, device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            value = fn(DpGroup(dev), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except BaseException:  # reported to the parent, then re-raised
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, world: int, args: Sequence[Any] = (),
          backend: str = "gloo", device: str = "cuda",
          timeout_s: float = 120.0) -> List[Any]:
    """Run ``fn(group, *args)`` in ``world`` new processes, one per rank,
    and return their results by rank, each rank on the card (``device=
    "cuda"``, the default) or on the CPU (``device="cpu"``).  ``fn`` must
    be importable by its module path, and its arguments and result
    picklable.  Raises with the first failing rank's traceback, and kills
    every rank and raises ``TimeoutError`` if they have not all finished
    within ``timeout_s``."""
    check_placement(backend, device, world)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory(prefix="dp_store_") as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [
            ctx.Process(target=_rank_main, daemon=True, args=(
                fn, rank, world, backend, device, store_path, timeout_s,
                tuple(args), results))
            for rank in range(world)
        ]
        for p in procs:
            p.start()
        got: Dict[int, Any] = {}
        try:
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world)) - set(got))} did "
                        f"not finish within {timeout_s:.0f} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue_lib.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode is not None]
                    if dead:
                        # a rank that died without reporting (killed, or
                        # crashed in native code); give its report a moment
                        time.sleep(1.0)
                        if results.empty():
                            raise RuntimeError(
                                f"rank {dead[0]} exited with code "
                                f"{procs[dead[0]].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                got[rank] = value
        finally:
            for p in procs:
                p.join(timeout=max(0.0, min(10.0,
                                            deadline - time.monotonic())))
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10.0)
            results.close()
    return [got[r] for r in range(world)]
