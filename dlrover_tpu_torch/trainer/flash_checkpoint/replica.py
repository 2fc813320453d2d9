"""Replicas of each process's shm snapshot on a peer: a lost host's
snapshot comes back from memory, not from storage.

Port of ``dlrover_tpu/trainer/flash_checkpoint/replica.py``.  The processes
of the ``torch.distributed`` world form a ring in rank order.  ``backup``
hands every process's committed segment to the next process, which keeps
it in a segment of its own (``<shm>`` + ``BACKUP_SHM_SUFFIX``);
``restore_from_peers`` rotates the backups back by one, so a replacement
whose segment is gone gets it from its successor's memory.

The reference rotates ``uint8`` rows with ``ppermute`` over a one-axis
mesh of one device per process.  Here each rotation round is one
``DpGroup.shift`` over the world: a host ``uint8`` tensor under gloo, a
chunk buffer on the card under NCCL.  ``DpGroup.shift(t, d)`` sends to
rank ``i - d``, so the reference's shift ``+1`` (my row to rank ``i + 1``)
is ``d = -1`` here.

Both calls are collectives of the training group, and every process makes
the same number of them whatever its payload: one ``all_gather`` of
``[payload bytes, chunk bytes]`` (int64), then ``ceil(max / chunk)``
rounds at the smallest chunk any process asked for
(``DLROVER_TPU_REPLICA_CHUNK_BYTES``), so a knob set differently on one
host changes the speed, never the count of collectives.  A segment read
while a writer moved its seqlock generation contributes nothing (the
collective still runs).
"""

import math
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.multi_process import SharedMemoryBuffer
from dlrover_tpu_torch.device import DeviceLike, resolve_device
from dlrover_tpu_torch.trainer.flash_checkpoint import snapshot

BACKUP_SHM_SUFFIX = "_backup"

_EMPTY = torch.empty(0, dtype=torch.uint8)


def _segment_bytes(shm: SharedMemoryBuffer) -> torch.Tensor:
    """A host copy of the whole attached segment."""
    out = torch.empty(shm.size, dtype=torch.uint8)
    if shm.size:
        out.copy_(snapshot._shm_bytes(shm.buf, 0, shm.size))
    return out


def _store(name: str, payload: torch.Tensor,
           shm: Optional[SharedMemoryBuffer] = None) -> SharedMemoryBuffer:
    """Write ``payload`` at the start of segment ``name`` (made, or made
    larger, as needed); returns the segment, attached."""
    shm = shm or SharedMemoryBuffer(name)
    shm.init(payload.numel())
    snapshot._copy_into(shm.buf, 0, payload)
    return shm


class CkptReplicaManager:
    """Backup and restore of this process's snapshot over the replica
    ring of the world."""

    # the bound of the transient exchange buffers, NOT of the payload: a
    # larger state takes more rounds
    DEFAULT_CHUNK_BYTES = 64 << 20

    def __init__(self, shm_name: str, process_id: int, num_processes: int,
                 chunk_bytes: int = 0, device: DeviceLike = None):
        """``device``: where the engine's state lives; an NCCL world moves
        the chunks through a buffer on it."""
        self._shm_name = shm_name
        self._process_id = int(process_id)
        self._num_processes = int(num_processes)
        self._device = resolve_device(device)
        self._backup_shm = SharedMemoryBuffer(shm_name + BACKUP_SHM_SUFFIX)
        configured = chunk_bytes or envs.get_int(
            "DLROVER_TPU_REPLICA_CHUNK_BYTES")
        if configured <= 0:
            logger.warning("invalid replica chunk size %s; using default",
                           configured)
            configured = self.DEFAULT_CHUNK_BYTES
        self._chunk_bytes = configured
        self._group = None
        #: the last exchange: ``seconds`` (the collectives), ``sent`` and
        #: ``received`` payload bytes, ``rounds`` and the agreed ``chunk``
        self.last_exchange: Dict[str, float] = {}

    @property
    def enabled(self) -> bool:
        return self._num_processes > 1

    def _dp(self):
        from dlrover_tpu_torch.parallel.process_group import DpGroup

        if self._group is None:
            if not (dist.is_available() and dist.is_initialized()):
                raise RuntimeError(
                    "the replica exchange runs over a torch.distributed "
                    "world; none is initialised")
            self._group = DpGroup(self._device)
        return self._group

    def _wire(self) -> torch.device:
        """Where a round's chunk travels: the card under NCCL, host
        memory under gloo."""
        group = self._dp()
        return group.device if group.backend == "nccl" else torch.device(
            "cpu")

    # -- collective size agreement ----------------------------------------

    def _allgather_sizes(self, nbytes: int) -> torch.Tensor:
        """Every process's ``[payload bytes, chunk bytes]``: the receiver
        learns its sender's length exactly, and the chunk is agreed as the
        minimum over the processes."""
        mine = torch.tensor([nbytes, self._chunk_bytes], dtype=torch.int64,
                            device=self._wire())
        return self._dp().all_gather(mine).cpu()

    def _exchange(self, payload: torch.Tensor, shift: int) -> torch.Tensor:
        """Rotate every process's payload ``shift`` places along the ring
        (``+1``: mine to the next process) in chunks; returns what this
        process received from ``(rank - shift) mod n``."""
        t0 = time.perf_counter()
        gathered = self._allgather_sizes(payload.numel())
        sizes = gathered[:, 0]
        n = self._num_processes
        expected = int(sizes[(self._process_id - shift) % n])
        max_size = int(sizes.max())
        self.last_exchange = {"seconds": 0.0, "sent": payload.numel(),
                              "received": 0, "rounds": 0, "chunk": 0}
        if max_size <= 0:
            self.last_exchange["seconds"] = time.perf_counter() - t0
            return _EMPTY
        chunk = min(int(gathered[:, 1].min()), max_size)
        rounds = math.ceil(max_size / chunk)
        wire = self._wire()
        group = self._dp()
        row = torch.zeros(chunk, dtype=torch.uint8, device=wire)
        out = torch.empty(expected, dtype=torch.uint8)
        for i in range(rounds):
            piece = payload[i * chunk:(i + 1) * chunk]
            row[:piece.numel()].copy_(piece)
            # DpGroup.shift sends to rank i - d: d = -shift
            got = group.shift({"row": row}, -shift)["row"]
            need = min(chunk, expected - i * chunk)
            if need > 0:
                out[i * chunk:i * chunk + need].copy_(got[:need])
        self.last_exchange.update(seconds=time.perf_counter() - t0,
                                  received=expected, rounds=rounds,
                                  chunk=chunk)
        return out

    # -- backup ------------------------------------------------------------

    def backup(self) -> bool:
        """COLLECTIVE: every process sends its committed snapshot to the
        next process of the ring and keeps the previous process's in its
        backup segment.  Call after each memory save on every process."""
        if not self.enabled:
            return False
        shm = SharedMemoryBuffer(self._shm_name)
        payload = _EMPTY
        if shm.attach():
            # seqlock read: the generation even before the copy and the
            # same after it, or the peer would keep a part-old, part-new
            # segment as a good replica
            gen0 = snapshot.read_generation(shm)
            if snapshot.is_torn(shm):
                logger.warning("replica backup: local snapshot is torn "
                               "(dirty generation); contributing an empty "
                               "payload")
            else:
                payload = _segment_bytes(shm)
                if snapshot.read_generation(shm) != gen0:
                    logger.warning("replica backup: snapshot generation "
                                   "moved during the copy; contributing an "
                                   "empty payload")
                    payload = _EMPTY
            shm.close()
        peer_bytes = self._exchange(payload, shift=1)
        if peer_bytes.numel():
            _store(self._backup_shm.name, peer_bytes, self._backup_shm)
            logger.info("stored %.1f MB backup replica for process %d",
                        peer_bytes.numel() / 1e6,
                        (self._process_id - 1) % self._num_processes)
        return True

    # -- restore -----------------------------------------------------------

    def restore_from_peers(self) -> bool:
        """COLLECTIVE: every process contributes the backup it holds;
        rotating back by one returns each process its own snapshot, so a
        replacement (an empty segment) recovers from its successor's
        memory.  Returns True when this process's segment was written."""
        if not self.enabled:
            return False
        backup_payload = _EMPTY
        if self._backup_shm.attach():
            backup_payload = _segment_bytes(self._backup_shm)
            self._backup_shm.close()
        mine = self._exchange(backup_payload, shift=-1)
        if not mine.numel():
            return False
        _store(self._shm_name, mine).close()
        logger.info("recovered %.1f MB snapshot from peer replica",
                    mine.numel() / 1e6)
        return True

    def close(self) -> None:
        self._backup_shm.close()

    def unlink_backup(self) -> None:
        """Drop this process's backup segment."""
        if self._backup_shm.attach():
            self._backup_shm.unlink()
