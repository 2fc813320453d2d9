"""User-facing Flash Checkpoint API.

Port of ``dlrover_tpu/trainer/flash_checkpoint/checkpointer.py``.  Typical
loop::

    trainer = Trainer(model, optimizer, grads_dtype=torch.bfloat16)
    state = trainer.create_state()
    ckpt = Checkpointer("/mnt/ckpt")
    for step in range(...):
        state, _ = trainer.train_step(state, batch)
        if step % 10 == 0:
            ckpt.save_checkpoint(step, state, trainer=trainer)  # enqueue only
        if step % 500 == 0:
            ckpt.save_checkpoint(step, state, StorageType.DISK,
                                 trainer=trainer)

    # restart: a fresh state on the card is the target, filled in place
    state, step = ckpt.load_checkpoint(trainer.create_state(),
                                       trainer=trainer)

The reference's ``load_checkpoint(abstract_state, shardings)`` becomes
``load_checkpoint(target, trainer)``: the port restores into a state that
already lives on its device rather than allocating a second one, and the
``trainer`` that made the state says where its local tensors sit in the
global leaves (``Trainer.state_layout``), as a JAX array's sharding does.
On a mesh or a dp group every rank calls both, with its own state and its
trainer (a state no trainer made passes its ``layout``: ``{}`` when every
leaf is whole on every rank); a world refuses a call with neither.  A
trainer's restore across a change of the dp degree is
``Trainer.load_state``.

With ``DLROVER_TPU_DIST_PERSIST=1`` a storage save takes the distributed
persist (``distributed.py``): each shard is written once, by its owner,
which every rank derives from every rank's layout (the trainer's
``state_layout(state, rank=r)``, computed once for each trainer and state
structure), and the step is committed in two phases; a restore from
storage reads a sealed commit first.  A state no trainer made that is
split over the ranks takes the legacy persist there, with a warning.

``replica=True`` keeps each rank's snapshot on the next rank as well, and
``DLROVER_TPU_PEER_RESTORE=1`` lets a replaced rank refill its snapshot
from its peers' memory (``engine.py``, ``replica.py``,
``peer_restore.py``); the peer restore names the replica group from the
same every-rank layouts.
"""

from typing import Any, Dict, Optional, Tuple

from dlrover_tpu_torch.device import DeviceLike
from dlrover_tpu_torch.trainer.flash_checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.trainer.flash_checkpoint.snapshot import (
    Layout,
    structure,
)


def _layout(state: Any, trainer, layout: Optional[Layout]):
    if trainer is None:
        return layout
    if layout is not None:
        raise ValueError("pass a trainer or a layout, not both")
    return trainer.state_layout(state)


class StorageType:
    MEMORY = 0
    DISK = 1


class Checkpointer:
    def __init__(
        self,
        checkpoint_dir: str,
        process_id: Optional[int] = None,
        num_processes: Optional[int] = None,
        scope: str = "",
        replica: bool = False,
        async_snapshot: bool = True,
        device: DeviceLike = None,
    ):
        """``async_snapshot`` (default) blocks the training loop only for
        the enqueue of a device-to-device copy of the state; device->host
        staging runs behind training (engine module docstring).  It costs
        one extra copy of the state in device memory, kept for the next
        save.  Pass ``False`` when the device has no room for it.

        ``device``: where the states to save and restore live; the card
        by default (raises without one), ``"cpu"`` to run on the CPU.
        ``replica=True`` backs each rank's snapshot up on the next rank of
        the world after every memory save (a no-op in one process); the
        saves are then synchronous."""
        self._engine = CheckpointEngine(
            checkpoint_dir,
            process_id=process_id,
            num_processes=num_processes,
            scope=scope,
            replica=replica,
            device=device,
        )
        self._async = async_snapshot
        # (trainer, state structure, every rank's layout) of the last
        # distributed-persist save
        self._rank_layouts: Optional[Tuple] = None

    @property
    def engine(self) -> CheckpointEngine:
        return self._engine

    def _layouts(self, state: Any, trainer):
        """Every rank's layout of ``state`` (the trainer's), which the
        distributed persist derives each shard's owner from and the peer
        restore the replica group; None when this engine needs neither.
        Computed once for each trainer and state structure: a save over a
        large world then makes no pass over every rank's leaves."""
        engine = self._engine
        if trainer is None or engine.num_processes <= 1 or not (
                engine.dist_persist or engine.peer_restore):
            return None
        shape = structure(state)
        cached = self._rank_layouts
        if cached is None or cached[0] is not trainer or cached[1] != shape:
            cached = (trainer, shape,
                      [trainer.state_layout(state, rank=r)
                       for r in range(engine.num_processes)])
            self._rank_layouts = cached
        return cached[2]

    def save_checkpoint(
        self,
        step: int,
        state: Any,
        storage_type: int = StorageType.MEMORY,
        extras: Optional[Dict] = None,
        trainer=None,
        layout: Optional[Layout] = None,
    ) -> float:
        """Returns seconds the training loop was blocked.  Raises a
        failure of an earlier save's background staging or persist.
        ``trainer``: the one that trains ``state``; on a mesh or a dp
        group its layout places this rank's shards in the global leaves.
        ``layout``, for a state no trainer made: ``{path: (global shape,
        box)}`` of this rank's tensors, a leaf it does not name whole.
        Over a world one of the two is required."""
        layout = _layout(state, trainer, layout)
        if storage_type == StorageType.DISK:
            layouts = self._layouts(state, trainer)
            if self._async:
                return self._engine.save_to_storage_async(
                    step, state, extras, layout, layouts)
            return self._engine.save_to_storage(step, state, extras, layout,
                                                layouts)
        if self._async:
            return self._engine.save_to_memory_async(step, state, extras,
                                                     layout)
        return self._engine.save_to_memory(step, state, extras,
                                           layout=layout)

    def load_checkpoint(self, target: Any, trainer=None,
                        layout: Optional[Layout] = None,
                        ) -> Tuple[Optional[Any], int]:
        """``(state, step)`` from shm if possible, storage otherwise;
        ``(None, -1)`` when no checkpoint exists.  Collective over a world
        of ranks.

        ``target`` is a state of the saved structure on its device (e.g.
        ``trainer.create_state()``); its tensors are filled in place.
        Pass the ``trainer`` that trains it: its layout places this rank's
        shards (a storage restore reshards them from whatever mesh saved
        them), and a trainer with ``grads_dtype`` runs on a copy of the
        masters held by its model, which the restore must refresh.
        ``layout`` is ``save_checkpoint``'s."""
        layout = _layout(target, trainer, layout)
        state, step = self._engine.load(target, layout,
                                        self._layouts(target, trainer))
        if state is not None and trainer is not None:
            trainer.refresh_compute_copy(state)
        return state, step

    def latest_step(self) -> int:
        return self._engine.latest_step()

    @property
    def last_extras(self):
        """The extras dict stored with the checkpoint that load_checkpoint
        restored (e.g. the data-shard position) — empty before a load."""
        return self._engine.last_extras

    def wait_latest_checkpoint(self, timeout: float = 600.0) -> bool:
        """Exit barrier: block until async persists finished.  False on
        a timeout or a dropped persist; raises on a staging or persist
        failure."""
        return self._engine.wait_saving_complete(timeout)

    def close(self):
        self._engine.close()
