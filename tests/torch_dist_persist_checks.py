"""Rank functions for the distributed persist tests over a gloo world (not
a test module: pytest does not collect it).

``seal_worker`` walks the two-phase commit on a state whole on every rank:
a step every rank reports seals, a step one rank never reports stays
unsealed and the previous one restorable, and it seals once that rank
reports.  ``ef_dist_worker`` saves the error-feedback residuals of a
quantized dp trainer (``torch_ckpt_checks.mlp_trainer``) under the
distributed persist, or restores them with ``Trainer.load_state``.  Torch
and the port only, so a spawned rank never imports JAX.
"""

import time
from typing import Any, Dict

import torch

from dlrover_tpu_torch.parallel.dp_workers import (
    dist_persist,
    dist_write_record,
    state_copy,
    state_equal,
)
from dlrover_tpu_torch.trainer.flash_checkpoint import (
    Checkpointer,
    StorageType,
)
from dlrover_tpu_torch.trainer.flash_checkpoint import distributed

from torch_ckpt_checks import mlp_trainer


def _barrier(group) -> None:
    group.all_reduce(torch.zeros(1, device=group.device))


def _state(value: float, step: int) -> Dict[str, Any]:
    return {"step": step, "w": torch.full((16, 8), float(value)),
            "b": torch.arange(6.0) + value,
            "h": torch.arange(32.0, dtype=torch.bfloat16) * value}


def _restore(ckpt_dir: str, scope: str):
    """``(step, state)`` of a restore of ``_state``'s structure from
    storage (a scope of its own: no shm), under the knob."""
    with dist_persist(True):
        ckpt = Checkpointer(ckpt_dir, scope=scope, async_snapshot=False,
                            device="cpu")
    try:
        got, step = ckpt.load_checkpoint(_state(-1.0, 0), layout={})
    finally:
        ckpt.engine.unlink_memory()
        ckpt.close()
    return step, got


def seal_worker(group, spec: Dict[str, Any]) -> Dict[str, Any]:
    """Step 1 saved by every rank (``DistributedCheckpointEngine`` over
    the world's store client); step 2 by every rank but the last, whose
    status every rank then reads and whose previous step every rank
    restores; then the last rank's report, after which step 2 seals.
    Returns what each stage saw."""
    ckpt_dir, rank, last = spec["dir"], group.rank, group.world - 1
    engine = distributed.DistributedCheckpointEngine(ckpt_dir)
    client = distributed.get_commit_client()
    out: Dict[str, Any] = {"client": type(client).__name__}
    one = engine.save(1, _state(1.0, 1), wait_seal=True, timeout=60)
    out["step1"] = {k: one[k] for k in ("sealed", "bytes_written",
                                        "shards_written")}
    _barrier(group)
    if rank != last:
        engine.save(2, _state(2.0, 2), wait_seal=False)
    _barrier(group)
    # the reports are in the store before the barrier: wait for process
    # 0's coordinator to take them all
    for _ in range(200):
        status = client.commit_status(ckpt_dir, 2)
        if status["reported"] == last:
            break
        time.sleep(0.05)
    out["unsealed"] = {k: status[k] for k in ("sealed", "reported",
                                              "committed_step")}
    out["committed_before"] = distributed.read_committed_step(ckpt_dir)
    step, got = _restore(ckpt_dir, spec["scope"] + "a")
    out["restored_before"] = step
    out["restored_equal"] = state_equal(got, state_copy(_state(1.0, 1)))
    _barrier(group)
    if rank == last:
        engine.save(2, _state(2.0, 2), wait_seal=False)
    out["sealed_after"] = client.wait_commit(ckpt_dir, 2, 60)
    _barrier(group)
    step, got = _restore(ckpt_dir, spec["scope"] + "b")
    out["restored_after"] = step
    out["restored_after_equal"] = state_equal(got,
                                              state_copy(_state(2.0, 2)))
    return out


def ef_dist_worker(group, spec: Dict[str, Any]) -> Dict[str, Any]:
    """``mlp_trainer`` on a dp mesh of the world.  With ``spec["save"]``:
    its state at step 2 with seeded residuals (``spec["stacks"]``, this
    rank's rows) saved to storage under the distributed persist, the
    write record (``dp_workers.dist_write_record``), and a restore at the
    same degree from a fresh scope, held to the state saved.  Without:
    ``Trainer.load_state`` from the directory under the knob, its
    ``ValueError`` message if it raises."""
    trainer = mlp_trainer(group, on_mesh=True)
    out: Dict[str, Any] = {"rank": group.rank}
    if spec.get("save"):
        state = trainer.create_state()
        state.step = 2
        state.ef_residual = {
            n: torch.from_numpy(spec["stacks"][n][group.rank].copy())
            for n in state.ef_residual}
        want = state_copy(state)
        with dist_persist(True):
            ckpt = Checkpointer(spec["dir"], scope=spec["scope"],
                                async_snapshot=False, device=group.device)
        try:
            ckpt.save_checkpoint(2, state, StorageType.DISK, trainer=trainer)
            out["persisted"] = ckpt.wait_latest_checkpoint(timeout=60)
            _barrier(group)
            out.update(dist_write_record(trainer, state, spec["dir"], 2,
                                         group.world))
        finally:
            ckpt.engine.unlink_memory()
            ckpt.close()
        with dist_persist(True):
            ckpt = Checkpointer(spec["dir"], scope=spec["scope"] + "_r",
                                device=group.device)
        try:
            restored, step = ckpt.load_checkpoint(trainer.create_state(),
                                                  trainer=trainer)
            out["step"] = step
            out["equal"] = state_equal(restored, want)
            out["read_stats"] = dict(ckpt.engine.last_read_stats)
        finally:
            ckpt.engine.unlink_memory()
            ckpt.close()
        return out
    with dist_persist(True):
        ckpt = Checkpointer(spec["dir"], scope=spec["scope"] + "_load",
                            device=group.device)
    try:
        state, step = trainer.load_state(ckpt)
        out["step"] = step
    except ValueError as e:
        out["error"] = str(e)
    finally:
        ckpt.engine.unlink_memory()
        ckpt.close()
    return out
