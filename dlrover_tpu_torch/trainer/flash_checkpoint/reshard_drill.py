"""Elastic-reshard drill: save on one mesh, restore onto another.

Port of ``dlrover_tpu/trainer/flash_checkpoint/reshard_drill.py``.  The
single-engine resharding restore is the checkpoint design's
differentiator: the shard index maps make any-mesh -> any-mesh restore a
plain load.  The drill proves it end to end and times it, over 8 gloo rank
processes (one per rank, ``process_group.spawn``): mesh A
(dp1/fsdp2/tp2/cp2) trains a step and saves to storage; every rank's shm
segment of mesh B's scope then holds a deliberately torn snapshot (a
stream killed mid-write), which the restore must refuse; mesh B
(dp2/fsdp4) restores from storage, the loss carries on across the restore
(mesh B's first step evaluates the restored state as mesh A's next step
evaluates the saved one), and one more step runs on the new mesh.  The
save and the restore are timed by the goodput ledger (``ckpt_stall``),
the account the production goodput report prints.

The grad-sync leg (:func:`run_grad_sync_reshard_leg`, 4 ranks) carries
the ``int8_sharded`` state across dp4 -> dp2 both ways: the restart path
(new rank processes rebuild the trainer at dp2 and restore through
``Trainer.load_state``, priced under an ``rdzv.restore`` span as
``rendezvous_restart``) and the live path (the running ranks reshard in
place, ``Trainer.live_reshard``, priced as ``live_reshard``).  The live
state must equal the restart's bit for bit, the error-feedback total
must be kept, and ``reshard_speedup_vs_restart`` compares the two ledger
prices.

``bench.reshard_drill_subprocess`` runs this module.  The ranks compute on
the card unless asked for the CPU::

    python -m dlrover_tpu_torch.trainer.flash_checkpoint.reshard_drill \\
        --device cpu

prints ``RESHARD_DRILL {json}``.
"""

import argparse
import contextlib
import json
import math
import os
import shutil
import sys
import tempfile
import uuid
from typing import Any, Dict, Optional

import numpy as np
import torch

MESH_A = dict(dp=1, fsdp=2, tp=2, cp=2)
MESH_B = dict(dp=2, fsdp=4)
LOSS_RTOL = 1e-4
EF_RTOL, EF_ATOL = 1e-5, 1e-7


@contextlib.contextmanager
def _ledger_phases(out: Dict):
    """The goodput ledger as the drill's stopwatch: reset it with fine
    buckets, run the leg, hand back the accrued per-phase seconds, the
    same account the production goodput report prints."""
    from dlrover_tpu_torch.observability import goodput

    overrides = {"DLROVER_TPU_GOODPUT_RES_S": "0.005"}
    saved = {key: os.environ.get(key) for key in overrides}
    os.environ.update(overrides)
    try:
        goodput.reset_ledger()
        yield
        out.update(goodput.ledger().summary()["phases"])
    finally:
        for key, old in saved.items():
            if old is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = old
        goodput.reset_ledger()


def default_spec() -> Dict[str, Any]:
    """The reference drill's job: the tiny Llama (4 kv heads), a global
    batch of 8 rows of 64 tokens, AdamW at lr 1e-2.  It computes in fp32:
    in bf16 the two meshes round the forward differently (tp and cp split
    its sums), by 1.2e-4 of the loss on the CPU, which would hide what
    the comparison judges: the restore."""
    ids = np.random.default_rng(0).integers(0, 256, size=(8, 65))
    return dict(
        preset="tiny", model=dict(num_kv_heads=4, dtype=torch.float32),
        state_dict=None, seed=0,
        batch={"input_ids": ids[:, :-1].astype(np.int32),
               "labels": ids[:, 1:].astype(np.int32)})


def _trainer(spec: Dict[str, Any], device, axes: Optional[Dict] = None,
             grad_sync: str = "exact"):
    from dlrover_tpu_torch.parallel import dp_workers
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.trainer import optim
    from dlrover_tpu_torch.trainer.train import Trainer

    mesh = (build_mesh(MeshConfig.from_dict(axes), device=device)
            if axes is not None else None)
    model = dp_workers.make_model(spec, device)
    return Trainer(model, optim.adamw(lambda count: 1e-2), device=device,
                   grad_sync=grad_sync, mesh=mesh)


def _step(trainer, state, spec):
    rows = trainer.shard_batch(trainer.rows_of_global_batch(spec["batch"]))
    state, metrics = trainer.train_step(state, rows)
    return state, metrics["loss"].item()


def mesh_worker(group, spec: Dict[str, Any]) -> Dict[str, Any]:
    """A rank of the storage leg (module docstring)."""
    from dlrover_tpu_torch.common.multi_process import SharedMemoryBuffer
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        Checkpointer,
        StorageType,
        snapshot,
    )
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import shm_name

    device, rank = group.device, group.rank
    ckpt_dir, tag = spec["ckpt_dir"], spec["tag"]
    # -- mesh A: one step, a save to storage, its next loss ------------
    trainer = _trainer(spec, device, MESH_A)
    state = trainer.create_state()
    state, _ = _step(trainer, state, spec)
    ckpt = Checkpointer(ckpt_dir, scope=f"rsa{tag}", device=device)
    save_phases: Dict = {}
    with _ledger_phases(save_phases):
        ckpt.save_checkpoint(1, state, StorageType.DISK, trainer=trainer)
        saved = ckpt.wait_latest_checkpoint(timeout=300)
    # process 0 commits the step once every process persisted its part
    group.all_reduce(torch.zeros(1, device=device))
    ckpt.engine.unlink_memory()
    ckpt.close()
    _, loss_before = _step(trainer, state, spec)
    trainer.close()
    del trainer, state

    # -- torn shm: a stager killed mid-stream leaves a dirty-generation
    # snapshot in mesh B's segment; the restore must refuse it ----------
    torn = SharedMemoryBuffer(shm_name(rank, f"rsb{tag}"))
    # several leaves: a shard of at most 2 MiB lands as one chunk
    stub = {f"junk{i}": torch.arange(1 << 14, dtype=torch.float32)
            for i in range(4)}

    def _fault(chunk_idx):
        if chunk_idx >= 1:
            raise RuntimeError("injected mid-stream kill")

    snapshot.set_stream_fault(_fault)
    fired = False
    try:
        snapshot.stream_snapshot(torn, 99, snapshot.plan_shards(stub),
                                 chunk_bytes=1 << 14)
    except RuntimeError:
        fired = True
    finally:
        snapshot.set_stream_fault(None)
    torn_ok = (fired and snapshot.is_torn(torn)
               and snapshot.read_snapshot_meta(torn) is None)
    torn.close()

    # -- mesh B: restore with another layout, from storage ---------------
    trainer = _trainer(spec, device, MESH_B)
    ckpt = Checkpointer(ckpt_dir, scope=f"rsb{tag}", device=device)
    restore_phases: Dict = {}
    with _ledger_phases(restore_phases):
        state, step = ckpt.load_checkpoint(trainer.create_state(),
                                           trainer=trainer)
    out: Dict[str, Any] = {
        "saved": saved, "torn_refused": torn_ok, "step": step,
        "save_s": save_phases.get("ckpt_stall", 0.0),
        "restore_s": restore_phases.get("ckpt_stall", 0.0),
        "loss_before": loss_before,
    }
    if state is not None:
        state, out["loss_after"] = _step(trainer, state, spec)
        _, out["post_reshard_step_loss"] = _step(trainer, state, spec)
    ckpt.engine.unlink_memory()
    ckpt.close()
    trainer.close()
    return out


def run_reshard_drill(device: str = "cuda", ckpt_dir: Optional[str] = None,
                      spec: Optional[Dict[str, Any]] = None,
                      grad_sync_leg: bool = True,
                      timeout_s: float = 600.0) -> Dict[str, Any]:
    """The storage leg over 8 ranks, then the grad-sync leg over 4; raises
    ``AssertionError`` when the storage leg's contract fails.  The
    grad-sync leg reports its own failure instead of voiding the storage
    leg's evidence."""
    from dlrover_tpu_torch.parallel import process_group

    spec = dict(spec or default_spec())
    own_dir = ckpt_dir is None
    if own_dir:
        ckpt_dir = tempfile.mkdtemp(prefix="dlrover_tpu_reshard_")
    spec.update(ckpt_dir=ckpt_dir, tag=uuid.uuid4().hex[:8])
    try:
        ranks = process_group.spawn(mesh_worker, 8, (spec,), device=device,
                                    timeout_s=timeout_s)
        first = ranks[0]
        assert all(r["saved"] for r in ranks), (
            "reshard drill: save did not persist")
        assert all(r["torn_refused"] for r in ranks), (
            "a torn snapshot must read as no-snapshot")
        assert all(r["step"] == 1 for r in ranks), (
            f"reshard restore failed (steps {[r['step'] for r in ranks]})")
        before, after = first["loss_before"], first["loss_after"]
        assert abs(after - before) <= LOSS_RTOL * max(1.0, abs(before)), (
            f"loss discontinuity across reshard: {before} -> {after}")
        assert math.isfinite(first["post_reshard_step_loss"]), (
            "post-reshard step diverged")
        result: Dict[str, Any] = {
            "save_s": max(r["save_s"] for r in ranks),
            "restore_reshard_s": max(r["restore_s"] for r in ranks),
            "loss_before": before,
            "loss_after": after,
            "post_reshard_step_loss": first["post_reshard_step_loss"],
            "mesh_a": "dp1/fsdp2/tp2/cp2",
            "mesh_b": "dp2/fsdp4",
            # mesh B's shm held a torn snapshot; step 1 restored from
            # storage proves the restore refused it
            "torn_shm_fallback": True,
            "timing_source": "goodput_ledger",
        }
        if grad_sync_leg:
            try:
                result["grad_sync_reshard"] = run_grad_sync_reshard_leg(
                    device, dict(spec, ckpt_dir=os.path.join(
                        ckpt_dir, "grad_sync")), timeout_s)
            except Exception as e:  # noqa: BLE001 - the storage leg is
                # the gate; the grad-sync leg reports its own failure
                result["grad_sync_reshard"] = {"error": str(e)[:300]}
            gs = result["grad_sync_reshard"]
            if "live_reshard_s" in gs:
                result["live_reshard_s"] = gs["live_reshard_s"]
                result["reshard_speedup_vs_restart"] = (
                    gs["reshard_speedup_vs_restart"])
        return result
    finally:
        if own_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)


def _ef_totals(group, state) -> Dict[str, np.ndarray]:
    return {name: np.asarray(group.all_gather(row).cpu().numpy(),
                             np.float32).sum(axis=0)
            for name, row in sorted((state.ef_residual or {}).items())}


def _host(state) -> Dict[str, Any]:
    from dlrover_tpu_torch.common.pytree import flatten_with_path

    return {p: (v.detach().cpu().numpy().copy() if torch.is_tensor(v)
                else v) for p, v in flatten_with_path(state)}


def live_worker(group, spec: Dict[str, Any]) -> Dict[str, Any]:
    """A rank of the running dp4 job: two quantized steps, a save, then
    the live shrink to dp2 priced by its own ledger."""
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        Checkpointer,
        StorageType,
    )

    device = group.device
    trainer = _trainer(spec, device, {"dp": 4}, grad_sync="int8_sharded")
    state = trainer.create_state()
    for _ in range(2):
        state, _ = _step(trainer, state, spec)
    ef_before = _ef_totals(group, state)
    ckpt = Checkpointer(spec["ckpt_dir"], scope=f"gsa{spec['tag']}",
                        device=device)
    ckpt.save_checkpoint(2, state, StorageType.DISK, trainer=trainer)
    saved = ckpt.wait_latest_checkpoint(timeout=300)
    group.all_reduce(torch.zeros(1, device=device))
    ckpt.engine.unlink_memory()
    ckpt.close()
    live_phases: Dict = {}
    with _ledger_phases(live_phases):
        state, report = trainer.live_reshard(
            state, {"dp": 2}, reason="reshard drill live leg")
    out = {"saved": saved, "ef_before": ef_before, "phases": live_phases,
           "report": report}
    if state is not None:
        out["state"] = _host(state)
        state, out["loss_after"] = _step(trainer, state, spec)
        _, out["next_loss"] = _step(trainer, state, spec)
    trainer.close()
    return out


def restart_worker(group, spec: Dict[str, Any]) -> Dict[str, Any]:
    """A respawned rank of the restart path: the trainer rebuilt at dp2
    and restored from storage, the whole window under ``rdzv.restore``
    (priced as ``rendezvous_restart``)."""
    from dlrover_tpu_torch.observability import trace
    from dlrover_tpu_torch.trainer.flash_checkpoint import Checkpointer

    device = group.device
    phases: Dict = {}
    with _ledger_phases(phases):
        with trace.span("rdzv.restore"):
            trainer = _trainer(spec, device, {"dp": 2},
                               grad_sync="int8_sharded")
            ckpt = Checkpointer(spec["ckpt_dir"], scope=f"gsb{spec['tag']}",
                                device=device)
            state, step = trainer.load_state(ckpt)
    out = {"step": step, "phases": phases}
    if state is not None:
        out["state"] = _host(state)
        out["ef_after"] = _ef_totals(group, state)
        state, out["loss_after"] = _step(trainer, state, spec)
    ckpt.engine.unlink_memory()
    ckpt.close()
    trainer.close()
    return out


def run_grad_sync_reshard_leg(device: str, spec: Dict[str, Any],
                              timeout_s: float = 600.0) -> Dict[str, Any]:
    """The int8_sharded state across dp4 -> dp2, restart and live
    (module docstring)."""
    from dlrover_tpu_torch.parallel import process_group

    live = process_group.spawn(live_worker, 4, (spec,), device=device,
                               timeout_s=timeout_s)
    assert all(r["saved"] for r in live), (
        "grad-sync reshard leg: save did not persist")
    restart = process_group.spawn(restart_worker, 2, (spec,), device=device,
                                  timeout_s=timeout_s)
    assert all(r["step"] == 2 for r in restart), (
        f"grad-sync reshard restore failed "
        f"(steps {[r['step'] for r in restart]})")
    restore_s = max(sum(r["phases"].values()) for r in restart)
    live_s = max(sum(r["phases"].values()) for r in live)
    assert all(r["phases"].get("live_reshard", 0.0) > 0.0 for r in live), (
        "live transition unpriced")
    assert all(r["phases"].get("rendezvous_restart", 0.0) == 0.0
               for r in live), "live transition restarted something"
    assert all(r["report"].get("donor_bytes_read", 0) == 0 for r in live), (
        "all-survivor shrink must not touch the donor manifest")
    stayers = [r for r in live if "state" in r]
    for got, want in zip(stayers, restart):
        assert got["state"].keys() == want["state"].keys()
        for key, value in want["state"].items():
            assert np.array_equal(got["state"][key], value), (
                f"live reshard diverged from the restart path at {key}")
    before = live[0]["ef_before"]
    for key, total in before.items():
        np.testing.assert_allclose(
            restart[0]["ef_after"][key], total, rtol=EF_RTOL, atol=EF_ATOL,
            err_msg=f"EF total not preserved for {key}")
    loss_live, loss_restart = stayers[0]["loss_after"], restart[0][
        "loss_after"]
    assert loss_live == loss_restart, (
        f"live step loss {loss_live!r} != restart {loss_restart!r}")
    assert math.isfinite(stayers[0]["next_loss"]), (
        "post-reshard grad-sync step diverged")
    return {
        "mode": "int8_sharded",
        "dp_from": 4,
        "dp_to": 2,
        "restore_s": restore_s,
        "live_reshard_s": live_s,
        "reshard_speedup_vs_restart": (restore_s / live_s if live_s
                                       else None),
        "live_bit_exact_vs_restart": True,
        "loss_after": loss_live,
        "post_reshard_step_loss": stayers[0]["next_loss"],
        "ef_total_preserved": True,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--storage-only", action="store_true",
                        help="skip the grad-sync leg")
    args = parser.parse_args(argv)
    os.environ.setdefault("DLROVER_TPU_JOB_NAME",
                          f"rs{uuid.uuid4().hex[:6]}")
    result = run_reshard_drill(args.device,
                               grad_sync_leg=not args.storage_only)
    print("RESHARD_DRILL " + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
