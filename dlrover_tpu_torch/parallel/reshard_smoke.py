"""Live-reshard smoke: dp4 -> dp2 -> dp4 in place, over 4 rank processes.

Port of ``dlrover_tpu/parallel/reshard_smoke.py``.  Four gloo ranks (one
process each, ``process_group.spawn``) prove the live reshard end to end
against the restart path it replaces:

1. dp4 trains two steps under a quantized sharded sync
   (``int8_sharded``), seals a distributed checkpoint (the donor manifest)
   and saves a flash checkpoint (the restart path's source);
2. the donor leg: ranks 2 and 3 die (they leave the world and drop their
   state); the survivors {0, 1} reshard dp4 -> dp2 in place, the departed
   moment blocks and residual rows read off the sealed manifest as
   byte-range partial reads (0 < bytes read < the state's bytes); then the
   restart baseline: a fresh dp2 trainer restores the flash checkpoint
   through ``Trainer.load_state`` in the survivors' new world, and the live
   state must equal it bit for bit (``torch.equal``, every leaf);
3. a plan whose departed shards have no donor is refused before any world
   changes;
4. the grow: ranks 2 and 3 join again as fresh processes would, with a
   new trainer of other weights and no state, and take everything from the
   survivors: params and moments equal the original dp4 state, the
   error-feedback totals are kept exactly, and the bucket layout's
   ``signature()`` is the original's;
5. the planned shrink, every replica surviving: ranks 2 and 3 hand their
   shards over and leave; the state equals the restart baseline bit for
   bit with 0 donor bytes read, and the next step's loss is the restart
   baseline's next loss, bit for bit;
6. the grow back to dp4, and one more step;
7. the ledger: every rank priced ``live_reshard`` > 0 s and
   ``rendezvous_restart`` = 0 s.

The joiners are the processes of ranks 2 and 3: they leave the world,
delete their trainer and state, and join the next generation with a new
trainer, the path a newly started process takes (``Trainer.
join_live_reshard`` over the base store; a new process attaches it first
with ``reshard.attach_world``).

Run (the ranks compute on the card unless asked for the CPU)::

    python -m dlrover_tpu_torch.parallel.reshard_smoke --device cpu

Prints ``RESHARD_SMOKE {json}``; exit 0 iff every check passed.
"""

import argparse
import json
import math
import os
import shutil
import sys
import tempfile
import time
import uuid
from typing import Any, Dict, Optional

WORLD = 4
SHRUNK = 2
STEPS = 2


def tiny_spec() -> Dict[str, Any]:
    """The CPU smoke's run: the reference's tiny Llama (4 kv heads) in
    fp32, a global batch of 8 rows of 32 tokens, AdamW at lr 1e-2."""
    import numpy as np
    import torch

    ids = np.random.default_rng(7).integers(0, 256, size=(8, 33))
    return dict(
        preset="tiny", model=dict(num_kv_heads=4, dtype=torch.float32),
        state_dict=None, seed=0,
        batch={"input_ids": ids[:, :-1].astype(np.int32),
               "labels": ids[:, 1:].astype(np.int32)},
        optimizer=dict(peak_lr=1e-2, warmup_steps=0, total_steps=100,
                       weight_decay=0.1, grad_clip_norm=None),
        grads_dtype=None,
        policy=dict(mode="int8_sharded", clip_norm=1.0),
    )


def _check(checks: Dict[str, bool], name: str, ok: bool, detail: str = ""):
    checks[name] = bool(ok)
    if not ok:
        print(f"reshard smoke check FAILED: {name} {detail}",
              file=sys.stderr, flush=True)


def _ef_totals(group, state) -> Dict[str, Any]:
    """The sum of every rank's residual row, by leaf, in numpy on the host
    (collective over ``group``)."""
    import numpy as np

    out = {}
    for name, row in sorted((state.ef_residual or {}).items()):
        rows = group.all_gather(row).cpu().numpy()
        out[name] = np.asarray(rows, np.float32).sum(axis=0)
    return out


def _equal(state, want: Dict[str, Any], prefix: str = "") -> bool:
    import torch

    from dlrover_tpu_torch.common.pytree import flatten_with_path

    got = {p: v for p, v in flatten_with_path(state) if p.startswith(prefix)}
    want = {p: v for p, v in want.items() if p.startswith(prefix)}
    return got.keys() == want.keys() and all(
        torch.equal(v, want[p]) if torch.is_tensor(v) else v == want[p]
        for p, v in got.items())


def _state_bytes(state) -> int:
    import torch

    from dlrover_tpu_torch.common.pytree import flatten_with_path

    return sum(v.numel() * v.element_size()
               for _, v in flatten_with_path(state) if torch.is_tensor(v))


def smoke_worker(group, spec: Dict[str, Any]) -> Dict[str, Any]:
    """One rank of the smoke (module docstring); returns its checks, the
    legs' reports and timings, and (``spec["count_launches"]``) the flash
    and ring kernels' launches over the run."""
    import torch

    from dlrover_tpu_torch.observability import goodput
    from dlrover_tpu_torch.ops.cuda import flash_attention as fa
    from dlrover_tpu_torch.parallel import dp_workers, reshard
    from dlrover_tpu_torch.parallel.collectives import GradSyncPolicy
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        Checkpointer,
        StorageType,
    )
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        distributed as dist_ckpt,
    )
    from dlrover_tpu_torch.trainer.optim import create_optimizer
    from dlrover_tpu_torch.trainer.train import Trainer

    os.environ["DLROVER_TPU_GOODPUT_RES_S"] = "0.005"
    goodput.reset_ledger()
    dp_workers.reset_launch_counts()
    fa.reset_launches()
    device, rank = group.device, group.rank
    checks: Dict[str, bool] = {}
    out: Dict[str, Any] = {"rank": rank, "checks": checks, "legs": {}}
    root, tag = spec["root"], spec["tag"]
    donor_dir = os.path.join(root, "donor")

    def make_trainer(mesh, seed: int = 0):
        model = dp_workers.make_model(dict(spec, seed=seed), device)
        return Trainer(model, create_optimizer(**spec["optimizer"]),
                       grad_sync=GradSyncPolicy(**spec["policy"]),
                       grads_dtype=spec.get("grads_dtype"), device=device,
                       mesh=mesh)

    def rows(trainer):
        return trainer.shard_batch(trainer.rows_of_global_batch(
            spec["batch"]))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def step(trainer, state):
        state, metrics = trainer.train_step(state, rows(trainer))
        return state, metrics["loss"].item()

    def join(seed: int):
        trainer = make_trainer(None, seed=seed)
        sync()
        state, report = trainer.join_live_reshard(
            {"dp": WORLD}, rank, reason="smoke grow")
        return trainer, state, report

    # -- dp4: two steps, the donor manifest, the restart path's source ---
    setup: Dict[str, float] = {}
    out["setup_s"] = setup
    t0 = time.perf_counter()
    trainer = make_trainer(build_mesh(MeshConfig(dp=WORLD), device=device))
    state = trainer.create_state()
    sync()
    setup["model"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state, _ = step(trainer, state)
    setup["steps"] = time.perf_counter() - t0
    sig4 = trainer.grad_sync_summary().get("signature")
    out["bucket_widths"] = {
        WORLD: trainer.grad_sync_summary().get("bucket_widths")}
    orig = dp_workers.state_copy(state)
    orig_ef = _ef_totals(group, state)
    state_bytes = int(group.all_reduce(torch.tensor(
        [_state_bytes(state)], dtype=torch.int64, device=device)).item())
    t0 = time.perf_counter()
    donor = dist_ckpt.DistributedCheckpointEngine(donor_dir)
    sealed = donor.save(
        STEPS, state, layout=trainer.state_layout(state),
        layouts=[trainer.state_layout(state, rank=r) for r in range(WORLD)],
        wait_seal=True)
    _check(checks, "donor_sealed", bool(sealed.get("sealed")), str(sealed))
    setup["seal"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt = Checkpointer(root, scope=f"{tag}a", device=device)
    ckpt.save_checkpoint(STEPS, state, StorageType.DISK, trainer=trainer)
    _check(checks, "baseline_saved", ckpt.wait_latest_checkpoint(timeout=600))
    # process 0 commits the step once every process persisted its part
    group.all_reduce(torch.zeros(1, device=device))
    ckpt.engine.unlink_memory()
    ckpt.close()
    setup["save"] = time.perf_counter() - t0

    # -- the donor leg: ranks 2 and 3 die -------------------------------
    restart: Optional[Dict[str, Any]] = None
    loss_restart_next = None
    if rank >= SHRUNK:
        reshard.leave_world()
        trainer.close()
        del trainer, state
    else:
        sync()
        state_d, rep_d = trainer.live_reshard(
            state, {"dp": SHRUNK}, survivors=(0, 1), donor=donor,
            reason="smoke node loss")
        sync()
        out["legs"]["donor"] = rep_d
        del state
        _check(checks, "donor_partial_reads",
               0 < rep_d["donor_bytes_read"] < state_bytes,
               f"{rep_d['donor_bytes_read']} of {state_bytes}")
        # the restart baseline: a fresh dp2 trainer restores from storage
        sync()
        t0 = time.perf_counter()
        trainer_r = make_trainer(build_mesh(MeshConfig(dp=SHRUNK),
                                            device=device))
        ckpt_r = Checkpointer(root, scope=f"{tag}r", device=device)
        state_r, got = trainer_r.load_state(ckpt_r)
        sync()
        out["restart_s"] = time.perf_counter() - t0
        _check(checks, "restart_restored",
               state_r is not None and got == STEPS, f"step={got}")
        restart = dp_workers.state_copy(state_r)
        _check(checks, "donor_bit_exact", _equal(state_d, restart))
        _, loss_restart_next = step(trainer_r, state_r)
        ckpt_r.engine.unlink_memory()
        ckpt_r.close()
        trainer_r.close()
        del trainer_r, state_r
        # a departed shard with no donor: refused, the world untouched
        refused = False
        try:
            trainer.live_reshard(state_d, {"dp": WORLD}, survivors=(0,),
                                 donor=None, reason="no donor")
        except reshard.ReshardRefused:
            refused = True
        _check(checks, "refused_without_donor", refused)
        group_now = trainer.dp_group
        _check(checks, "world_kept_after_refusal",
               group_now.world == SHRUNK and int(group_now.all_reduce(
                   torch.ones(1, device=device)).item()) == SHRUNK)

    # -- the grow back to dp4: the joiners take everything ---------------
    sync()
    if rank >= SHRUNK:
        trainer, state4, rep4 = join(seed=1 + rank)
    else:
        state4, rep4 = trainer.live_reshard(state_d, {"dp": WORLD},
                                            donor=donor,
                                            reason="smoke grow")
        del state_d
    sync()
    out["legs"]["grow"] = rep4
    _check(checks, "grow_params_bit_exact", _equal(state4, orig, "params/"))
    _check(checks, "grow_moments_bit_exact",
           _equal(state4, orig, "opt_state/"))
    from dlrover_tpu_torch.parallel.process_group import DpGroup

    world4 = DpGroup(device)
    ef_after = _ef_totals(world4, state4)
    _check(checks, "grow_ef_totals_exact",
           ef_after.keys() == orig_ef.keys() and all(
               (ef_after[k] == orig_ef[k]).all() for k in orig_ef))
    sig = trainer.grad_sync_summary().get("signature")
    _check(checks, "bucket_signature_stable", sig == sig4,
           f"{sig} != {sig4}")
    del orig

    # -- the planned shrink, every replica surviving ----------------------
    sync()
    state2, rep = trainer.live_reshard(state4, {"dp": SHRUNK},
                                       reason="smoke planned shrink")
    sync()
    out["legs"]["shrink"] = rep
    del state4
    if rank >= SHRUNK:
        _check(checks, "leaver_left", state2 is None and rep["left"])
        trainer.close()
        del trainer
    else:
        out["bucket_widths"][SHRUNK] = trainer.grad_sync_summary().get(
            "bucket_widths")
        _check(checks, "shrink_bit_exact", _equal(state2, restart))
        _check(checks, "shrink_zero_donor_bytes",
               rep["donor_bytes_read"] == 0, str(rep))
        state2, loss_live_next = step(trainer, state2)
        out["loss_live_next"] = loss_live_next
        out["loss_restart_next"] = loss_restart_next
        _check(checks, "next_loss_bitwise_restart",
               loss_live_next == loss_restart_next,
               f"{loss_live_next!r} != {loss_restart_next!r}")

    # -- grow again, and one more step on dp4 -----------------------------
    sync()
    if rank >= SHRUNK:
        trainer, state4, rep4b = join(seed=10 + rank)
    else:
        state4, rep4b = trainer.live_reshard(state2, {"dp": WORLD},
                                             reason="smoke final grow")
        del state2
    out["legs"]["grow_again"] = rep4b
    state4, loss = step(trainer, state4)
    out["final_loss"] = loss
    _check(checks, "post_reshard_step_finite", math.isfinite(loss))
    sync()

    # -- the ledger: priced as live_reshard, nothing restarted ------------
    phases = goodput.ledger().summary()["phases"]
    out["phases"] = phases
    _check(checks, "ledger_live_reshard_priced",
           phases.get("live_reshard", 0.0) > 0.0, str(phases))
    _check(checks, "ledger_zero_rendezvous",
           phases.get("rendezvous_restart", 0.0) == 0.0, str(phases))
    if spec.get("count_launches"):
        out["launches"] = dict(fa.launches, **dp_workers.launch_counts())
    trainer.close()
    return out


def run_smoke(device: str = "cuda", spec: Optional[Dict[str, Any]] = None,
              timeout_s: float = 300.0) -> Dict[str, Any]:
    """Spawn the 4 ranks (gloo; on the card unless ``device="cpu"``) and
    fold their results: ``ok`` iff every rank passed every check."""
    from dlrover_tpu_torch.parallel import process_group

    spec = dict(spec or tiny_spec())
    root = tempfile.mkdtemp(prefix="dlrover_tpu_reshard_smoke_")
    spec.update(root=root, tag=f"rss{uuid.uuid4().hex[:6]}")
    t0 = time.perf_counter()
    try:
        ranks = process_group.spawn(smoke_worker, WORLD, (spec,),
                                    backend="gloo", device=device,
                                    timeout_s=timeout_s)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    checks = {f"rank{r['rank']}.{k}": v for r in ranks
              for k, v in r["checks"].items()}
    donor = ranks[0]["legs"]["donor"]
    shrink = [r["legs"]["shrink"] for r in ranks[:SHRUNK]]
    live_s = max(leg["elapsed_s"] for leg in shrink)
    restart_s = max(r["restart_s"] for r in ranks[:SHRUNK])
    legs = ("donor", "grow", "shrink", "grow_again")
    # each leg's seconds on the survivors (ranks 0 and 1, the slower):
    # a joiner's also count its wait for the survivors' earlier work
    return {
        "ok": bool(checks) and all(checks.values()),
        "checks": checks,
        "donor_bytes_read": donor["donor_bytes_read"],
        "donor_shards_fetched": donor["donor_shards_fetched"],
        "live_reshard_s": live_s,
        "restart_s": restart_s,
        "reshard_speedup_vs_restart": (restart_s / live_s if live_s
                                       else None),
        "ledger_live_reshard_s": max(r["phases"].get("live_reshard", 0.0)
                                     for r in ranks),
        "legs_s": {name: {part: max(r["legs"][name][part]
                                    for r in ranks[:SHRUNK])
                          for part in ("elapsed_s", "reform_s",
                                       "exchange_s", "rebuild_s")}
                   for name in legs},
        "setup_s": {part: max(r["setup_s"][part] for r in ranks)
                    for part in ranks[0]["setup_s"]},
        "loss_live_next": ranks[0].get("loss_live_next"),
        "loss_restart_next": ranks[0].get("loss_restart_next"),
        "final_loss": ranks[0]["final_loss"],
        "launches": [r.get("launches") for r in ranks],
        "bucket_widths": ranks[0]["bucket_widths"],
        "wall_s": time.perf_counter() - t0,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    os.environ.setdefault("DLROVER_TPU_JOB_NAME",
                          f"rsm{uuid.uuid4().hex[:6]}")
    result = run_smoke(args.device)
    print("RESHARD_SMOKE " + json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
