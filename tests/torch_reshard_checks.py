"""Rank workers of tests/test_torch_reshard.py: the port's live reshard on
gloo ranks, started from a state the JAX package trained.

``parity_worker`` fills a dp4 ``int8_sharded`` trainer's state from the
JAX state (converted to the port's leaves: ``spec["start"]``, the whole
leaves, and ``spec["ef_rows"]``, each rank's residual row), seals it as
the donor manifest, and runs the JAX reference smoke's transitions in
the same order: the donor leg (survivors {0, 1}; ranks 2 and 3 leave),
the grow back to dp4 (ranks 2 and 3 join with fresh trainers), the
planned shrink (every replica surviving), the grow again, and one step.
After each transition every member returns its leaves: the whole params
(rank 0), its moment chunks with their boxes, its residual row, and the
report.
"""

import os
from typing import Any, Dict

import numpy as np
import torch

WORLD, SHRUNK = 4, 2


def _record(trainer, state, report) -> Dict[str, Any]:
    from dlrover_tpu_torch.common.pytree import flatten_with_path

    layout = trainer.state_layout(state)
    leaves = {}
    for path, leaf in flatten_with_path(state):
        if path.startswith("params/") and trainer.dp_group.rank != 0:
            continue
        value = (leaf.detach().cpu().numpy().copy() if torch.is_tensor(leaf)
                 else leaf)
        leaves[path] = (value, layout.get(path))
    return {"leaves": leaves, "report": report}


def parity_worker(group, spec: Dict[str, Any]) -> Dict[str, Any]:
    from dlrover_tpu_torch.common.pytree import map_with_path
    from dlrover_tpu_torch.parallel import dp_workers
    from dlrover_tpu_torch.parallel.collectives import GradSyncPolicy
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        distributed as dist_ckpt,
    )
    from dlrover_tpu_torch.trainer.optim import create_optimizer
    from dlrover_tpu_torch.trainer.train import Trainer

    device, rank = group.device, group.rank
    out: Dict[str, Any] = {"rank": rank, "legs": {}}

    def make_trainer(mesh, seed: int = 0):
        model = dp_workers.make_model(dict(spec, seed=seed), device)
        return Trainer(model, create_optimizer(**spec["optimizer"]),
                       grad_sync=GradSyncPolicy(**spec["policy"]),
                       device=device, mesh=mesh)

    def join(seed: int):
        trainer = make_trainer(None, seed=seed)
        state, report = trainer.join_live_reshard({"dp": WORLD}, rank)
        return trainer, state, report

    trainer = make_trainer(build_mesh(MeshConfig(dp=WORLD), device=device))
    state = trainer.create_state()
    layout = trainer.state_layout(state)
    start, row = spec["start"], spec["ef_rows"][rank]

    def fill(path, leaf):
        if path.startswith("ef_residual/"):
            return torch.from_numpy(row[path].copy())
        if not torch.is_tensor(leaf):
            return type(leaf)(start[path])
        box = layout.get(path, (None, [[0, d] for d in leaf.shape]))[1]
        with torch.no_grad():
            leaf.copy_(torch.from_numpy(
                start[path][tuple(slice(a, b) for a, b in box)].copy()))
        return leaf

    state = map_with_path(fill, state)
    donor = dist_ckpt.DistributedCheckpointEngine(
        os.path.join(spec["root"], "donor"))
    sealed = donor.save(
        int(state.step), state, layout=layout,
        layouts=[trainer.state_layout(state, rank=r) for r in range(WORLD)],
        wait_seal=True)
    out["sealed"] = bool(sealed.get("sealed"))

    from dlrover_tpu_torch.parallel import reshard

    if rank >= SHRUNK:
        reshard.leave_world()
        del trainer, state
        trainer, state, report = join(seed=1 + rank)
    else:
        state, report = trainer.live_reshard(
            state, {"dp": SHRUNK}, survivors=(0, 1), donor=donor)
        out["legs"]["donor"] = _record(trainer, state, report)
        state, report = trainer.live_reshard(state, {"dp": WORLD},
                                             donor=donor)
    out["legs"]["grow"] = _record(trainer, state, report)
    state, report = trainer.live_reshard(state, {"dp": SHRUNK})
    if rank >= SHRUNK:
        trainer, state, report = join(seed=10 + rank)
    else:
        out["legs"]["shrink"] = _record(trainer, state, report)
        state, report = trainer.live_reshard(state, {"dp": WORLD})
    out["legs"]["grow_again"] = _record(trainer, state, report)
    batch = trainer.shard_batch(trainer.rows_of_global_batch(spec["batch"]))
    state, metrics = trainer.train_step(state, batch)
    out["loss"] = metrics["loss"].item()
    trainer.close()
    return out


def assemble(ranks, leg: str) -> Dict[str, Any]:
    """The whole leaves of one leg from the ranks' records: params from
    rank 0, each moment from its ranks' chunks at their boxes, and the
    residual rows by rank (``ef_rows``)."""
    # a member's rank in the leg's world is its process rank: the
    # survivors keep theirs, and the joiners are ranks 2 and 3
    members = sorted((r for r in ranks if leg in r["legs"]),
                     key=lambda r: r["rank"])
    whole: Dict[str, Any] = {}
    rows = []
    for r in members:
        row = {}
        for path, (value, box) in r["legs"][leg]["leaves"].items():
            if path.startswith("ef_residual/"):
                row[path] = value
            elif box is None:
                whole.setdefault(path, value)
            else:
                gshape, index = box
                full = whole.setdefault(path, np.zeros(gshape, value.dtype))
                full[tuple(slice(a, b) for a, b in index)] = value
        rows.append(row)
    return {"whole": whole, "ef_rows": rows}


def cadence_worker(group, spec: Dict[str, Any]) -> Dict[str, Any]:
    """The step cadence's collectives across a live grow, on a world
    whose ranks had stepped different counts: 4 ranks step 3 times at
    dp4 and shrink to dp2 with every replica surviving (ranks 2 and 3
    leave); ranks 0 and 1 stage a grow to dp4 through the staging file and
    step 4 times (the poll stages it, the step boundary refuses it: the
    world stays as it was); they grow to dp4 with ranks 2 and 3 joining
    on fresh trainers, rank 0 stages a dp4 re-layout, and every rank steps
    ``spec["steps"]`` times.  ``DLROVER_TPU_DIGEST_EVERY`` and
    ``DLROVER_TPU_COMM_PROBE_EVERY`` (the caller's environment) put a
    poll's all-reduce and a probe on every second step."""
    import torch.distributed as dist

    from dlrover_tpu_torch.parallel import dp_workers, reshard
    from dlrover_tpu_torch.parallel.collectives import GradSyncPolicy
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.trainer.optim import create_optimizer
    from dlrover_tpu_torch.trainer.train import Trainer

    device, rank = group.device, group.rank
    out: Dict[str, Any] = {"rank": rank, "losses": []}

    def make_trainer(mesh, seed: int = 0):
        model = dp_workers.make_model(dict(spec, seed=seed), device)
        return Trainer(model, create_optimizer(**spec["optimizer"]),
                       grad_sync=GradSyncPolicy(**spec["policy"]),
                       device=device, mesh=mesh)

    def stage(axes, reason):
        # as the agent, another process, stages: through the file, which
        # every rank's poll reads, not this process's trainer
        target = reshard.reshard_target()
        reshard.register_reshard_target(None)
        reshard.stage_reshard_request(axes, reason=reason)
        reshard.register_reshard_target(target)

    def steps(trainer, state, n):
        for _ in range(n):
            batch = trainer.shard_batch(
                trainer.rows_of_global_batch(spec["batch"]))
            state, metrics = trainer.train_step(state, batch)
            out["losses"].append(metrics["loss"].item())
        return state

    trainer = make_trainer(build_mesh(MeshConfig(dp=WORLD), device=device))
    state = steps(trainer, trainer.create_state(), 3)
    state, _ = trainer.live_reshard(state, {"dp": SHRUNK})
    if state is None:
        # a leaver: back at the grow, on a fresh trainer
        trainer = make_trainer(None, seed=1 + rank)
        state, _ = trainer.join_live_reshard({"dp": WORLD}, rank)
    else:
        gen = reshard.generation()
        if rank == 0:
            stage({"dp": WORLD}, "grow")
        dist.barrier()
        state = steps(trainer, state, 4)
        out["grow_refused"] = {
            "world": dist.get_world_size(), "generation_kept":
            reshard.generation() == gen, "axes": trainer.mesh_axes(),
            "step": int(state.step), "watermark": trainer._reshard_seq}
        state, _ = trainer.live_reshard(state, {"dp": WORLD})
    out["joined_at_step"] = int(state.step)
    gen = reshard.generation()
    if rank == 0:
        stage({"dp": WORLD}, "re-layout")
    dist.barrier()
    state = steps(trainer, state, spec["steps"])
    out.update(world=dist.get_world_size(), step=int(state.step),
               relayout_applied=trainer._reshard_seq,
               generation=reshard.generation() - gen,
               axes=trainer.mesh_axes())
    trainer.close()
    return out
