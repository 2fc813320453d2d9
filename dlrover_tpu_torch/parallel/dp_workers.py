"""What each rank process runs: the dp grad sync and the mesh driven end
to end.

``process_group.spawn`` starts one process per rank and calls one of these
functions in each; they live in the package so that a rank imports torch
and the port only.  ``train_worker`` drives ``Trainer`` through a list of
runs from the same start, each a sync mode over the dp group or a mesh
(``build_mesh`` -> ``Trainer(mesh=...)``; ``chip_smoke.py`` on the card,
the CPU tests at a tiny size); ``reduce_scatter_worker`` drives
``collectives.bucket_reduce_scatter`` on given payloads;
``peer_window_worker`` builds a ``PeerWindow`` and moves one row to each
right neighbour through it.
"""

import contextlib
import dataclasses
import json
import math
import os
import time
import zlib
from typing import Any, Dict, List

import numpy as np
import torch
from torch.distributed.tensor import Shard

from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.common.constants import ConfigPath
from dlrover_tpu_torch.common.pytree import flatten_with_path
from dlrover_tpu_torch.observability import flight_recorder
from dlrover_tpu_torch.ops.cuda import flash_attention as fa
from dlrover_tpu_torch.ops.cuda import rdma_ring
from dlrover_tpu_torch.ops.cuda import ring_reduce_scatter as ring
from dlrover_tpu_torch.parallel import collectives
from dlrover_tpu_torch.parallel.mesh import (
    MESH_AXIS_NAMES,
    MeshConfig,
    build_mesh,
    mesh_shape,
)
from dlrover_tpu_torch.parallel.peer_memory import PeerWindow
from dlrover_tpu_torch.parallel.process_group import DpGroup


def launch_counts() -> Dict[str, int]:
    """The ring kernels' launch counters (``ring_reduce_scatter`` and
    ``rdma_ring``), by kernel."""
    return {**ring.launches, **rdma_ring.launches}


def reset_launch_counts() -> None:
    ring.reset_launches()
    rdma_ring.reset_launches()


def params_checksum(params: Dict[str, torch.Tensor]) -> int:
    """Sum of the fp32 bit patterns of every param: equal on two ranks iff
    (almost surely) their params are bit-identical."""
    total = 0
    for p in params.values():
        total += int(p.detach().float().contiguous().view(torch.int32)
                     .to(torch.int64).sum().item())
    return total


def sharding_axes(placements) -> list:
    """The mesh axes a placement tuple (over ``MESH_AXIS_NAMES``) shards
    along, in mesh order."""
    return [a for a, p in zip(MESH_AXIS_NAMES, placements)
            if isinstance(p, Shard)]


def _family(name: str):
    """(config class, model class) of a model family: ``llama`` (the
    default), ``moe``, ``gpt`` or ``vit``."""
    if name == "moe":
        from dlrover_tpu_torch.models.moe import (
            MoELlamaConfig,
            MoELlamaForCausalLM,
        )
        return MoELlamaConfig, MoELlamaForCausalLM
    if name == "gpt":
        from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
        return GPTConfig, GPT
    if name == "vit":
        from dlrover_tpu_torch.models.vit import (
            ViTConfig,
            ViTForImageClassification,
        )
        return ViTConfig, ViTForImageClassification
    from dlrover_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    return LlamaConfig, LlamaForCausalLM


def make_model(spec: Dict[str, Any], device, overrides=None):
    """The port's model of ``spec``: the family ``family`` names (the
    Llama by default; ``moe``, ``gpt``, ``vit``); ``model`` (config fields
    and ``overrides``, over the ``preset``'s when one is named), loaded
    with ``state_dict`` (numpy) or, when that is None, seeded from
    ``seed``."""
    config_cls, model_cls = _family(spec.get("family", "llama"))
    preset = spec.get("preset")
    fields = dict(spec["model"], **(overrides or {}))
    cfg = (dataclasses.replace(getattr(config_cls, preset)(), **fields)
           if preset else config_cls(**fields))
    model = model_cls(cfg, device=device, seed=spec.get("seed", 0))
    if spec.get("state_dict") is not None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               spec["state_dict"].items()})
    return model


def make_loss(spec: Dict[str, Any], model):
    """The ``Trainer`` ``loss_fn`` of ``spec``: ``moe_loss_fn`` for
    ``family="moe"``, ``vit_loss_fn`` for ``"vit"``, else None (the
    trainer's own LM loss)."""
    family = spec.get("family")
    if family == "moe":
        from dlrover_tpu_torch.models.moe import moe_loss_fn
        return moe_loss_fn(model)
    if family == "vit":
        from dlrover_tpu_torch.models.vit import vit_loss_fn
        return vit_loss_fn(model)
    return None


def train_worker(group: DpGroup, spec: Dict[str, Any]) -> Dict[str, Any]:
    """Run ``spec["runs"]`` one after the other, each from the same start.

    ``spec``: the model (``make_model``), ``batch`` (the global numpy
    batch; this rank takes its rows), ``optimizer`` (``create_optimizer``
    kwargs), ``grads_dtype``, ``runs`` and ``return_params``.  A run is
    ``{"name", "steps"}`` with either ``"policy"`` (``GradSyncPolicy``
    kwargs: the trainer over the dp group) or ``"axes"`` (``MeshConfig``
    fields: the trainer on ``build_mesh`` of them), and optionally
    ``"grad_accum"``, ``"model"`` fields and ``"grads_dtype"`` over the
    spec's, ``"spec"``, keys that replace the spec's for this run (another
    ``family``, ``preset`` or ``state_dict``), and the flash checkpoint's
    ``"resume"`` and ``"save"`` (``{"dir", "scope"}`` each) and
    ``"dist_save"`` (the same): ``resume`` starts the run from
    ``Trainer.load_state`` of that directory instead of a fresh state,
    ``save`` ends it with ``save_and_restore``, and ``dist_save`` with
    another ``save_and_restore`` under the distributed persist; and
    ``"lose"`` (``{"dir", "scope", "mode"}``), which ends it with
    ``lose_and_restore``; and ``"env"``, knobs set while the run's trainer
    is made and steps (the telemetry's: ``DLROVER_TPU_DIGEST_EVERY``,
    ``DLROVER_TPU_COMM_PROBE_EVERY``, ...).

    Returns, per run: losses, grad norms, step seconds (on the host clock,
    after a device synchronize), the ring and flash kernels' launches per
    step, peak device memory and, on rank 0 with ``return_params``, the
    final params (gathered whole on a mesh).  A dp run adds whether every
    rank's params were bit-identical after every step and the sync
    summary; a mesh run adds the mesh's shape, this rank's coordinate on
    it, each parameter's local shape and the sharding axes of each param
    and moment leaf.  A resumed run adds ``resumed_step``, ``restore_s``,
    ``read_stats`` (the bytes a restore from a sealed distributed commit
    read) and ``ef_digest`` (of the restored residuals); a saved one,
    ``ckpt`` and ``dist_ckpt``
    (``save_and_restore``), and ``lost`` (``lose_and_restore``).  A run
    with ``"env"`` whose trainer wrote this rank's runtime digest adds
    ``digest`` (the file) and ``comm_buckets`` (the attributes of the comm
    scope's bucket-chain spans, from the flight recorder)."""
    out: Dict[str, Any] = {"rank": group.rank, "world": group.world,
                           "backend": group.backend, "runs": {}}
    for run in spec["runs"]:
        run_spec = dict(spec, **run.get("spec", {}))
        with env(run.get("env", {})):
            trainer, batch = build_trainer(group, run_spec, run)
            record = new_record()
            if "resume" in run:
                state = resume(trainer, group, run["resume"], record)
            else:
                state = trainer.create_state()
            flight_recorder.recorder().reset()
            state = train_steps(trainer, state, batch, run["steps"], group,
                                record)
            if "env" in run:
                telemetry_record(record)
        on_mesh = trainer.mesh is not None
        if on_mesh:
            record["shape"] = mesh_shape(trainer.mesh)
            record["coord"] = dict(zip(trainer.mesh.mesh_dim_names,
                                       trainer.mesh.get_coordinate()))
            record["axes"] = {k: sharding_axes(v) for k, v in
                              trainer.state_placements(state).items()}
            record["local_shapes"] = {n: tuple(p.shape)
                                      for n, p in state.params.items()}
            params = trainer.full_params(state)  # collective
        else:
            record["summary"] = trainer.grad_sync_summary()
            params = state.params
        if spec.get("return_params") and group.rank == 0:
            record["params"] = {n: p.detach().cpu().numpy().copy()
                                for n, p in params.items()}
        del params
        if "save" in run:
            record["ckpt"] = save_and_restore(trainer, state, batch, group,
                                              run["save"])
        if "dist_save" in run:
            record["dist_ckpt"] = save_and_restore(
                trainer, state, batch, group, run["dist_save"], dist=True)
        if "lose" in run:
            record["lost"] = lose_and_restore(trainer, state, batch, group,
                                              run["lose"])
        out["runs"][run["name"]] = record
        trainer.close()
        del trainer, state
    return out


def build_trainer(group: DpGroup, run_spec: Dict[str, Any],
                  run: Dict[str, Any]):
    """``(trainer, batch)`` of one run of ``train_worker``: the model and
    ``Trainer`` on the run's mesh or over the dp group, and what this rank
    computes on of its rows.  Empties the card's cache and resets its peak
    memory first."""
    from dlrover_tpu_torch.trainer.optim import create_optimizer
    from dlrover_tpu_torch.trainer.train import Trainer

    device = group.device
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    place = (dict(mesh=build_mesh(MeshConfig.from_dict(run["axes"]),
                                  device=device)) if "axes" in run else
             dict(grad_sync=collectives.GradSyncPolicy(**run["policy"]),
                  dp_group=group))
    model = make_model(run_spec, device, run.get("model"))
    trainer = Trainer(
        model, create_optimizer(**run_spec["optimizer"]),
        loss_fn=make_loss(run_spec, model),
        grads_dtype=run.get("grads_dtype", run_spec.get("grads_dtype")),
        grad_accum_steps=run.get("grad_accum", 1), device=device,
        **place)
    return trainer, trainer.shard_batch(
        trainer.rows_of_global_batch(run_spec["batch"]))


def new_record() -> Dict[str, Any]:
    return {"loss": [], "grad_norm": [], "step_s": [], "launches": [],
            "flash_launches": [], "params_agree": []}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_steps(trainer, state, batch, steps: int, group: DpGroup,
                record: Dict[str, Any]):
    """``steps`` train steps, each appended to ``record`` (losses, grad
    norms, step seconds, kernel launches and, over a dp group, whether
    every rank's params are bit-identical); returns the state.  Records
    the peak device memory."""
    device = group.device
    for _ in range(steps):
        reset_launch_counts()
        fa.reset_launches()
        _sync(device)
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        loss = metrics["loss"].item()
        grad_norm = metrics["grad_norm"].item()
        _sync(device)
        record["step_s"].append(time.perf_counter() - t0)
        record["launches"].append(launch_counts())
        record["flash_launches"].append(dict(fa.launches))
        record["loss"].append(loss)
        record["grad_norm"].append(grad_norm)
        if trainer.mesh is None:
            sums = group.all_gather(torch.tensor(
                [params_checksum(state.params)], dtype=torch.int64,
                device=device))
            record["params_agree"].append(
                bool((sums == sums[0]).all().item()))
    record["peak_mem_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else None)
    return state


# -- the flash checkpoint across ranks ---------------------------------------


def state_copy(state) -> Dict[str, Any]:
    """Every leaf of ``state`` by path: tensors cloned where they live."""
    return {p: v.detach().clone() if torch.is_tensor(v) else v
            for p, v in flatten_with_path(state)}


def state_equal(state, want: Dict[str, Any]) -> bool:
    """Whether ``state`` holds exactly the leaves of ``want``
    (``torch.equal`` per tensor)."""
    got = dict(flatten_with_path(state))
    return got.keys() == want.keys() and all(
        torch.equal(v, want[p]) if torch.is_tensor(v) else v == want[p]
        for p, v in got.items())


def ef_digest(ef) -> Dict[str, List[float]]:
    """``{leaf: [projection, squared norm]}`` of error-feedback residuals,
    in fp64: the projection on a seeded normal vector of the leaf's size
    (drawn on the residual's device, the same for a leaf name on every
    rank and in every run), linear in the residual, so that the sums of
    two sets of ranks' projections agree when their residuals sum to the
    same leaf."""
    out = {}
    for name, t in sorted((ef or {}).items()):
        gen = torch.Generator(device=t.device).manual_seed(
            zlib.crc32(name.encode()))
        w = torch.randn(t.numel(), generator=gen, device=t.device,
                        dtype=torch.float32)
        x = t.detach().reshape(-1).double()
        out[name] = [float((x * w.double()).sum().item()),
                     float((x * x).sum().item())]
    return out


def resume(trainer, group: DpGroup, where: Dict[str, str],
           record: Dict[str, Any]):
    """``Trainer.load_state`` from ``where["dir"]`` in a scope of its own
    (``where["scope"]``: no shm of the saving run, so from storage);
    records the step, the seconds and the restored residuals' digest, and
    returns the state.  Raises when nothing restores."""
    from dlrover_tpu_torch.trainer.flash_checkpoint import Checkpointer

    ckpt = Checkpointer(where["dir"], scope=where["scope"],
                        device=group.device)
    try:
        _sync(group.device)
        t0 = time.perf_counter()
        state, step = trainer.load_state(ckpt)
        _sync(group.device)
        record["restore_s"] = time.perf_counter() - t0
        record["read_stats"] = dict(ckpt.engine.last_read_stats)
    finally:
        ckpt.engine.unlink_memory()
        ckpt.close()
    if state is None:
        raise RuntimeError(f"nothing to resume from in {where['dir']}")
    record["resumed_step"] = step
    record["ef_digest"] = ef_digest(state.ef_residual)
    return state


def telemetry_record(record: Dict[str, Any]) -> None:
    """Add this rank's runtime digest file (when the trainer wrote one)
    and the comm scope's bucket-chain spans to ``record``."""
    path = (envs.get_str(ConfigPath.ENV_RUNTIME_METRICS)
            + f".rank{torch.distributed.get_rank()}")
    if os.path.exists(path):
        with open(path) as f:
            record["digest"] = json.load(f)
        record["comm_buckets"] = [
            dict(span["attrs"]) for span in flight_recorder.recorder().spans
            if span["name"].startswith("comm.bucket")]


@contextlib.contextmanager
def env(values: Dict[str, str]):
    """The env vars ``values`` set while the block runs."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def knob(name: str, on: bool):
    """The boolean knob ``name`` set to ``on`` while the block runs (the
    engine reads its knobs when it is made)."""
    return env({name: "1" if on else "0"})


def dist_persist(on: bool):
    """``DLROVER_TPU_DIST_PERSIST`` set to ``on`` while the block runs."""
    return knob("DLROVER_TPU_DIST_PERSIST", on)


def save_and_restore(trainer, state, batch, group: DpGroup,
                     where: Dict[str, str], dist: bool = False
                     ) -> Dict[str, Any]:
    """The flash checkpoint of this rank's state, held to the state saved.

    An async memory save, staged, and an async storage save of ``state``
    into ``where["dir"]`` (scope ``where["scope"]``) and the exit barrier;
    then one step of the saved state (``next``: the uninterrupted run's
    next step), a restore from shm into a fresh state of the trainer and
    one step of it (``shm``), and a restore from storage (a fresh scope,
    so no shm) and one step of it (``storage``).  Every rank calls it.
    Returns the seconds each save blocked and each restore took, whether
    each restore equals (``torch.equal``, leaf by leaf) a copy taken where
    the state lives at the save, the steps restored, each step's
    ``train_steps`` record under ``next``, ``shm`` and ``storage``, and
    the saved residuals' digest.  Unlinks every segment it made.

    ``dist``: the storage save takes the distributed persist (the
    engines are made under ``DLROVER_TPU_DIST_PERSIST=1``); adds
    ``hosts``, every rank's write stats from the sealed manifest
    (``bytes_written`` ...), ``unique_bytes``, the bytes of one copy of
    the state's distinct boxes over every rank's layout, ``sealed_step``,
    and ``read_stats`` of the storage restore (``bytes_read``,
    ``bytes_total``)."""
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        Checkpointer,
        StorageType,
    )

    device, step = group.device, int(state.step)
    out: Dict[str, Any] = {"step": step,
                           "ef_digest": ef_digest(state.ef_residual)}
    want = state_copy(state)
    with dist_persist(dist):
        ckpt = Checkpointer(where["dir"], scope=where["scope"],
                            device=device)
        fresh = Checkpointer(where["dir"], scope=where["scope"] + "_fresh",
                             device=device)
    try:
        out["memory_save_s"] = ckpt.save_checkpoint(
            step, state, StorageType.MEMORY, trainer=trainer)
        # staged before the storage save, whose blocking time would else
        # hold the wait for the device-copy slot
        ckpt.wait_latest_checkpoint(timeout=600)
        out["blocking_save_s"] = ckpt.save_checkpoint(
            step, state, StorageType.DISK, trainer=trainer)
        out["persisted"] = ckpt.wait_latest_checkpoint(timeout=600)
        # process 0 commits the step once every process persisted its part
        group.all_reduce(torch.zeros(1, device=device))
        if dist:
            out.update(dist_write_record(trainer, state, where["dir"], step,
                                         group.world))
        out["next"] = new_record()
        train_steps(trainer, state, batch, 1, group, out["next"])
        for name, source in (("shm", ckpt), ("storage", fresh)):
            _sync(device)
            t0 = time.perf_counter()
            restored, got = source.load_checkpoint(trainer.create_state(),
                                                   trainer=trainer)
            _sync(device)
            out[f"restore_{name}_s"] = time.perf_counter() - t0
            out[f"{name}_step"] = got
            out[f"{name}_equal"] = (restored is not None
                                    and state_equal(restored, want))
            if dist and name == "storage":
                out["read_stats"] = dict(source.engine.last_read_stats)
            if restored is not None:
                out[name] = new_record()
                train_steps(trainer, restored, batch, 1, group, out[name])
            del restored
    finally:
        for c in (ckpt, fresh):
            c.engine.unlink_memory()
            c.close()
    return out


def lose_and_restore(trainer, state, batch, group: DpGroup,
                     where: Dict[str, str]) -> Dict[str, Any]:
    """A rank loses its snapshot after a memory save, and every rank
    restores it from its peers' memory.

    ``where["mode"]``: ``"replica"`` (``Checkpointer(replica=True)``: the
    save ends in the replica exchange, and the lost rank's segment comes
    back from its successor's backup through the engine's retry) or
    ``"peer"`` (``DLROVER_TPU_PEER_RESTORE=1``: the lost rank is refilled
    from its peers' endpoints through the broker over the world's store).
    Every rank makes a memory save of ``state`` (scope ``where["scope"]``)
    and trains one step from it (``next``, the uninterrupted step); then
    the last rank, as a replacement process would, closes its
    checkpointer, unlinks its segment and its backup and opens a fresh
    one, and every rank restores into a fresh state and trains one step
    (``restored``).  Returns the save's blocking seconds (with the
    exchange) and the exchange's record, the restore's seconds, step and
    whether it equals a copy taken at the save (``torch.equal``, leaf by
    leaf), the peer recovery's report (``{}`` on a rank that fetched
    nothing), the synchronous save's two phases (``sync_phases``, empty
    after an async one) and the steps' records.  Every segment it made is unlinked."""
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        Checkpointer,
        StorageType,
    )

    mode = where["mode"]
    device, step = group.device, int(state.step)
    lost = group.rank == group.world - 1
    out: Dict[str, Any] = {"step": step, "mode": mode, "lost": lost}
    want = state_copy(state)

    def checkpointer():
        with knob("DLROVER_TPU_PEER_RESTORE", mode == "peer"):
            return Checkpointer(where["dir"], scope=where["scope"],
                                replica=mode == "replica", device=device)

    ckpt = checkpointer()
    try:
        _sync(device)
        out["blocking_save_s"] = ckpt.save_checkpoint(
            step, state, StorageType.MEMORY, trainer=trainer)
        ckpt.wait_latest_checkpoint(timeout=600)
        out["save_paths"] = list(ckpt.engine.save_paths)
        out["sync_phases"] = dict(ckpt.engine.last_sync_phases)
        replica = ckpt.engine.replica
        out["exchange"] = dict(replica.last_exchange) if replica else {}
        out["next"] = new_record()
        train_steps(trainer, state, batch, 1, group, out["next"])
        if lost:
            ckpt.engine.unlink_memory()
            ckpt.close()
            ckpt = checkpointer()
        _sync(device)
        t0 = time.perf_counter()
        restored, got = ckpt.load_checkpoint(trainer.create_state(),
                                             trainer=trainer)
        _sync(device)
        out["restore_s"] = time.perf_counter() - t0
        out["restored_step"] = got
        out["equal"] = restored is not None and state_equal(restored, want)
        out["recovery"] = dict(ckpt.engine.last_recovery)
        if restored is not None:
            out["restored"] = new_record()
            train_steps(trainer, restored, batch, 1, group, out["restored"])
        del restored
        # no rank drops its segment while a peer may still read it
        group.all_reduce(torch.zeros(1, device=device))
    finally:
        ckpt.engine.unlink_memory()
        ckpt.close()
    return out


def dist_write_record(trainer, state, ckpt_dir: str, step: int,
                      world: int) -> Dict[str, Any]:
    """What a sealed distributed commit of ``state`` wrote: every rank's
    write stats (``hosts``, from the sealed manifest), the bytes of one
    copy of the state's distinct boxes over the ranks' layouts
    (``unique_bytes``), the bytes of this rank's local tensors, which the
    legacy persist writes (``local_bytes``), and the committed step."""
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        distributed,
        snapshot,
    )

    manifest = distributed.read_manifest(ckpt_dir, step) or {}
    layouts = [trainer.state_layout(state, rank=r) for r in range(world)]
    boxes = set()
    unique = 0
    for leaf in snapshot.plan_shards(state, layouts[0]):
        itemsize = snapshot.torch_dtype(leaf["dtype"]).itemsize
        for r in range(world):
            box = distributed.box_of(layouts[r], leaf["path"],
                                      leaf["gshape"])
            key = distributed.shard_key(leaf["path"], box)
            if key not in boxes:
                boxes.add(key)
                unique += itemsize * math.prod(b - a for a, b in box)
    return {"hosts": manifest.get("hosts", {}), "unique_bytes": unique,
            "local_bytes": snapshot.snapshot_nbytes(
                snapshot.plan_shards(state)),
            "sealed_step": distributed.read_committed_step(ckpt_dir)}


def reduce_scatter_worker(group: DpGroup,
                          cases: List[Dict[str, Any]]) -> List[Dict]:
    """For each case (``policy`` kwargs, ``transport`` and ``payload``, a
    ``(world, world, width)`` numpy array whose row ``r`` is rank ``r``'s
    bucket buffer): this rank's shard row and residual from
    ``bucket_reduce_scatter``, the tier it resolved to and the ring
    kernels' launches."""
    results = []
    for case in cases:
        policy = collectives.GradSyncPolicy(**case["policy"])
        buf = torch.from_numpy(case["payload"][group.rank]).to(group.device)
        reset_launch_counts()
        shard, resid = collectives.bucket_reduce_scatter(
            buf, policy, group, case.get("transport"))
        results.append({
            "shard": shard.cpu().numpy(),
            "residual": None if resid is None else resid.cpu().numpy(),
            "transport": ring.resolve_transport(
                policy, group.world, buf.shape[1],
                request=case.get("transport")),
            "launches": launch_counts(),
        })
    return results


def peer_window_worker(group: DpGroup, spec: Dict[str, Any]) -> Dict:
    """Build a ``PeerWindow`` over the group, copy a row of ``spec["width"]``
    (at most the window's slots) seeded with ``spec["seed"] + rank`` into
    the right neighbour's slots through the opened handle, wait for every
    rank, and compare this rank's slots with the left neighbour's row.
    Copies only: no kernel waits on another process."""
    window = PeerWindow(group)
    width = min(spec["width"], window.slot_elems)

    def row(rank):
        rng = np.random.default_rng(spec["seed"] + rank)
        return torch.from_numpy(
            rng.standard_normal(width).astype(np.float32)).to(group.device)

    try:
        window.write_right_slots(row(group.rank))
        group.all_reduce(torch.zeros(1, device=group.device))
        got = window.read_slots(width)
        want = row(window.left_rank)
        result = {"rank": group.rank, "equal": bool(torch.equal(got, want)),
                  "max_abs_err": (got - want).abs().max().item(),
                  "window_bytes": window.window_bytes, "ctas": window.ctas,
                  "width": width}
    finally:
        window.close()
    return result
