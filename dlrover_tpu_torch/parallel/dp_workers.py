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

import dataclasses
import time
from typing import Any, Dict, List

import numpy as np
import torch
from torch.distributed.tensor import Shard

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
    spec's, and ``"spec"``, keys that replace the spec's for this run
    (another ``family``, ``preset`` or ``state_dict``).

    Returns, per run: losses, grad norms, step seconds (on the host clock,
    after a device synchronize), the ring and flash kernels' launches per
    step, peak device memory and, on rank 0 with ``return_params``, the
    final params (gathered whole on a mesh).  A dp run adds whether every
    rank's params were bit-identical after every step and the sync
    summary; a mesh run adds the mesh's shape, each parameter's local
    shape and the sharding axes of each param and moment leaf."""
    from dlrover_tpu_torch.trainer.optim import create_optimizer
    from dlrover_tpu_torch.trainer.train import Trainer

    device = group.device
    out: Dict[str, Any] = {"rank": group.rank, "world": group.world,
                           "backend": group.backend, "runs": {}}
    for run in spec["runs"]:
        run_spec = dict(spec, **run.get("spec", {}))
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        on_mesh = "axes" in run
        place = (dict(mesh=build_mesh(MeshConfig.from_dict(run["axes"]),
                                      device=device)) if on_mesh else
                 dict(grad_sync=collectives.GradSyncPolicy(**run["policy"]),
                      dp_group=group))
        model = make_model(run_spec, device, run.get("model"))
        trainer = Trainer(
            model, create_optimizer(**run_spec["optimizer"]),
            loss_fn=make_loss(run_spec, model),
            grads_dtype=run.get("grads_dtype", run_spec.get("grads_dtype")),
            grad_accum_steps=run.get("grad_accum", 1), device=device,
            **place)
        state = trainer.create_state()
        batch = trainer.shard_batch(run_spec["batch"])
        record = {"loss": [], "grad_norm": [], "step_s": [],
                  "launches": [], "flash_launches": [], "params_agree": []}
        for _ in range(run["steps"]):
            reset_launch_counts()
            fa.reset_launches()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            state, metrics = trainer.train_step(state, batch)
            loss = metrics["loss"].item()
            grad_norm = metrics["grad_norm"].item()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            record["step_s"].append(time.perf_counter() - t0)
            record["launches"].append(launch_counts())
            record["flash_launches"].append(dict(fa.launches))
            record["loss"].append(loss)
            record["grad_norm"].append(grad_norm)
            if not on_mesh:
                sums = group.all_gather(torch.tensor(
                    [params_checksum(state.params)], dtype=torch.int64,
                    device=device))
                record["params_agree"].append(
                    bool((sums == sums[0]).all().item()))
        record["peak_mem_bytes"] = (torch.cuda.max_memory_allocated(device)
                                    if device.type == "cuda" else None)
        if on_mesh:
            record["shape"] = mesh_shape(trainer.mesh)
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
        out["runs"][run["name"]] = record
        trainer.close()
        del trainer, model, state, params
    return out


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
    """Build a ``PeerWindow`` of ``spec["width"]`` over the group, copy a
    row seeded with ``spec["seed"] + rank`` into the right neighbour's slot
    0 through the opened handle, wait for every rank, and compare this
    rank's slot with the left neighbour's row.  Copies only: no kernel
    waits on another process."""
    width = spec["width"]

    def row(rank):
        rng = np.random.default_rng(spec["seed"] + rank)
        return torch.from_numpy(
            rng.standard_normal(width).astype(np.float32)).to(group.device)

    window = PeerWindow(group, width)
    try:
        window.write_right_slot(row(group.rank), 0)
        group.all_reduce(torch.zeros(1, device=group.device))
        got = window.read_slot(0, width)
        want = row(window.left_rank)
        result = {"rank": group.rank, "equal": bool(torch.equal(got, want)),
                  "max_abs_err": (got - want).abs().max().item(),
                  "window_bytes": window.window_bytes, "ctas": window.ctas}
    finally:
        window.close()
    return result
