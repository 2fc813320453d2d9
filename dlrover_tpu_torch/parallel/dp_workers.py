"""What each rank process runs: the dp grad sync driven end to end.

``process_group.spawn`` starts one process per rank and calls one of these
functions in each; they live in the package so that a rank imports torch
and the port only.  ``train_worker`` drives ``Trainer`` through a list of
sync modes from the same start (``chip_smoke.py`` on the card, the CPU
tests at a tiny size); ``reduce_scatter_worker`` drives
``collectives.bucket_reduce_scatter`` on given payloads;
``peer_window_worker`` builds a ``PeerWindow`` and moves one row to each
right neighbour through it.
"""

import dataclasses
import time
from typing import Any, Dict, List

import numpy as np
import torch

from dlrover_tpu_torch.ops.cuda import flash_attention as fa
from dlrover_tpu_torch.ops.cuda import rdma_ring
from dlrover_tpu_torch.ops.cuda import ring_reduce_scatter as ring
from dlrover_tpu_torch.parallel import collectives
from dlrover_tpu_torch.parallel.peer_memory import PeerWindow
from dlrover_tpu_torch.parallel.process_group import DpGroup


def _local_rows(batch: Dict[str, np.ndarray], group: DpGroup):
    """This rank's contiguous slice of the global batch (the data axis
    sharding of the JAX trainer)."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0] // group.world
        out[k] = v[group.rank * n:(group.rank + 1) * n]
    return out


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


def train_worker(group: DpGroup, spec: Dict[str, Any]) -> Dict[str, Any]:
    """Run ``spec["runs"]`` one after the other, each from the same start.

    ``spec``: ``model`` (``LlamaConfig`` fields, over the ``preset``'s
    when one is named), ``state_dict`` (numpy, or None for the model's
    own seeded init from ``seed``), ``batch`` (the global numpy batch; this
    rank takes its rows), ``optimizer`` (``create_optimizer`` kwargs),
    ``grads_dtype``, ``runs`` (``{"name", "policy", "steps"}`` with
    ``GradSyncPolicy`` kwargs) and ``return_params``.

    Returns, per run: losses, grad norms, step seconds (on the host clock,
    after a device synchronize), the ring and flash kernels' launches per
    step, whether every rank's params were bit-identical after every step,
    the sync summary, peak device memory and, on rank 0 with
    ``return_params``, the final params."""
    from dlrover_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from dlrover_tpu_torch.trainer.optim import create_optimizer
    from dlrover_tpu_torch.trainer.train import Trainer

    device = group.device
    preset = spec.get("preset")
    cfg = (dataclasses.replace(getattr(LlamaConfig, preset)(), **spec["model"])
           if preset else LlamaConfig(**spec["model"]))
    batch = _local_rows(spec["batch"], group)
    out: Dict[str, Any] = {"rank": group.rank, "runs": {}}
    for run in spec["runs"]:
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        model = LlamaForCausalLM(cfg, device=device, seed=spec.get("seed", 0))
        if spec.get("state_dict") is not None:
            model.load_state_dict({k: torch.from_numpy(v) for k, v in
                                   spec["state_dict"].items()})
        trainer = Trainer(
            model, create_optimizer(**spec["optimizer"]),
            grads_dtype=spec.get("grads_dtype"),
            grad_sync=collectives.GradSyncPolicy(**run["policy"]),
            dp_group=group, device=device)
        state = trainer.create_state()
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
            sums = group.all_gather(torch.tensor(
                [params_checksum(state.params)], dtype=torch.int64,
                device=device))
            record["params_agree"].append(
                bool((sums == sums[0]).all().item()))
        record["summary"] = trainer.grad_sync_summary()
        record["peak_mem_bytes"] = (torch.cuda.max_memory_allocated(device)
                                    if device.type == "cuda" else None)
        if spec.get("return_params") and group.rank == 0:
            record["params"] = {n: p.detach().cpu().numpy().copy()
                                for n, p in state.params.items()}
        out["runs"][run["name"]] = record
        trainer.close()
        del trainer, state, model
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
