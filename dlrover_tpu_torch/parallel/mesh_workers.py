"""What a worker runs around the mesh path.

``bootstrap_worker(spec)`` runs under ``process_group.launch``, which sets
the environment the agent would set: it initialises the group itself
through ``trainer/bootstrap.init`` and then trains the mesh runs of
``spec["runs"]`` with ``dp_workers.train_worker`` (``process_group.spawn``
calls that directly, one process per rank over a ``FileStore``).
``reference_losses`` is the plain one-device run a mesh run is held
against; ``collective_probe_worker`` asks the group's backend whether it
carries the collectives FSDP2 calls on the rank's device tensors.
``chip_smoke.py`` drives them on the card, the CPU tests at a tiny size.
"""

import dataclasses
import time
from typing import Any, Dict

import torch
import torch.distributed as dist

from dlrover_tpu_torch.parallel.dp_workers import make_model, train_worker
from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu_torch.parallel.process_group import (
    DpGroup,
    _all_gather,
    _reduce_scatter,
)


def bootstrap_worker(spec: Dict[str, Any]) -> Dict[str, Any]:
    """A worker as the agent starts it: ``bootstrap.init`` from the
    environment (``spec["platform"]``), then ``dp_workers.train_worker``
    over the world it joined; the group is destroyed at the end.  Returns
    the ``WorkerContext`` fields, whether ``torch.distributed`` was
    initialised by ``init`` and its backend, and the training record."""
    from dlrover_tpu_torch.trainer import bootstrap

    ctx = bootstrap.init(platform=spec.get("platform"))
    initialised = dist.is_initialized()
    try:
        device = ("cpu" if spec.get("platform") == "cpu" else
                  torch.device("cuda", torch.cuda.current_device()))
        if not initialised:
            build_mesh(MeshConfig(), device=device)  # the one-rank group
        group = DpGroup(device)
        record = train_worker(group, spec) if spec.get("runs") else {}
        ranks = group.all_gather(torch.tensor([group.rank], device=device))
        return {"context": dataclasses.asdict(ctx),
                "initialised_by_init": initialised,
                "backend": group.backend, "world": group.world,
                "ranks_seen": ranks.flatten().tolist(), "train": record}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def reference_losses(spec: Dict[str, Any], steps: int, device) -> Dict:
    """The same model, optimizer and global batch on one device with no
    mesh, the plain path a mesh run is held against: its losses and step
    seconds (host clock, to the loss's read)."""
    from dlrover_tpu_torch.trainer.optim import create_optimizer
    from dlrover_tpu_torch.trainer.train import Trainer

    trainer = Trainer(make_model(spec, device),
                      create_optimizer(**spec["optimizer"]),
                      grads_dtype=spec.get("grads_dtype"), device=device)
    state = trainer.create_state()
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, spec["batch"])
        losses.append(metrics["loss"].item())  # waits for the step
        step_s.append(time.perf_counter() - t0)
    return {"loss": losses, "step_s": step_s}


def collective_probe_worker(group: DpGroup) -> Dict[str, str]:
    """Whether this group's backend carries, on the rank's device
    tensors, the collectives FSDP2 calls: ``all_gather_into_tensor``
    (unshard), ``reduce_scatter_tensor`` (gradients) and ``all_reduce``
    (HSDP's replicas).  ``{op: "ok" | "wrong values" | the error's first
    line}``: a probe, so an op the backend refuses is a result."""
    dev, world, rank = group.device, group.world, group.rank
    x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
    probes = {
        "all_gather_into_tensor": (
            lambda: _probe_all_gather(x, world),
            torch.cat([torch.arange(4, dtype=torch.float32) + 10 * r
                       for r in range(world)])),
        "reduce_scatter_tensor": (
            lambda: _probe_reduce_scatter(x, world),
            (torch.arange(4, dtype=torch.float32) * world
             + 10 * sum(range(world))).chunk(world)[rank]),
        "all_reduce": (
            lambda: _probe_all_reduce(x),
            torch.arange(4, dtype=torch.float32) * world
            + 10 * sum(range(world))),
    }
    out = {}
    for op, (run, want) in probes.items():
        try:
            got = run()
        except Exception as e:  # noqa: BLE001 - the refusal is the result
            out[op] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
            continue
        out[op] = "ok" if torch.equal(got.cpu(), want) else "wrong values"
    return out


def _probe_all_gather(x, world):
    out = torch.empty(world * x.numel(), dtype=x.dtype, device=x.device)
    _all_gather(out, x)
    return out


def _probe_reduce_scatter(x, world):
    out = torch.empty(x.numel() // world, dtype=x.dtype, device=x.device)
    _reduce_scatter(out, x.clone())
    return out


def _probe_all_reduce(x):
    y = x.clone()
    dist.all_reduce(y)
    return y
