"""What a worker runs around the mesh path.

``bootstrap_worker(spec)`` runs under ``process_group.launch``, which sets
the environment the agent would set: it initialises the group itself
through ``trainer/bootstrap.init`` and then trains the mesh runs of
``spec["runs"]`` with ``dp_workers.train_worker`` (``process_group.spawn``
calls that directly, one process per rank over a ``FileStore``).
``reference_losses`` is the plain one-device run a mesh run is held
against; ``collective_probe_worker`` asks the group's backend whether it
carries the collectives FSDP2 calls on the rank's device tensors;
``ring_check_worker`` holds ring attention over the group (as cp) against
the reference core on the whole sequence, ``ring_flash_check_worker`` the
ring of flash blocks against one-rank flash on the whole sequence.
``pipeline_worker`` trains the pipelined Llama over ``pp`` (and ``dp``)
function-style, as the reference trains its ``PipelinedLlama`` (the
``Trainer`` does not pipeline); ``reference_pipeline`` runs the same
steps on one rank without the pipeline.
``chip_smoke.py`` drives them on the card, the CPU tests at a tiny size.
"""

import dataclasses
import statistics
import time
from typing import Any, Dict

import torch
import torch.distributed as dist

from dlrover_tpu_torch.parallel.dp_workers import (
    make_loss,
    make_model,
    train_worker,
)
from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh, mesh_shape
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
    mesh, the plain path a mesh run is held against: its losses, grad
    norms and step seconds (host clock, to the loss's read)."""
    from dlrover_tpu_torch.trainer.optim import create_optimizer
    from dlrover_tpu_torch.trainer.train import Trainer

    model = make_model(spec, device)
    trainer = Trainer(model, create_optimizer(**spec["optimizer"]),
                      loss_fn=make_loss(spec, model),
                      grads_dtype=spec.get("grads_dtype"), device=device)
    state = trainer.create_state()
    losses, norms, step_s = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, spec["batch"])
        losses.append(metrics["loss"].item())  # waits for the step
        step_s.append(time.perf_counter() - t0)
        norms.append(metrics["grad_norm"].item())
    return {"loss": losses, "grad_norm": norms, "step_s": step_s}


def _function_steps(forward, model, spec, run, sync=None, data=None
                    ) -> Dict[str, Any]:
    """``run["steps"]`` function-style steps of ``model`` (the reference's
    hand-written ``value_and_grad`` + optax step): ``forward(input_ids)``,
    the fp32 cross entropy, ``backward``, ``sync()`` (the pipeline's
    gradient sums), the global norm and the optimizer on the whole state.
    The optimizer is ``adamw`` at the constant rate ``run["adamw_lr"]``
    or, without it, ``create_optimizer(**spec["optimizer"])``.  ``data``:
    the dp group the loss is averaged over.  Returns losses, grad norms,
    step seconds (host clock, after a device synchronize), each step's
    flash launches, the peak device memory and, as ``run`` asks, step 0's
    logits and gradients (numpy)."""
    from dlrover_tpu_torch.ops.cuda import flash_attention as fa
    from dlrover_tpu_torch.trainer import optim
    from dlrover_tpu_torch.trainer.train import cross_entropy_loss

    device = next(model.parameters()).device
    params = dict(model.named_parameters())
    opt = (optim.adamw(lambda count: run["adamw_lr"]) if "adamw_lr" in run
           else optim.create_optimizer(**spec["optimizer"]))
    opt_state = opt.init({n: p.detach() for n, p in params.items()})
    batch = {k: torch.as_tensor(v).to(device) for k, v in run["batch"].items()}
    rec: Dict[str, Any] = {"loss": [], "grad_norm": [], "step_s": [],
                           "flash_launches": []}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for step in range(run["steps"]):
        fa.reset_launches()
        _sync(device)
        t0 = time.perf_counter()
        for p in params.values():
            p.grad = None
        logits = forward(batch["input_ids"])
        loss = cross_entropy_loss(logits, batch["labels"])
        loss.backward()
        if sync is not None:
            sync()
        grads = {n: p.grad for n, p in params.items()}
        norm = optim.global_norm(grads)
        updates, opt_state = opt.update(grads, opt_state, params)
        optim.apply_updates(params, updates)
        loss = loss.detach()
        if data is not None:
            loss = data.all_reduce(loss) / data.world
        rec["loss"].append(loss.item())
        rec["grad_norm"].append(norm.item())
        _sync(device)
        rec["step_s"].append(time.perf_counter() - t0)
        rec["flash_launches"].append(dict(fa.launches))
        if step == 0 and run.get("return_logits"):
            rec["logits"] = logits.detach().cpu().numpy()
        if step == 0 and run.get("return_grads"):
            rec["grads"] = {n: g.cpu().numpy() for n, g in grads.items()}
    rec["peak_mem_bytes"] = (torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else None)
    return rec


def pipeline_worker(group: DpGroup, spec: Dict[str, Any]) -> Dict[str, Any]:
    """Train ``PipelinedLlama`` over the mesh of each of ``spec["runs"]``,
    each from the same start: a run is ``{"name", "axes"`` (``MeshConfig``
    fields with ``pp``), ``"num_microbatches"``, ``"steps"``, ``"batch"``
    (the global numpy batch; this rank takes its rows over dp), and the
    options of ``_function_steps``}``; the Llama is ``make_model(spec)``.
    Returns, per run, ``_function_steps``' record with the mesh's shape
    and this rank's pp and dp coordinates (the logits are this rank's
    rows)."""
    from dlrover_tpu_torch.models.pipeline_llama import PipelinedLlama

    out = {"rank": group.rank, "runs": {}}
    for run in spec["runs"]:
        if group.device.type == "cuda":
            torch.cuda.empty_cache()
        mesh = build_mesh(MeshConfig.from_dict(run["axes"]),
                          device=group.device)
        pipe = PipelinedLlama(make_model(spec, group.device), mesh,
                              run["num_microbatches"])
        rec = _function_steps(pipe, pipe.model, spec,
                              dict(run, batch=pipe.shard_batch(
                                  pipe.rows_of_global_batch(run["batch"]))),
                              sync=pipe.sync_grads, data=pipe.dp)
        rec.update(shape=mesh_shape(mesh), pp_rank=pipe.pp.rank,
                   dp_rank=0 if pipe.dp is None else pipe.dp.rank)
        out["runs"][run["name"]] = rec
        del pipe, mesh
    return out


def reference_pipeline(spec: Dict[str, Any], run: Dict[str, Any],
                       device) -> Dict[str, Any]:
    """``run``'s steps on one rank with the unpipelined
    ``LlamaForCausalLM``: the same weights, batch and step as
    ``pipeline_worker``'s."""
    model = make_model(spec, device)
    return _function_steps(model, model, spec, run)


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


def ring_check_worker(group: DpGroup, spec: Dict[str, Any]) -> Dict:
    """Ring attention over ``group`` as the cp axis against
    ``reference_attention`` on the whole sequence, per dtype of
    ``spec["dtypes"]``: seeded q, k, v of ``spec["shape"]`` ([B, S, H, D],
    made whole on every rank from ``spec["seed"]``), this rank's chunk
    through the ring (causal), its rows of the reference.  Returns, per
    dtype, the largest absolute difference and the ring's forward seconds
    (host clock around a synchronized call)."""
    from dlrover_tpu_torch.ops.attention import reference_attention
    from dlrover_tpu_torch.ops.ring_attention import ring_attention

    dev = group.device
    B, S, H, D = spec["shape"]
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    whole = [torch.randn(B, S, H, D, generator=gen, device=dev)
             for _ in range(3)]
    rows = slice(group.rank * S // group.world,
                 (group.rank + 1) * S // group.world)
    mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    out = {}
    for name in spec["dtypes"]:
        dtype = getattr(torch, name)
        q, k, v = (t.to(dtype) for t in whole)
        want = reference_attention(q, k, v, mask[None, None])[:, rows]
        _sync(dev)
        t0 = time.perf_counter()
        got = ring_attention(q[:, rows], k[:, rows], v[:, rows], group,
                             causal=True)
        _sync(dev)
        out[name] = dict(
            max_abs_err=(got.float() - want.float()).abs().max().item(),
            ring_s=time.perf_counter() - t0, finite=bool(
                torch.isfinite(got).all().item()))
    return out


def ring_flash_check_worker(group: DpGroup, spec: Dict[str, Any]) -> Dict:
    """``ring_flash_attention`` over ``group`` as the cp axis against the
    one-rank flash of ``FlashAttention`` on the whole sequence, causal:
    seeded q, k, v and output cotangent of ``spec["shape"]`` ([B, S, H,
    D], ``spec["dtype"]``, made whole on every rank from ``spec["seed"]``),
    this rank's chunk through the ring forward and backward, its rows of
    the whole.  Returns per output (out, dq, dk, dv) the largest absolute
    error, the whole's largest magnitude, the largest relative error
    ||ring - whole||_F / ||whole||_F on a tile of ``spec["tile"]``
    sequence positions and whether it is finite; the flash launches of the
    ring's forward and backward; and the median seconds of
    ``spec["iters"]`` forward-and-backward calls (host clock, the device
    synchronized) of the ring, and on rank 0 alone (the others wait) of
    one-rank flash on the whole sequence."""
    from dlrover_tpu_torch.ops.cuda import flash_attention as fa
    from dlrover_tpu_torch.ops.ring_attention import ring_flash_attention

    dev = group.device
    B, S, H, D = spec["shape"]
    dtype = getattr(torch, spec["dtype"])
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    q, k, v, dout = (torch.randn(B, S, H, D, generator=gen, device=dev)
                     .to(dtype) for _ in range(4))
    rows = slice(group.rank * S // group.world,
                 (group.rank + 1) * S // group.world)
    chunks = [t[:, rows].contiguous() for t in (q, k, v, dout)]

    def run(fn, q_, k_, v_, dout_):
        xs = [t.detach().clone().requires_grad_() for t in (q_, k_, v_)]
        out = fn(*xs)
        out.backward(dout_)
        return (out.detach(), *(t.grad for t in xs))

    def one_rank():
        return run(lambda *t: fa.FlashAttention.apply(*t, True),
                   q, k, v, dout)

    def ring():
        return run(lambda *t: ring_flash_attention(*t, group, causal=True),
                   *chunks)

    want = [t[:, rows] for t in one_rank()]
    _sync(dev)
    fa.reset_launches()
    got = ring()
    _sync(dev)
    launches = dict(fa.launches)
    errors = {}
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        diff, b = a.float() - b.float(), b.float()
        errors[name] = dict(
            max_abs_err=diff.abs().max().item(), max_abs=b.abs().max().item(),
            rel_err=max((d.norm() / w.norm()).item() for d, w in zip(
                diff.split(spec["tile"], dim=1),
                b.split(spec["tile"], dim=1))),
            finite=bool(torch.isfinite(a).all().item()))

    def median_s(fn):
        times = []
        for _ in range(spec["iters"]):
            _sync(dev)
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    ring_s = median_s(ring)
    one_rank_s = median_s(one_rank) if group.rank == 0 else None
    group.all_reduce(torch.zeros(1, device=dev))  # rank 0's timing ends
    return dict(errors=errors, launches=launches, ring_s=ring_s,
                one_rank_s=one_rank_s)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
