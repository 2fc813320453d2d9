"""Pipeline parallelism over the ``pp`` mesh axis: the GPipe schedule.

Port of ``dlrover_tpu/parallel/pipeline.py``.  The reference runs one
program on every pp rank under ``shard_map``: a ``lax.scan`` over
``M + P - 1`` ticks in which stage 0 reads fresh microbatches, rank ``r``
works on microbatch ``t - r``, ``ppermute`` moves each output one stage
on, bubble ticks compute on stale data masked to zero, the last stage
collects, and a ``psum`` over pp gives every rank the output.  Its
gradient is ``jax.grad`` through that scan.

Here one rank is one process, so the schedule is each rank's own loop:
for each microbatch in order, stage 0 takes it from ``x`` and every other
stage receives it from the stage before (``DpGroup.recv``), runs its
layers and sends the result on (``DpGroup.send``).  The ticks emerge from
the blocking exchanges, rank ``r`` working on microbatch ``t - r``; a
bubble is a rank waiting, so nothing is computed or masked there.  The
last stage's outputs, zeros elsewhere, are summed over pp, so every pp
rank holds the output; in the backward that sum is an identity (as
``reduce_from_tp``'s), and the last stage takes the gradient as it is.

The whole schedule is one ``autograd.Function``: the forward keeps each
microbatch's graph (the stage's own remat inside it), and the backward
walks the microbatches in reverse on every rank, receives the output's
gradient from the next stage (the last stage reads its own), backpropagates
the stage with ``torch.autograd.grad`` and sends the input's gradient to
the previous stage.  So every exchange of the backward is an explicit
call in one fixed order on every rank: none hangs on a graph branch
autograd would skip (a bubble's, or the input rank 0 never reads).

Parameters reach the gradient through the function's inputs: the
tensors of this rank's stage (``staged_params[pp rank]``: a tensor's
slice along its leading stage dim, or a sequence's entry, modules
allowed), so their gradients come back to them and to nothing else; every
other stage's gradient is zero here and is the owning rank's to produce.
"""

from typing import Any, Callable, List

import torch
from torch import nn

from dlrover_tpu_torch.parallel.mesh import axis_group


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a stage that need a gradient: leaves, and the
    parameters of modules."""
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.requires_grad else []
    if isinstance(tree, nn.Module):
        return [p for p in tree.parameters() if p.requires_grad]
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in _tensors(item)]
    return []


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, stage, group, M: int, x, *params):
        r, last = group.rank, group.world - 1
        mbs = x.chunk(M)
        inputs, outputs = [], []
        for m in range(M):
            x_in = mbs[m] if r == 0 else group.recv(mbs[m], r - 1)
            x_in = x_in.detach().requires_grad_()
            with torch.enable_grad():
                y = stage_fn(stage, x_in)
            if r < last:
                group.send(y.detach(), r + 1)
            inputs.append(x_in)
            outputs.append(y)
        collected = (torch.cat([y.detach() for y in outputs]) if r == last
                     else torch.zeros_like(x))
        ctx.group, ctx.M, ctx.params = group, M, params
        ctx.inputs, ctx.outputs = inputs, outputs
        return group.all_reduce(collected)  # the psum over pp

    @staticmethod
    def backward(ctx, grad):
        group, M, params = ctx.group, ctx.M, ctx.params
        r, last = group.rank, group.world - 1
        grads_out = grad.chunk(M)
        grads_in: List[Any] = [None] * M
        param_grads: List[Any] = [None] * len(params)
        for m in reversed(range(M)):
            y = ctx.outputs[m]
            g = grads_out[m] if r == last else group.recv(y, r + 1)
            got = torch.autograd.grad(y, [ctx.inputs[m], *params], g,
                                      allow_unused=True)
            if r > 0:
                group.send(got[0], r - 1)
            else:
                grads_in[m] = got[0]
            for i, pg in enumerate(got[1:]):
                if pg is not None:
                    param_grads[i] = (pg if param_grads[i] is None
                                      else param_grads[i] + pg)
            ctx.outputs[m] = ctx.inputs[m] = None  # free the graph
        grad_x = torch.cat(grads_in) if r == 0 else None
        return (None, None, None, None, grad_x, *param_grads)


def pipeline_apply(stage_fn: Callable, mesh, num_microbatches: int,
                   axis_name: str = "pp") -> Callable:
    """Build a pipelined apply: ``(staged_params, x) -> y``.

    ``stage_fn(stage_params, x_mb) -> y_mb`` applies ONE stage's layers to
    one microbatch (shapes preserved).  ``staged_params`` holds every
    stage (a tensor with a leading ``num_stages`` dim, or a sequence of
    per-stage entries; ``stage_params`` makes either);
    this rank runs entry ``pp rank``.  ``x`` is this rank's rows of the
    batch (the reference's ``data_axis`` names the axis its shard_map
    splits ``x`` over; a port rank holds its own rows, ``shard_batch``),
    ``[B, ...]`` with B divisible by ``num_microbatches``; each data rank
    pipelines its own rows.  Every pp rank returns ``y`` for those rows.
    Collective over the mesh's ``axis_name`` group."""
    if num_microbatches < 1:
        raise ValueError(f"num_microbatches must be >= 1: {num_microbatches}")
    group = axis_group(mesh, axis_name)

    def apply(staged_params, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % num_microbatches:
            raise ValueError(f"{x.shape[0]} rows do not split into "
                             f"{num_microbatches} microbatches")
        stage = staged_params[group.rank]
        return _Pipeline.apply(stage_fn, stage, group, num_microbatches, x,
                               *_tensors(stage))

    return apply


def stage_params(params, num_stages: int):
    """Split per-layer params into ``num_stages`` stages: a tensor's
    leading ``L`` dim into ``[num_stages, L / num_stages, ...]``, a
    sequence of ``L`` layers into ``num_stages`` lists of ``L /
    num_stages``."""
    L = len(params)
    if L % num_stages:
        raise ValueError(
            f"{L} layers not divisible by {num_stages} pipeline stages")
    if isinstance(params, torch.Tensor):
        return params.reshape(num_stages, L // num_stages, *params.shape[1:])
    per = L // num_stages
    return [list(params[s * per:(s + 1) * per]) for s in range(num_stages)]


def microbatch_efficiency(num_microbatches: int, num_stages: int) -> float:
    """GPipe utilization bound M/(M+P-1)."""
    return num_microbatches / (num_microbatches + num_stages - 1)
