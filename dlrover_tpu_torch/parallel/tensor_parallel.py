"""Tensor parallelism over the mesh's ``tp`` axis, Megatron-style.

In JAX, GSPMD splits the heads, the MLP width and the vocab over ``tp``
from the logical-axis rules and inserts the all-reduces itself.  The port
holds the shards explicitly: the q/k/v, gate and up projections hold
column shards (their output features), o and down hold row shards (their
input features), and the embedding and the LM head hold vocab shards.
Two autograd functions carry the exchange (``parallel/process_group.py``
``DpGroup`` collectives, host-staged on gloo):

* ``copy_to_tp``: identity forward, all-reduce backward (before a column
  shard: each rank's input gradient is a partial sum);
* ``reduce_from_tp``: all-reduce forward, identity backward (after a row
  shard, and for the vocab-parallel lookups and the loss's sums: every
  rank computes the same loss from the reduced value, so each takes its
  gradient as it is).

``vocab_parallel_cross_entropy`` is the next-token loss from vocab-sharded
logits: the row max, the sum of exponentials and the target logit are
each reduced over ``tp``, so no rank ever holds the full logits.

The pair serves any axis whose ranks hold partial sums of one value: the
MoE combine over ``ep`` (``models/moe.py``) uses it too.  Three more
functions carry the other axes' exchanges:

* ``gather_seq``: all-gather along the sequence, reduce-scatter backward
  (the keys and values of reference attention over ``cp``: each rank's
  queries give a gradient for every key, summed on the key's owner);
* ``gather_rows``: all-gather along dim 0, local slice backward (the MoE
  router split over ``ep``: every rank computes the same gradient of the
  whole router, so a shard's gradient is its slice, not a sum);
* ``all_reduce_sum``: all-reduce forward and backward (a batch statistic
  over the data ranks, the MoE aux loss's sums: every rank's loss reads
  the global sum, and the trainer weights each rank's loss so that the
  weights sum to one, so the sum's gradient reaches each rank's own
  terms summed over the ranks).

``slice_to_tp`` serves a replicated tensor read per shard: the bias of a
column shard (GPT's and ViT's Dense biases carry no logical axis, so they
stay whole on every rank, as the reference keeps them): the forward takes
this rank's chunk, the backward all-gathers the chunks' gradients, so
every rank holds the whole gradient of the whole bias.

``SplitModel`` is what the models share to be split: the tables of the
dims each parameter is split along over tp and ep (by name suffix), and
the swap of each such parameter for this rank's chunk.
"""

from typing import Optional

import torch
import torch.distributed as dist


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce(grad), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return torch.cat(list(group.all_gather(x)), dim=1)

    @staticmethod
    def backward(ctx, grad):
        group = ctx.group
        chunks = torch.stack(grad.chunk(group.world, dim=1))
        return group.reduce_scatter(chunks)[0], None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return group.all_gather(x).flatten(0, 1)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.group.rank * ctx.rows
        return grad[start:start + ctx.rows], None


class _SliceToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return x.chunk(group.world, dim=dim)[group.rank].contiguous()

    @staticmethod
    def backward(ctx, grad):
        parts = ctx.group.all_gather(grad.contiguous())
        return torch.cat(list(parts), dim=ctx.dim), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce(grad), None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromTP.apply(x, group)


def gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    """[B, S_local, ...] on each rank -> [B, world * S_local, ...], the
    chunks in rank order."""
    return x if group is None else _GatherSeq.apply(x, group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """[rows, ...] on each rank -> [world * rows, ...], in rank order."""
    return x if group is None else _GatherRows.apply(x, group)


def slice_to_tp(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` of ``x``, whole on every rank."""
    return x if group is None else _SliceToTP.apply(x, group, dim)


def all_reduce_sum(x: torch.Tensor, groups) -> torch.Tensor:
    """The sum of ``x`` over every rank of ``groups`` (a sequence of
    groups over disjoint axes)."""
    for group in groups:
        x = _AllReduceSum.apply(x, group)
    return x


def vocab_parallel_embedding(ids: torch.Tensor, weight: torch.Tensor,
                             group) -> torch.Tensor:
    """Rows of the full table for ``ids``, from this rank's vocab shard
    ``weight`` (rows ``[rank * V/tp, (rank + 1) * V/tp)``): each rank
    looks up the ids it holds, zeros the others, and the sum over ``tp``
    is the lookup."""
    rows = weight.shape[0]
    local = ids.long() - group.rank * rows
    outside = (local < 0) | (local >= rows)
    out = torch.nn.functional.embedding(local.masked_fill(outside, 0),
                                        weight)
    out = out.masked_fill(outside[..., None], 0)
    return reduce_from_tp(out, group)


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 group,
                                 mask: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """``cross_entropy_loss`` of ``trainer/train.py`` from this rank's
    vocab shard of the logits ([B, S, V/tp]), in fp32: the log-sum-exp as
    max + log(sum exp(x - max)) with max and sum reduced over ``tp``, less
    the target logit, which only the rank holding it contributes."""
    logits32 = logits.float()
    width = logits32.shape[-1]
    row_max = group.all_reduce(logits32.detach().amax(dim=-1),
                               op=dist.ReduceOp.MAX)
    sum_exp = reduce_from_tp(
        (logits32 - row_max[..., None]).exp().sum(dim=-1), group)
    lse = row_max + sum_exp.log()
    local = labels.long() - group.rank * width
    outside = (local < 0) | (local >= width)
    gold = torch.gather(logits32, -1,
                        local.masked_fill(outside, 0)[..., None])[..., 0]
    gold = reduce_from_tp(gold.masked_fill(outside, 0.0), group)
    token_loss = lse - gold
    if mask is not None:
        mask = mask.to(token_loss.dtype)
        return (token_loss * mask).sum() / mask.sum().clamp(min=1)
    return token_loss.mean()


class SplitModel:
    """The parameters a model splits over ``tp`` and ``ep``: ``tp_split``
    and ``ep_split`` map a parameter-name suffix to the dim it is split
    along.  ``_keep_shards`` replaces each such parameter by this rank's
    chunk and hands the group to every module with the axis's attribute
    (``tp``, ``ep``)."""

    tp_split: dict = {}
    ep_split: dict = {}

    def _split_dims(self, table):
        return {name: table[key] for name, _ in self.named_parameters()
                for key in table if name.endswith(key)}

    def tp_dims(self):
        """``{parameter name: dim}`` of the parameters split over tp."""
        return self._split_dims(self.tp_split)

    def ep_dims(self):
        """``{parameter name: dim}`` of the parameters split over ep."""
        return self._split_dims(self.ep_split)

    @torch.no_grad()
    def _keep_shards(self, dims, group, attr: str) -> None:
        for name, param in list(self.named_parameters()):
            if name not in dims:
                continue
            owner, _, leaf = name.rpartition(".")
            module = self.get_submodule(owner) if owner else self
            shard = param.chunk(group.world, dim=dims[name])[group.rank]
            setattr(module, leaf, torch.nn.Parameter(shard.contiguous()))
        for module in self.modules():
            if hasattr(module, attr):
                setattr(module, attr, group)

    def _check_tp_divides(self, group, sizes) -> None:
        """Raise ``ValueError`` where tp does not divide one of ``sizes``
        (``(name, size)`` pairs): GSPMD would pad there, the port does
        not."""
        for what, size in sizes:
            if size % group.world:
                raise ValueError(f"tp={group.world} does not divide "
                                 f"{what}={size}: the port does not pad a "
                                 "tensor-parallel shard")
