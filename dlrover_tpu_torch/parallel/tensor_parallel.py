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


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromTP.apply(x, group)


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
