"""Ring attention over the mesh's ``cp`` axis: sequence parallelism.

Port of ``dlrover_tpu/ops/ring_attention.py``.  The sequence is split
over ``cp`` in contiguous chunks (rank ``r`` holds positions
``[r * S_local, (r + 1) * S_local)``, the order ``parallel/sharding.py``
``shard_batch`` gives).  Each rank attends its local queries to the
key/value chunk it holds, folds the scores into a flash-style online
softmax (the ``m``, ``l`` and ``acc`` carries), and passes the chunk on
around the ring, so a rank never holds more than two chunks of K/V.  GQA
chunks travel unexpanded and are repeated after they arrive; N chunks
take N - 1 rotations (the last chunk is peeled off).  The causal mask
compares global positions, so it is exact across chunks.  Only causal or
unmasked attention: a padding mask is not threaded through the ring.

The reference computes this in ``jnp``, outside any Pallas kernel, so
the port is plain torch under autograd: the rotation is ``DpGroup.shift``
wrapped in an autograd function whose backward rotates the other way
(the transpose of ``lax.ppermute``), and autograd differentiates the
accumulation.  Under remat the backward recomputes the layer, and with it
the rotations; every rank recomputes in the same order.
"""

import torch

from dlrover_tpu_torch.parallel.mesh import axis_group

NEG_INF = -1e30


class _Rotate(torch.autograd.Function):
    """Rank i sends (k, v) to rank i + 1 and receives rank i - 1's: the
    reference's ``perm = [(i, (i + 1) % N)]``, which is ``shift(-1)``
    (``shift(d)`` sends from rank i to rank i - d).  The backward sends
    each cotangent back to where its chunk came from: ``shift(+1)``."""

    @staticmethod
    def forward(ctx, k, v, group):
        ctx.group = group
        out = group.shift({"k": k, "v": v}, -1)
        return out["k"], out["v"]

    @staticmethod
    def backward(ctx, grad_k, grad_v):
        out = ctx.group.shift({"k": grad_k, "v": grad_v}, 1)
        return out["k"], out["v"], None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, causal: bool = True) -> torch.Tensor:
    """This rank's rows of attention over the whole sequence; q, k, v:
    this rank's chunk, [B, S_local, H, D] (k and v may have fewer heads:
    GQA); ``group``: the ``cp`` axis's ``DpGroup``."""
    groups = q.shape[2] // k.shape[2]
    world, idx = group.world, group.rank
    _, s_local, _, d = q.shape
    scale = d ** -0.5
    q32 = q.float()
    iota = torch.arange(s_local, device=q.device)

    def accumulate(acc, m, l, k_cur, v_cur, ring_step):
        """One online-softmax update of q against the held chunk."""
        if groups > 1:
            k_cur = k_cur.repeat_interleave(groups, dim=2)
            v_cur = v_cur.repeat_interleave(groups, dim=2)
        src = (idx - ring_step) % world
        s = torch.einsum("bqhd,bkhd->bhqk", q32, k_cur.float()) * scale
        if causal:
            q_pos = idx * s_local + iota[:, None]
            k_pos = src * s_local + iota[None, :]
            s = s.masked_fill(q_pos < k_pos, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))  # [B, H, S_local]
        p = torch.exp(s - m_new[..., None])
        correction = torch.exp(m - m_new)
        l_new = l * correction + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, v_cur.float())
        acc_new = acc * correction.transpose(1, 2)[..., None] + pv
        return acc_new, m_new, l_new

    acc = torch.zeros_like(q32)
    m = torch.full(q32.shape[:3], NEG_INF, device=q.device).transpose(1, 2)
    l = torch.zeros_like(m)
    # peel the last chunk: N - 1 rotations for N chunks
    for ring_step in range(world - 1):
        acc, m, l = accumulate(acc, m, l, k, v, ring_step)
        k, v = _Rotate.apply(k, v, group)
    acc, m, l = accumulate(acc, m, l, k, v, world - 1)

    l_t = l.transpose(1, 2)[..., None]  # [B, S_local, H, 1]
    safe_l = torch.where(l_t == 0.0, torch.ones_like(l_t), l_t)
    return (acc / safe_l).to(q.dtype)


def ring_attention_sharded(mesh, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           causal: bool = True) -> torch.Tensor:
    """``ring_attention`` over ``mesh``'s ``cp`` axis.  In JAX this maps a
    global array over the mesh; a rank of the port already holds its
    block (its batch rows, sequence chunk and heads), so it takes the
    block and the mesh's ``cp`` group."""
    return ring_attention(q, k, v, axis_group(mesh, "cp"), causal)
