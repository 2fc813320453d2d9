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

``ring_flash_attention`` is the same ring over the flash kernels
(``ops/cuda/flash_attention.py``): what the reference's ``flash``
attention computes when GSPMD splits its sequence over ``cp``.  Each
block of q against one held chunk is one kernel call: the diagonal block
causal, a chunk from an earlier rank unmasked, a chunk from a later rank
skipped (every key lies in the future).  The blocks' outputs are merged
in fp32 by their LSEs and cast once.  The backward goes around the ring
again with the merged LSE and delta, so a block's probabilities are its
slice of the global softmax and the dQ and dK/dV kernels run unchanged;
dQ sums in fp32 on the rank, and dK/dV sum in fp32 on the chunk's journey
and take one more hop home.  Chunks are contiguous (``shard_batch``), so
the causal ring is unbalanced: rank r computes r + 1 blocks.
"""

import torch

from dlrover_tpu_torch.ops.cuda.flash_attention import (
    attention_delta,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_forward,
)
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


def _block_mask(idx: int, src: int, causal: bool):
    """The kernels' ``causal`` for rank ``idx``'s queries against chunk
    ``src``, or None where every key is in the future."""
    if not causal:
        return False
    if src == idx:
        return True
    return False if src < idx else None


def _by_row(lse: torch.Tensor, shape) -> torch.Tensor:
    """An LSE ``[B*H, S]`` as ``[B, S, H, 1]``, beside ``out``."""
    B, S, H, _ = shape
    return lse.view(B, H, S).transpose(1, 2)[..., None]


def _sum_groups(d: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """dK or dV per q head ``[B, S, H, D]`` summed over each GQA group,
    in fp32: ``[B, S, H_kv, D]``."""
    B, S, H, D = d.shape
    return d.float().reshape(B, S, kv_heads, H // kv_heads, D).sum(dim=3)


def ring_flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       group, causal: bool = True):
    """The forward of ``ring_flash_attention`` without autograd: (out
    [B, S_local, H, D] in q's dtype, the merged LSE [B*H, S_local] fp32)."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    world, idx = group.world, group.rank
    out = lse = None
    k_cur, v_cur = k, v
    for step in range(world):
        mask = _block_mask(idx, (idx - step) % world, causal)
        if mask is not None:
            out_b, lse_b = flash_forward(q, k_cur, v_cur, mask)
            if out is None:
                out, lse = out_b.float(), lse_b
            else:
                new = torch.logaddexp(lse, lse_b)
                out = (out * torch.exp(_by_row(lse - new, q.shape))
                       + out_b.float() * torch.exp(_by_row(lse_b - new,
                                                           q.shape)))
                lse = new
        if step < world - 1:
            held = group.shift({"k": k_cur, "v": v_cur}, -1)
            k_cur, v_cur = held["k"], held["v"]
    return out.to(q.dtype), lse


class _RingFlash(torch.autograd.Function):
    """Flash blocks around the ring (module docstring).  The rotation is
    ``_Rotate``'s: ``shift(-1)``, rank i's chunk to rank i + 1."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = ring_flash_forward(q, k, v, group, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal = group, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        world, idx = group.world, group.rank
        dout = dout.contiguous()
        delta = attention_delta(out, dout)
        kv_heads = k.shape[2]
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        k_cur, v_cur = k, v
        for step in range(world):
            mask = _block_mask(idx, (idx - step) % world, causal)
            if mask is not None:
                dq += flash_bwd_dq(q, k_cur, v_cur, dout, lse, delta,
                                   mask).float()
                dk_b, dv_b = flash_bwd_dkv(q, k_cur, v_cur, dout, lse,
                                           delta, mask)
                dk += _sum_groups(dk_b, kv_heads)
                dv += _sum_groups(dv_b, kv_heads)
            # the gradients travel with their chunk; after the last block
            # they take one more hop, to the chunk's owner
            held = {"dk": dk, "dv": dv}
            if step < world - 1:
                held.update(k=k_cur, v=v_cur)
            held = group.shift(held, -1)
            dk, dv = held["dk"], held["dv"]
            k_cur, v_cur = held.get("k"), held.get("v")
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group, causal: bool = True) -> torch.Tensor:
    """This rank's rows of flash attention over the whole sequence,
    through the flash kernels (module docstring); q, k, v: this rank's
    chunk, [B, S_local, H(_kv), D]; ``group``: the ``cp`` axis's
    ``DpGroup``."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"q heads {q.shape[2]} not a multiple of kv heads {k.shape[2]}"
        )
    return _RingFlash.apply(q, k, v, group, causal)


def ring_attention_sharded(mesh, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           causal: bool = True) -> torch.Tensor:
    """``ring_attention`` over ``mesh``'s ``cp`` axis.  In JAX this maps a
    global array over the mesh; a rank of the port already holds its
    block (its batch rows, sequence chunk and heads), so it takes the
    block and the mesh's ``cp`` group."""
    return ring_attention(q, k, v, axis_group(mesh, "cp"), causal)
