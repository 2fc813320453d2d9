"""Attention: one reference core, the flash kernels on top.

Port of ``dlrover_tpu/ops/attention.py``.  ``reference_attention`` keeps
the JAX numerics policy (fp32 logits, mask fill ``finfo(float32).min``,
fp32 softmax, probabilities cast back to the input dtype, GQA by head
repeat).  ``flash_attention`` goes through the FA2 autograd function of
``ops/cuda/flash_attention.py``: its kernels on a CUDA tensor, their plain
versions on a CPU tensor.
"""

from typing import Optional

import torch

from dlrover_tpu_torch.ops.cuda.flash_attention import FlashAttention

def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention; q,k,v: [B, S, H, D] (k/v heads may be fewer: GQA).

    fp32 logits + softmax regardless of input dtype; mask is broadcastable
    to [B, H, Sq, Sk] with True = attend.
    """
    if k.shape[2] != q.shape[2]:
        groups = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
) -> torch.Tensor:
    """Fused attention, q: [B, S, H, D], k/v: [B, S, H_kv, D].

    The kernels' tiles are fixed (``csrc/flash_attention.cu``): the
    forward and dQ hold 128-row Q tiles and stream 128-row K/V tiles, and
    dK/dV holds 128-row K/V tiles and streams 64-row Q/dO tiles.  A ragged
    last tile is zero-filled and masked, so any S works: there are no
    block sizes to choose, and the TPU block table
    (ops/pallas/fa_tuned.json) does not apply to this card.
    """
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"q heads {q.shape[2]} not a multiple of kv heads {k.shape[2]}"
        )
    return FlashAttention.apply(q, k, v, causal)
