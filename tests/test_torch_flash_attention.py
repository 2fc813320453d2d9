"""The port's FA2 (dlrover_tpu_torch/ops/cuda/flash_attention.py) against the
Pallas kernels of dlrover_tpu/ops/pallas/flash_attention.py.

Inputs are drawn once with numpy and handed to both packages.  On the CPU
the port runs its plain versions (the path its wrappers take for CPU
tensors) and the Pallas kernels run in interpret mode.  The CUDA kernels
themselves are held against the plain versions by the ``cuda``-marked
case, which skips without a card.  The JAX side is imported by the
``ref`` fixture, not at the top of the module, so that the ``cuda`` case
also runs on the card's machine, which has no JAX (README: ``-m cuda``
with ``--noconftest``).
"""

import types

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.ops.attention import flash_attention
from dlrover_tpu_torch.ops.cuda import flash_attention as fa

# fp32 on both sides; the two differ only in summation order
# (blockwise online softmax vs whole-row), so agreement is at fp32 noise
FP32_TOL = dict(rtol=1e-5, atol=2e-5)
# bf16 inputs and outputs, fp32 math inside both: one bf16 ulp at |x|~1
BF16_TOL = dict(rtol=0, atol=8e-3)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's Pallas flash attention, and jax/jnp."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from dlrover_tpu.ops.pallas import flash_attention as pallas_fa

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, forward=pallas_fa._flash_forward,
        backward=pallas_fa._flash_backward,
        attention=pallas_fa.pallas_flash_attention,
    )


def _inputs(seed, B, S, H, D, kv_heads):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, kv_heads, D), dtype=np.float32)
    v = rng.standard_normal((B, S, kv_heads, D), dtype=np.float32)
    do = rng.standard_normal((B, S, H, D), dtype=np.float32)
    return q, k, v, do


def _jx(ref, x, dtype=None):
    return ref.jnp.asarray(x, dtype or ref.jnp.float32)


def _tc(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


CASES = [
    # (B, S, H, H_kv, D, causal): multi-block, GQA 2:1 and 4:1, both masks
    (2, 256, 4, 4, 32, True),
    (2, 256, 4, 4, 32, False),
    (1, 128, 4, 2, 16, True),
    (1, 128, 4, 1, 16, False),
]


@pytest.mark.parametrize("B,S,H,H_kv,D,causal", CASES)
def test_plain_forward_matches_pallas(ref, B, S, H, H_kv, D, causal):
    q, k, v, _ = _inputs(0, B, S, H, D, H_kv)
    out_j, lse_j = ref.forward(
        _jx(ref, q), _jx(ref, k), _jx(ref, v), causal, 64, 64,
        interpret=True, with_residuals=True,
    )
    out_t, lse_t = fa.flash_forward_plain(_tc(q), _tc(k), _tc(v), causal)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **FP32_TOL)
    assert lse_t.shape == (B * H, S)
    np.testing.assert_allclose(_np(lse_t), _np(lse_j)[..., 0], **FP32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_pallas(ref, causal):
    """dQ and dK/dV on expanded heads, from the same out/LSE residuals."""
    B, S, H, D = 2, 128, 4, 32
    q, k, v, do = _inputs(1, B, S, H, D, H)
    out_j, lse_j = ref.forward(
        _jx(ref, q), _jx(ref, k), _jx(ref, v), causal, 64, 64,
        interpret=True, with_residuals=True,
    )
    dq_j, dk_j, dv_j = ref.backward(
        _jx(ref, q), _jx(ref, k), _jx(ref, v), out_j, lse_j, _jx(ref, do),
        causal, 64, 64, True,
    )
    out_t = _tc(_np(out_j))
    lse_t = _tc(_np(lse_j)[..., 0])
    delta = fa.attention_delta(out_t, _tc(do))
    qt, kt, vt, dot = _tc(q), _tc(k), _tc(v), _tc(do)
    dq_t = fa.flash_bwd_dq_plain(qt, kt, vt, dot, lse_t, delta, causal)
    dk_t, dv_t = fa.flash_bwd_dkv_plain(qt, kt, vt, dot, lse_t, delta,
                                        causal)
    # grads sum S terms of size ~1: scale the fp32 tolerance to magnitude
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(dq_t), _np(dq_j), **tol)
    np.testing.assert_allclose(_np(dk_t), _np(dk_j), **tol)
    np.testing.assert_allclose(_np(dv_t), _np(dv_j), **tol)


@pytest.mark.parametrize("B,S,H,H_kv,D,causal", CASES)
def test_autograd_matches_jax_grad(ref, B, S, H, H_kv, D, causal):
    """The port's autograd.Function (forward, delta, dQ, dK/dV, GQA group
    sum) against jax.grad through the Pallas custom VJP."""
    q, k, v, _ = _inputs(2, B, S, H, D, H_kv)

    def loss_j(q_, k_, v_):
        return ref.jnp.sum(
            ref.attention(q_, k_, v_, causal, 64, 64, True) ** 2
        )

    grads_j = ref.jax.grad(loss_j, argnums=(0, 1, 2))(
        _jx(ref, q), _jx(ref, k), _jx(ref, v))
    qt, kt, vt = (_tc(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(qt, kt, vt, causal)
    grads_t = torch.autograd.grad((out ** 2).sum(), (qt, kt, vt))
    for gt, gj in zip(grads_t, grads_j):
        assert gt.shape == gj.shape  # dk/dv at the kv head count
        np.testing.assert_allclose(_np(gt), _np(gj), rtol=1e-4, atol=1e-4)


def test_bf16_forward_and_grads(ref):
    B, S, H, H_kv, D = 1, 128, 4, 2, 32
    q, k, v, _ = _inputs(3, B, S, H, D, H_kv)

    def loss_j(q_, k_, v_):
        out = ref.attention(q_, k_, v_, True, 64, 64, True)
        return ref.jnp.sum(out.astype(ref.jnp.float32) ** 2)

    bf = ref.jnp.bfloat16
    out_j = ref.attention(_jx(ref, q, bf), _jx(ref, k, bf), _jx(ref, v, bf),
                                   True, 64, 64, True)
    grads_j = ref.jax.grad(loss_j, argnums=(0, 1, 2))(
        _jx(ref, q, bf), _jx(ref, k, bf), _jx(ref, v, bf))
    qt, kt, vt = (_tc(x, torch.bfloat16).requires_grad_() for x in (q, k, v))
    out_t = flash_attention(qt, kt, vt, True)
    assert out_t.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out_t), _np(out_j), **BF16_TOL)
    grads_t = torch.autograd.grad(
        (out_t.float() ** 2).sum(), (qt, kt, vt))
    for gt, gj in zip(grads_t, grads_j):
        assert gt.dtype == torch.bfloat16
        # bf16 rounding of out, dO and the grads themselves: 2% of the
        # largest gradient (the card's check allows 5%)
        want = _np(gj)
        np.testing.assert_allclose(
            _np(gt), want, rtol=0, atol=0.02 * np.abs(want).max())


@pytest.mark.parametrize("S,pallas_block", [(100, 50), (96, 32)])
def test_seq_len_off_the_tile_matches_pallas(ref, S, pallas_block):
    """S not a multiple of 64.  The Pallas kernel needs blocks that divide
    S and raises ``ValueError`` at 64; the port has no blocks to choose
    (its kernels zero-fill and mask a ragged last tile), so the same call
    goes through and matches Pallas run at a block that divides S."""
    q, k, v, _ = _inputs(4, 1, S, 2, 16, 2)
    with pytest.raises(ValueError):
        ref.attention(_jx(ref, q), _jx(ref, k), _jx(ref, v), True, 64, 64,
                      True)
    out = flash_attention(_tc(q), _tc(k), _tc(v), True)
    want = ref.attention(_jx(ref, q), _jx(ref, k), _jx(ref, v), True,
                         pallas_block, pallas_block, True)
    np.testing.assert_allclose(_np(out), _np(want), **FP32_TOL)


@pytest.mark.parametrize("S,pallas_block", [(100, 50), (96, 32)])
def test_seq_len_off_the_tile_backward_matches_pallas(ref, S, pallas_block):
    """The backward at S not a multiple of 64, causal, GQA 2:1: the port's
    autograd (plain dQ, the version the card's dQ kernel is held against,
    and plain dK/dV) against jax.grad through the Pallas custom VJP at a
    block that divides S."""
    q, k, v, _ = _inputs(5, 1, S, 4, 16, 2)

    def loss_j(q_, k_, v_):
        return ref.jnp.sum(ref.attention(q_, k_, v_, True, pallas_block,
                                         pallas_block, True) ** 2)

    grads_j = ref.jax.grad(loss_j, argnums=(0, 1, 2))(
        _jx(ref, q), _jx(ref, k), _jx(ref, v))
    qt, kt, vt = (_tc(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(qt, kt, vt, True)
    grads_t = torch.autograd.grad((out ** 2).sum(), (qt, kt, vt))
    for gt, gj in zip(grads_t, grads_j):
        assert gt.shape == gj.shape
        np.testing.assert_allclose(_np(gt), _np(gj), rtol=1e-4, atol=1e-4)


def test_cuda_tensor_never_takes_the_plain_path():
    """A non-CPU tensor goes to the kernel wrapper, which rejects what the
    kernels do not take instead of computing it some other way."""
    q = torch.zeros(1, 64, 2, 32, device="meta", dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA"):
        fa.flash_forward(q, q, q, True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# (B, S, H, H_kv, D, causal): whole 128-row tiles; S below one tile (80);
# S a multiple of neither 64 nor 128 (333, 200); S a multiple of 64 but
# not of 128 (192: dQ's last 128-row q tile has one warpgroup's rows all
# past S); S=2048 with GQA 4:1
CARD_CASES = [
    (2, 256, 4, 2, 64, True),
    (2, 256, 4, 4, 128, False),
    (2, 80, 4, 2, 64, True),
    (2, 333, 8, 2, 64, False),
    (1, 200, 4, 4, 128, True),
    (2, 192, 4, 2, 128, True),
    (1, 2048, 16, 4, 128, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,H_kv,D,causal", CARD_CASES)
def test_kernels_match_plain_on_card(cuda_device, B, S, H, H_kv, D, causal):
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device,
                           dtype=torch.bfloat16)

    q, k, v, do = rnd(B, S, H, D), rnd(B, S, H_kv, D), rnd(B, S, H_kv, D), \
        rnd(B, S, H, D)
    out, lse = fa.flash_forward(q, k, v, causal)
    ref_out, ref_lse = fa.flash_forward_plain(q, k, v, causal)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=0,
                               atol=3e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
    delta = fa.attention_delta(ref_out, do)
    got = (fa.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal),
           *fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal))
    want = (fa.flash_bwd_dq_plain(q, k, v, do, ref_lse, delta, causal),
            *fa.flash_bwd_dkv_plain(q, k, v, do, ref_lse, delta, causal))
    for a, b in zip(got, want):
        scale = max(1.0, b.float().abs().max().item())
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=0.05 * scale)
    # the max-abs limits follow the largest values; the relative error
    # ||kernel - plain||_F / ||plain||_F on each tile of 64 sequence
    # positions (dim 1) also holds the small ones (bf16 rounding of the
    # outputs alone gives a few 1e-3)
    for a, b in zip((out, lse, *got), (ref_out, ref_lse, *want)):
        diff, b = a.float() - b.float(), b.float()
        for d, w in zip(diff.split(64, dim=1), b.split(64, dim=1)):
            assert (d.norm() / w.norm()).item() <= 1e-2
