"""The port's ring of flash blocks (dlrover_tpu_torch/ops/ring_attention.py
``ring_flash_attention``) against the JAX package's Pallas flash attention
(dlrover_tpu/ops/pallas/flash_attention.py) on the whole sequence.

The reference runs its ``flash`` attention on a sequence split over ``cp``
as GSPMD partitions it: the function is flash attention over the global
sequence.  The same seeded numpy q, k, v and output cotangent go through
``_flash_forward`` (interpret mode, with its LSE residual) and
``_flash_backward`` on the whole sequence, and through the port's ring on
cp gloo ranks of one spawn, each rank on its contiguous chunk, the kernels'
plain versions on the CPU.  Checked: the output, the merged LSE against
the whole-sequence LSE, and dq, dk and dv.  The cases: cp = 2, 4 and 8,
causal (and one unmasked), GQA 4:2 and MHA, head_dim 64 and 128, S_local
not a multiple of 64 (40), in fp32 and in bf16.  A ring turned the other
way must fail: at cp = 2 both directions are one, so the causal cases at
cp >= 4 are the ones that catch it.

Tolerances.  fp32: the two differ in summation order only (blocks merged
by LSE against one online softmax): out and LSE within 1e-5 relative and
2e-5 absolute, the gradients within 1e-4, as
tests/test_torch_flash_attention.py holds one-rank flash.  bf16: each
block's output and gradients are rounded to bf16 by the kernel before the
fp32 merge, where one-rank flash rounds once; out within 1.6e-2 absolute
(two bf16 ulps at |x| ~ 2; measured <= 7.8e-3), the LSE (fp32 from bf16
inputs) within 1e-4 (measured 9.5e-7), and each gradient within 2% of its
largest value (the one-rank bf16 test's limit; measured <= 0.57%, dv at
cp = 4); beside each, the port's one-rank flash on the whole sequence
against the same reference, whose error the ring's may exceed by at most
one bf16 ulp of the largest value per block merged (cp blocks; measured
<= 1.5 ulps in all at cp = 4).
"""

import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.ops.pallas import flash_attention as pfa  # noqa: E402
from dlrover_tpu_torch.ops.attention import flash_attention  # noqa: E402
from dlrover_tpu_torch.parallel import process_group  # noqa: E402
from torch_cp_ep_checks import ring_flash_worker  # noqa: E402

# (name, cp, B, S, H, H_kv, D, causal, dtype, seed)
CASES = [
    ("cp2_gqa_d64", 2, 2, 128, 4, 2, 64, True, "float32", 1),
    ("cp4_gqa_d64", 4, 1, 128, 4, 2, 64, True, "float32", 2),
    ("cp8_gqa_d64", 8, 1, 128, 4, 2, 64, True, "float32", 3),
    ("cp4_mha_d128", 4, 1, 128, 2, 2, 128, True, "float32", 4),
    ("cp2_s80_gqa_d64", 2, 1, 80, 4, 2, 64, True, "float32", 5),
    ("cp4_full_gqa_d64", 4, 1, 128, 4, 2, 64, False, "float32", 6),
    ("cp2_gqa_d64_bf16", 2, 1, 128, 4, 2, 64, True, "bfloat16", 7),
    ("cp4_mha_d128_bf16", 4, 1, 128, 2, 2, 128, True, "bfloat16", 8),
]
# the causal cases at cp >= 4 run again with the ring reversed
REVERSED = [c[0] for c in CASES if c[1] >= 4 and c[7]]
FP32 = dict(out=dict(rtol=1e-5, atol=2e-5), lse=dict(rtol=1e-5, atol=2e-5),
            grad=dict(rtol=1e-4, atol=1e-4))
BF16_OUT_ATOL, BF16_LSE_ATOL, BF16_GRAD_REL = 1.6e-2, 1e-4, 0.02
BF16_ULP = 2.0 ** -8


def _inputs(B, S, H, H_kv, D, seed):
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return rnd(B, S, H, D), rnd(B, S, H_kv, D), rnd(B, S, H_kv, D), \
        rnd(B, S, H, D)


def _block(S):
    """The largest Pallas block (a power of two up to 64) dividing S."""
    return next(b for b in (64, 32, 16, 8) if S % b == 0)


def _jax_whole(q, k, v, dout, causal, dtype):
    """Pallas flash on the whole sequence: out, LSE [B*H, S], dq, dk, dv
    (dk and dv summed over each GQA group in fp32), as fp32 numpy."""
    B, S, H, D = q.shape
    groups = H // k.shape[2]
    dt = getattr(jnp, dtype)
    jq, jk, jv, jdo = (jnp.asarray(x, dt) for x in (q, k, v, dout))
    blk = _block(S)
    out, lse = pfa._flash_forward(jq, jk, jv, causal, blk, blk,
                                  interpret=True, with_residuals=True)
    dq, dk, dv = pfa._flash_backward(
        jq, jnp.repeat(jk, groups, axis=2), jnp.repeat(jv, groups, axis=2),
        out, lse, jdo, causal, blk, blk, True)

    def by_kv(d):
        d = np.asarray(d.astype(jnp.float32))
        return d.reshape(B, S, H // groups, groups, D).sum(axis=3)

    return dict(out=np.asarray(out.astype(jnp.float32)),
                lse=np.asarray(lse)[..., 0], dq=np.asarray(
                    dq.astype(jnp.float32)), dk=by_kv(dk), dv=by_kv(dv))


def _one_rank(q, k, v, dout, causal, dtype):
    """The port's one-rank flash on the whole sequence (plain versions on
    the CPU): out, dq, dk, dv as fp32 numpy."""
    dt = getattr(torch, dtype)
    qt, kt, vt = (torch.from_numpy(x).to(dt).requires_grad_()
                  for x in (q, k, v))
    out = flash_attention(qt, kt, vt, causal)
    (out.float() * torch.from_numpy(dout).to(dt).float()).sum().backward()
    return {n: t.detach().float().numpy() for n, t in (
        ("out", out), ("dq", qt.grad), ("dk", kt.grad), ("dv", vt.grad))}


def _assemble(blocks, key):
    """The whole sequence from the ranks' chunks: dim 1 of a [B, S, ...]
    block, dim 1 of an LSE [B*H, S]."""
    return np.concatenate([b[key] for b in sorted(
        blocks, key=lambda b: b["chunk"])], axis=1)


@pytest.fixture(scope="module")
def results():
    """The port's cases (and the reversed ones) on 8 gloo ranks in the
    background while JAX runs them here."""
    cases, inputs = [], {}
    for name, cp, B, S, H, H_kv, D, causal, dtype, seed in CASES:
        q, k, v, dout = inputs[name] = _inputs(B, S, H, H_kv, D, seed)
        case = dict(cp=cp, causal=causal, dtype=dtype, q=q, k=k, v=v,
                    dout=dout)
        cases.append(case)
        if name in REVERSED:
            cases.append(dict(case, reverse=True))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(process_group.spawn, ring_flash_worker, 8,
                            (cases,), device="cpu", timeout_s=180.0)
        want = {name: _jax_whole(*inputs[name], causal, dtype)
                for name, *_, causal, dtype, _ in CASES}
        one = {name: _one_rank(*inputs[name], causal, dtype)
               for name, *_, causal, dtype, _ in CASES}
        ranks = ranks.result()
    port, reversed_ = {}, {}
    i = 0
    for name, cp, *_ in CASES:
        for into in ((port, reversed_) if name in REVERSED else (port,)):
            blocks = [ranks[r][i] for r in range(cp)]
            into[name] = {key: _assemble(blocks, key) for key in (
                "out", "lse", "dq", "dk", "dv")}
            i += 1
    return types.SimpleNamespace(port=port, reversed=reversed_, want=want,
                                 one=one, cp={c[0]: c[1] for c in CASES},
                                 dtype={c[0]: c[8] for c in CASES})


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_matches_pallas_flash_on_the_whole_sequence(results, name):
    got, want = results.port[name], results.want[name]
    for key in ("out", "lse", "dq", "dk", "dv"):
        assert got[key].shape == want[key].shape, (key, got[key].shape)
        assert np.isfinite(got[key]).all(), key
    if results.dtype[name] == "float32":
        for key in ("out", "lse", "dq", "dk", "dv"):
            tol = FP32[key] if key in FP32 else FP32["grad"]
            np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                       **tol)
        return
    one, cp = results.one[name], results.cp[name]
    np.testing.assert_allclose(got["out"], want["out"], rtol=0,
                               atol=BF16_OUT_ATOL, err_msg="out")
    np.testing.assert_allclose(got["lse"], want["lse"], rtol=0,
                               atol=BF16_LSE_ATOL, err_msg="lse")
    for key in ("out", "dq", "dk", "dv"):
        scale = np.abs(want[key]).max()
        err = np.abs(got[key] - want[key]).max()
        if key != "out":
            assert err <= BF16_GRAD_REL * scale, (key, err, scale)
        # the ring against the one-rank kernel's own error: at most one
        # bf16 ulp of the largest value more per block merged
        one_err = np.abs(one[key] - want[key]).max()
        assert err <= one_err + cp * BF16_ULP * scale, (key, err, one_err)


@pytest.mark.parametrize("name", REVERSED)
def test_a_ring_turned_the_other_way_disagrees(results, name):
    """The causal cases at cp >= 4 with every shift reversed: rank r then
    holds chunk r + t where it counts on r - t, so the output and the
    gradients are wrong."""
    got, want = results.reversed[name], results.want[name]
    errors = {key: np.abs(got[key] - want[key]).max()
              for key in ("out", "dq", "dk", "dv")}
    assert min(errors.values()) > 0.1, errors
