"""The port's ring attention (dlrover_tpu_torch/ops/ring_attention.py)
against the JAX package's (dlrover_tpu/ops/ring_attention.py).

The same seeded numpy q, k, v and output cotangent go through JAX's
``ring_attention_sharded`` (shard_map on the virtual CPU devices of
tests/conftest.py) and ``jax.grad`` of sum(out * dout), and through the
port's ``ring_attention`` on cp gloo ranks of one spawn, each rank on its
sequence chunk, autograd carrying the cotangents back around the ring.
The cases: cp = 2, 4 and 8, causal and not, GQA 4:2 (the unexpanded
chunks travel), the MHA case of tests/test_ops.py:116 at cp=4, and
``ring_attention_sharded`` on a dp=2 x cp=4 mesh (tests/test_ops.py:138).
A wrong rotation direction still gives the right non-causal output, so
the causal cases at cp >= 4 are the ones that catch it.

Tolerances: fp32, the two rings differ in summation order only: outputs
and gradients within 1e-5 (absolute and relative) of JAX's ring; and, as
tests/test_ops.py holds JAX's ring, within 2e-3 of JAX's
``reference_attention``.
"""

import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.ops.attention import (  # noqa: E402
    reference_attention as jax_reference,
)
from dlrover_tpu.ops.ring_attention import (  # noqa: E402
    ring_attention_sharded as jax_ring,
)
from dlrover_tpu.parallel.mesh import MeshConfig as JaxMeshConfig  # noqa: E402
from dlrover_tpu.parallel.mesh import build_mesh as jax_build_mesh  # noqa: E402
from dlrover_tpu_torch.models.llama import (  # noqa: E402
    LlamaConfig,
    LlamaForCausalLM,
)
from dlrover_tpu_torch.parallel import process_group  # noqa: E402
from torch_cp_ep_checks import ring_worker  # noqa: E402

D = 16
# (name, ranks' axes, B, S, H, H_kv, causal, seed)
CASES = [
    (f"cp{cp}_{'causal' if causal else 'full'}", dict(cp=cp), 2, 64, 4, 2,
     causal, 10 * cp + causal)
    for cp in (2, 4, 8) for causal in (True, False)
] + [
    ("cp4_mha_causal", dict(cp=4), 2, 64, 4, 4, True, 5),
    ("sharded_dp2_cp4_gqa", dict(dp=2, cp=4), 2, 32, 4, 2, True, 7),
]


def _inputs(B, S, H, H_kv, seed):
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return rnd(B, S, H, D), rnd(B, S, H_kv, D), rnd(B, S, H_kv, D), \
        rnd(B, S, H, D)


def _jax_case(axes, causal, q, k, v, dout):
    n = int(np.prod(list(axes.values())))
    mesh = jax_build_mesh(JaxMeshConfig(**{"dp": 1, **axes}),
                          devices=jax.devices()[:n])

    def loss(q_, k_, v_):
        out = jax_ring(mesh, q_, k_, v_, causal=causal)
        return jnp.sum(out * dout), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    mask = (jnp.tril(jnp.ones((q.shape[1],) * 2, bool))[None, None]
            if causal else None)
    ref = jax_reference(q, k, v, mask)
    return [np.asarray(x) for x in (out, *grads)], np.asarray(ref)


def _assemble(blocks, key):
    """The global array from the ranks' blocks: rows over dp, chunks of
    the sequence over cp."""
    rows = sorted({b["row"] for b in blocks})
    return np.concatenate([
        np.concatenate([b[key] for b in sorted(
            (b for b in blocks if b["row"] == row),
            key=lambda b: b["chunk"])], axis=1)
        for row in rows], axis=0)


@pytest.fixture(scope="module")
def results():
    """The port's cases on 8 gloo ranks in the background while JAX runs
    them here."""
    cases, inputs = [], {}
    for name, axes, B, S, H, H_kv, causal, seed in CASES:
        q, k, v, dout = inputs[name] = _inputs(B, S, H, H_kv, seed)
        case = dict(causal=causal, q=q, k=k, v=v, dout=dout)
        case.update(axes if "dp" not in axes else dict(axes=axes))
        cases.append(case)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(process_group.spawn, ring_worker, 8, (cases,),
                            device="cpu", timeout_s=180.0)
        jax_out = {name: _jax_case(axes, causal, *inputs[name])
                   for name, axes, *_, causal, _ in CASES}
        ranks = ranks.result()
    port = {}
    for i, (name, axes, *_rest) in enumerate(CASES):
        blocks = [ranks[r][i] for r in range(int(np.prod(
            list(axes.values()))))]
        port[name] = [_assemble(blocks, key)
                      for key in ("out", "dq", "dk", "dv")]
    return port, jax_out


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_matches_the_jax_ring_and_its_grads(results, name):
    port, jax_out = results
    want, _ = jax_out[name]
    for label, got, ref in zip(("out", "dq", "dk", "dv"), port[name], want):
        assert got.shape == ref.shape, (label, got.shape, ref.shape)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5,
                                   err_msg=label)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_matches_the_jax_reference_attention(results, name):
    port, jax_out = results
    np.testing.assert_allclose(port[name][0], jax_out[name][1], rtol=2e-3,
                               atol=2e-3)


def test_ring_without_cp_warns_and_runs_the_reference():
    """attention_impl="ring" with no cp group: a warning, then reference
    attention, as the reference model does without a cp mesh."""
    kw = dict(dtype=torch.float32)
    ring = LlamaForCausalLM(LlamaConfig.tiny(attention_impl="ring", **kw),
                            device="cpu", seed=3)
    ref = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu", seed=3)
    ids = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, size=(2, 16)))
    with pytest.warns(UserWarning, match="without a cp group"):
        got = ring(ids)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        want = ref(ids)
    assert torch.equal(got, want)
