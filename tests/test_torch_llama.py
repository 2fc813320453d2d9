"""The port's Llama (dlrover_tpu_torch/models/llama.py) against the flax
model of dlrover_tpu/models/llama.py, on the same converted weights."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.models.llama import LlamaConfig as JaxLlamaConfig  # noqa: E402
from dlrover_tpu.models.llama import LlamaForCausalLM as JaxLlama  # noqa: E402
from dlrover_tpu_torch.models.convert import (  # noqa: E402
    flax_llama_to_state_dict,
)
from dlrover_tpu_torch.models.llama import (  # noqa: E402
    LlamaConfig,
    LlamaForCausalLM,
)

B, S = 2, 32

# fp32 compute: both sides run the same math in fp32; differences are
# summation order and libm (rope cos/sin, exp), far below 1e-4 on logits
FP32_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 compute: activations round to bf16 at different points (XLA fuses
# elementwise chains before rounding, PyTorch rounds per op).  On these
# inputs the flax model's own bf16 logits sit 0.064 from its fp32 logits
# (|logits| <= 3.6) and the port's bf16 logits 0.049 from flax's, so the
# bound is that rounding spread with headroom, not a looser algorithm
BF16_TOL = dict(rtol=0, atol=1e-1)


@pytest.fixture(scope="module")
def np_params():
    """The flax tiny model's initial params as numpy (the values do not
    depend on the compute dtype or the attention impl)."""
    variables = JaxLlama(JaxLlamaConfig.tiny()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, nn.meta.unbox(variables["params"]))


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_flax(np_params, impl, dtype):
    ids = np.random.default_rng(0).integers(0, 256, size=(B, S)).astype(
        np.int32)
    jcfg = JaxLlamaConfig.tiny(attention_impl=impl,
                               dtype=getattr(jnp, dtype))
    params = jax.tree.map(jnp.asarray, np_params)
    want = np.asarray(JaxLlama(jcfg).apply({"params": params}, ids))

    tcfg = LlamaConfig.tiny(attention_impl=impl,
                            dtype=getattr(torch, dtype))
    model = LlamaForCausalLM(tcfg, device="cpu")
    model.load_state_dict(flax_llama_to_state_dict(np_params, tcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    assert got.dtype == np.float32 and want.dtype == np.float32
    assert got.shape == (B, S, tcfg.vocab_size)
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got, want, **tol)


def test_converted_state_dict_covers_every_parameter(np_params):
    cfg = LlamaConfig.tiny()
    state = flax_llama_to_state_dict(np_params, cfg)
    model = LlamaForCausalLM(cfg, device="cpu")
    expected = {n: p.shape for n, p in model.named_parameters()}
    assert {n: t.shape for n, t in state.items()} == expected
    n_flax = sum(x.size for x in jax.tree.leaves(np_params))
    assert model.num_params() == n_flax == sum(
        p.numel() for p in model.parameters())


def test_remat_runs_the_layer_forward_again_in_backward():
    """torch.utils.checkpoint per layer: the flash forward runs twice per
    layer per step (forward + recompute), once per layer without grads."""
    from dlrover_tpu_torch.ops.cuda import flash_attention as fa

    cfg = LlamaConfig.tiny(attention_impl="flash")
    model = LlamaForCausalLM(cfg, device="cpu")
    ids = torch.zeros(1, 16, dtype=torch.long)
    calls = []
    original = fa.flash_forward
    fa.flash_forward = lambda *a: calls.append(1) or original(*a)
    try:
        model(ids).sum().backward()
        assert len(calls) == 2 * cfg.num_layers
        calls.clear()
        with torch.no_grad():
            model(ids)
        assert len(calls) == cfg.num_layers
    finally:
        fa.flash_forward = original


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig.tiny())
