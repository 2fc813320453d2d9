"""The port's GPT-2 (dlrover_tpu_torch/models/gpt.py) against the JAX
model (dlrover_tpu/models/gpt.py) on the CPU: the tiny config with the
same seeded numpy weights (through models/convert.py, from the scanned
``h/block`` and the unrolled ``h_{i}`` layouts) and the same seeded
tokens (B=4, S=16).

Tolerances.  fp32: logits within 1e-5 absolute (measured ~4e-7), the
loss within 1e-6 relative, every gradient leaf within 1e-5 of its
largest entry (measured ~1e-6; the tied ``wte`` holds both its uses).
bf16 (the default dtype; jitted JAX): logits within 2e-2 of their
largest magnitude, the loss within 1e-3 relative, and each gradient leaf
within 3e-2 relative in Frobenius norm.  The port rounds where jitted
XLA rounds inside a block (per-op GELU, the residual sum into the
LayerNorm kept in fp32), but XLA fuses further inside its scan body and
across the unrolled layout's blocks: measured 1.8e-3 (scanned) and
7.2e-3 (unrolled) on logits of magnitude ~0.67, the loss within 4e-6,
the gradients within 1.4e-2 (ROADMAP queue 3 notes).
"""

import dataclasses
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.models.gpt import GPT as JaxGPT  # noqa: E402
from dlrover_tpu.models.gpt import GPTConfig as JaxGPTConfig  # noqa: E402
from dlrover_tpu_torch.models.gpt import (  # noqa: E402
    GPT,
    ROADMAP_GPT_VIT_CP_EP,
    GPTConfig,
    dropout,
)
from dlrover_tpu_torch.parallel.sharding import param_logical_axes  # noqa: E402
from torch_family_parity import jax_grads, jax_logits, setup  # noqa: E402

CASES = [(dtype, scan) for dtype in ("float32", "bfloat16")
         for scan in (True, False)]


def _ids(case):
    return f"{case[0]}-{'scanned' if case[1] else 'unrolled'}"


@pytest.mark.parametrize("dtype,scan", CASES, ids=map(_ids, CASES))
def test_logits_match_jax(dtype, scan):
    s = setup("gpt", dtype, scan)
    want = jax_logits(s)
    got = s["model"](torch.from_numpy(s["x"]))
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = 1e-5 if dtype == "float32" else 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol)


@pytest.mark.parametrize("dtype,scan", CASES, ids=map(_ids, CASES))
def test_loss_and_grads_match_jax(dtype, scan):
    s = setup("gpt", dtype, scan)
    want_loss, want = jax_grads(s)
    loss = s["port_loss"]()
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss,
                               rtol=1e-6 if dtype == "float32" else 1e-3)
    grads = {n: p.grad.numpy() for n, p in s["model"].named_parameters()}
    assert set(grads) == set(want)
    for n, g in grads.items():
        if dtype == "float32":
            np.testing.assert_allclose(g, want[n], rtol=0,
                                       atol=1e-5 * np.abs(want[n]).max(),
                                       err_msg=n)
        else:
            rel = np.linalg.norm(g - want[n]) / np.linalg.norm(want[n])
            assert rel <= 3e-2, (n, rel)


@pytest.mark.parametrize("preset", ["gpt2", "gpt2_large", "gpt2_xl",
                                    "tiny"])
def test_presets_and_param_count_match_jax(preset):
    """Every preset has the reference's widths and depth, and
    ``num_params`` counts the reference's parameters."""
    jcfg = getattr(JaxGPTConfig, preset)()
    cfg = getattr(GPTConfig, preset)()
    for f in ("vocab_size", "n_embd", "n_layer", "n_head", "block_size",
              "dropout", "remat"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    shapes = jax.eval_shape(JaxGPT(jcfg).init, jax.random.PRNGKey(0),
                            np.zeros((1, 8), np.int32))["params"]
    want = sum(int(np.prod(a.shape)) for a in
               jax.tree.leaves(nn.meta.unbox(shapes)))
    if preset == "tiny":
        model = GPT(cfg, device="cpu")
        assert sum(p.numel() for p in model.parameters()) == want
    # the count reads the config only: no 1.5B model is built here
    assert GPT.num_params(types.SimpleNamespace(config=cfg)) == want


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPT(GPTConfig.tiny())


def test_dropout_keeps_at_its_rate_with_an_explicit_generator():
    """flax's Dropout: kept entries scaled by 1 / keep, at the keep rate
    (checked by rate, not by JAX's bits); the model's masks come from the
    caller's generator, and remat's recompute applies the same masks, so
    the gradients with and without remat agree."""
    x = torch.ones(200_000)
    keep = torch.rand(x.shape, generator=torch.Generator().manual_seed(0)
                      ) < 0.9
    y = dropout(x, keep, 0.1)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.9) < 5e-3
    assert torch.allclose(y[y != 0], torch.tensor(1 / 0.9))
    cfg = GPTConfig.tiny(dtype=torch.float32, dropout=0.1)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, size=(2, 16)))
    outs, grads = [], []
    for remat in (True, False):
        model = GPT(dataclasses.replace(cfg, remat=remat), device="cpu")
        with pytest.raises(ValueError, match="explicit generator"):
            model(ids, deterministic=False)
        out = model(ids, deterministic=False,
                    generator=torch.Generator().manual_seed(3))
        out.square().mean().backward()
        outs.append(out.detach())
        grads.append(model.wte.grad.clone())
    assert torch.equal(outs[0], outs[1])
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-7)
    det = model(ids)  # deterministic by default
    assert not torch.allclose(det, outs[0])


def test_cp_and_ep_are_refused_in_the_forward():
    class Group:
        world = 2

    ids = torch.zeros(1, 8, dtype=torch.long)
    for axis in ("set_context_parallel", "shard_expert_parallel"):
        model = GPT(GPTConfig.tiny(), device="cpu")
        getattr(model, axis)(Group())
        with pytest.raises(NotImplementedError,
                           match=ROADMAP_GPT_VIT_CP_EP.split(" (")[0]):
            model(ids)


def test_every_parameter_has_logical_axes():
    """The rules know every GPT parameter; norms and biases are
    replicated (no annotation in the reference), and a name the table
    does not know raises."""
    model = GPT(GPTConfig.tiny(), device="cpu")
    axes = param_logical_axes(dict(model.named_parameters()))
    assert axes["wte"] == ("vocab", "embed")
    assert axes["layers.0.attn_qkv.weight"] == (None, "heads", "embed")
    assert axes["layers.1.mlp_proj.weight"] == ("embed", "mlp")
    for n, a in axes.items():
        assert (a == ()) == (n.endswith(".bias") or ".ln_" in n
                             or n.startswith("ln_f")), n
    with pytest.raises(KeyError):
        param_logical_axes(["layers.0.attn_qkv.kernel"])
