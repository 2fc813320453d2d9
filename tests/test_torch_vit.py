"""The port's ViT (dlrover_tpu_torch/models/vit.py) against the JAX model
(dlrover_tpu/models/vit.py) on the CPU: the tiny config (32x32 images,
patch 8, 17 tokens) with the same seeded numpy weights (through
models/convert.py, from the scanned ``encoder/block`` and the unrolled
``encoder_{i}`` layouts; the conv kernel becomes the patch rows' weight)
and the same seeded images [B, H, W, C] and labels (B=4).

Tolerances, as tests/test_torch_gpt.py states them: fp32 logits within
1e-5 (measured ~1.4e-6 on logits of magnitude ~1.8), the loss within
1e-6 relative, every gradient leaf within 1e-5 of its largest entry;
bf16 logits within 2e-2 of their largest magnitude (measured 4.8e-3
scanned, 1.5e-2 unrolled, on ~1.8), the loss within 1e-3 relative
(measured 2.3e-4) and each gradient leaf within 3e-2 relative in
Frobenius norm (measured 1.8e-2): jitted XLA fuses further than the
port follows (ROADMAP queue 3).
"""

import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.models.vit import ViTConfig as JaxViTConfig  # noqa: E402
from dlrover_tpu.models.vit import (  # noqa: E402
    ViTForImageClassification as JaxViT,
)
from dlrover_tpu_torch.models.vit import (  # noqa: E402
    ViTConfig,
    ViTForImageClassification,
)
from dlrover_tpu_torch.parallel.sharding import param_logical_axes  # noqa: E402
from torch_family_parity import jax_grads, jax_logits, setup  # noqa: E402

CASES = [(dtype, scan) for dtype in ("float32", "bfloat16")
         for scan in (True, False)]


def _ids(case):
    return f"{case[0]}-{'scanned' if case[1] else 'unrolled'}"


@pytest.mark.parametrize("dtype,scan", CASES, ids=map(_ids, CASES))
def test_logits_match_jax(dtype, scan):
    s = setup("vit", dtype, scan)
    want = jax_logits(s)
    got = s["model"](torch.from_numpy(s["x"]))
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    tol = 1e-5 if dtype == "float32" else 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol)


@pytest.mark.parametrize("dtype,scan", CASES, ids=map(_ids, CASES))
def test_loss_and_grads_match_jax(dtype, scan):
    s = setup("vit", dtype, scan)
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


def test_loss_is_the_references():
    """fp32 log_softmax, one-hot, mean: equal to the reference's on the
    same logits."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 10)).astype(np.float32) * 3
    labels = rng.integers(0, 10, 6).astype(np.int32)
    want = float(JaxViT(JaxViTConfig.tiny()).loss(jnp.asarray(logits),
                                                  jnp.asarray(labels)))
    model = ViTForImageClassification(ViTConfig.tiny(), device="cpu")
    got = model.loss(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.item() == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("preset", ["base", "large", "tiny"])
def test_presets_and_param_count_match_jax(preset):
    jcfg = getattr(JaxViTConfig, preset)()
    cfg = getattr(ViTConfig, preset)()
    for f in ("image_size", "patch_size", "num_classes", "hidden_size",
              "num_layers", "num_heads", "mlp_ratio", "remat",
              "num_patches"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    images = np.zeros((1, cfg.image_size, cfg.image_size, 3), np.float32)
    shapes = jax.eval_shape(JaxViT(jcfg).init, jax.random.PRNGKey(0),
                            images)["params"]
    want = sum(int(np.prod(a.shape)) for a in
               jax.tree.leaves(nn.meta.unbox(shapes)))
    if preset == "tiny":
        model = ViTForImageClassification(cfg, device="cpu")
        assert sum(p.numel() for p in model.parameters()) == want
    fake = types.SimpleNamespace(config=cfg)
    assert ViTForImageClassification.num_params(fake) == want


def test_init_follows_the_reference():
    """A zero class token and head, N(0, 0.02) positions."""
    model = ViTForImageClassification(ViTConfig.tiny(), device="cpu")
    assert not model.cls_token.any() and not model.head.weight.any()
    assert not model.head.bias.any()
    assert abs(model.pos_embed.std().item() - 0.02) < 5e-3
    images = torch.zeros(2, 32, 32, 3)
    assert not model(images).any()  # a zero head gives zero logits


def test_every_parameter_has_logical_axes():
    model = ViTForImageClassification(ViTConfig.tiny(), device="cpu")
    axes = param_logical_axes(dict(model.named_parameters()))
    assert axes["patch_embed.weight"] == ("embed", None)
    assert axes["cls_token"] == axes["pos_embed"] == (None, None, "embed")
    assert axes["head.weight"] == ("vocab", "embed")
    assert axes["layers.0.mlp_in.weight"] == ("mlp", "embed")
    for n, a in axes.items():
        assert (a == ()) == (n.endswith(".bias") or ".ln_" in n
                             or n.startswith("ln_f")), n
