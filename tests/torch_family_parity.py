"""Helpers of the GPT and ViT parity tests (not a test module: pytest does
not collect it): the same seeded numpy weights and inputs through the JAX
model and the port's, the loss and its gradients on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
import flax.linen as nn

from dlrover_tpu.models.gpt import GPT as JaxGPT
from dlrover_tpu.models.gpt import GPTConfig as JaxGPTConfig
from dlrover_tpu.models.vit import ViTConfig as JaxViTConfig
from dlrover_tpu.models.vit import ViTForImageClassification as JaxViT
from dlrover_tpu.trainer.train import cross_entropy_loss as jax_ce
from dlrover_tpu_torch.models.convert import (
    flax_gpt_to_state_dict,
    flax_vit_to_state_dict,
)
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
from dlrover_tpu_torch.models.vit import ViTConfig, ViTForImageClassification
from dlrover_tpu_torch.trainer.train import cross_entropy_loss

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def seeded(tree, seed: int):
    """Seeded numpy values for every leaf of a flax param tree: norm
    scales 1 + N(0, 0.1), biases and the class token N(0, 0.1),
    embeddings N(0, 0.02), kernels N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = str(path[-1].key)
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * noise
        if name in ("wte", "wpe", "pos_embed"):
            return 0.02 * noise
        return 0.1 * noise

    return jax.tree_util.tree_map_with_path(leaf, tree)


def setup(family: str, dtype: str, scan_layers: bool, **config):
    """(jax model, port model, numpy params, jax loss fn of the params,
    port loss fn, port forward of the inputs, inputs) of the tiny
    ``family`` in ``dtype``, from one seeded batch and seeded weights."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    if family == "gpt":
        jm = JaxGPT(JaxGPTConfig.tiny(dtype=jdt, scan_layers=scan_layers,
                                      **config))
        cfg = GPTConfig.tiny(dtype=tdt, **config)
        model, convert = GPT(cfg, device="cpu"), flax_gpt_to_state_dict
        ids = rng.integers(0, cfg.vocab_size, size=(4, 17))
        x, y = ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)

        def jax_loss(p):
            return jax_ce(jm.apply({"params": p}, x), y)

        def port_loss():
            return cross_entropy_loss(model(torch.from_numpy(x)),
                                      torch.from_numpy(y))
    else:
        jm = JaxViT(JaxViTConfig.tiny(dtype=jdt, scan_layers=scan_layers,
                                      **config))
        cfg = ViTConfig.tiny(dtype=tdt, **config)
        model = ViTForImageClassification(cfg, device="cpu")
        convert = flax_vit_to_state_dict
        x = rng.standard_normal((4, cfg.image_size, cfg.image_size,
                                 3)).astype(np.float32)
        y = rng.integers(0, cfg.num_classes, 4).astype(np.int32)

        def jax_loss(p):
            return jm.loss(jm.apply({"params": p}, x), y)

        def port_loss():
            return model.loss(model(torch.from_numpy(x)), torch.from_numpy(y))

    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)["params"]
    params = seeded(nn.meta.unbox(shapes), 1)
    model.load_state_dict(convert(params, cfg))
    return dict(jax_model=jm, model=model, cfg=cfg, params=params,
                convert=convert, jax_loss=jax_loss, port_loss=port_loss,
                x=x, y=y)


def jax_logits(s) -> np.ndarray:
    return np.asarray(jax.jit(lambda p: s["jax_model"].apply(
        {"params": p}, s["x"]))(s["params"]), np.float32)


def jax_grads(s):
    """(loss, the port-layout gradients as numpy) of the JAX model."""
    loss, grads = jax.jit(jax.value_and_grad(s["jax_loss"]))(s["params"])
    grads = jax.tree.map(np.asarray, grads)
    return float(loss), {k: v.numpy() for k, v in
                         s["convert"](grads, s["cfg"]).items()}
