"""Map the JAX models' parameter trees onto the port's ``state_dict``s.

The JAX Llama (``dlrover_tpu/models/llama.py``) stacks its layers along a
leading axis under ``layers/layer`` with ``scan_layers=True``, and keeps
one subtree per layer, ``layers_{i}/layer``, without it; the MoE Llama
(``dlrover_tpu/models/moe.py``) always keeps ``layers_{i}``.  Both keep
``nn.DenseGeneral`` kernels as ``[in, *out]``; the port keeps one module
per layer and PyTorch's ``[out, in]`` weights, and the MoE's expert
tensors in the reference's own ``[E, in, out]`` layout.  This module works
on numpy only: hand it the tree as nested dicts of numpy arrays (the
caller unboxes flax's partitioning metadata first).
"""

from typing import Dict, Mapping

import numpy as np
import torch

from dlrover_tpu_torch.models.llama import LlamaConfig


def _t(x, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(dtype)


def _layers(params: Mapping, config: LlamaConfig):
    """Each layer's subtree, from the stacked or the unrolled tree."""
    if "layers" in params:
        stacked = params["layers"]["layer"]

        def index(tree, i):
            if isinstance(tree, Mapping):
                return {k: index(v, i) for k, v in tree.items()}
            return np.asarray(tree)[i]

        return [index(stacked, i) for i in range(config.num_layers)]
    return [params[f"layers_{i}"].get("layer", params[f"layers_{i}"])
            for i in range(config.num_layers)]


def _common(params: Mapping, config: LlamaConfig, layers, mlp_state):
    """The embedding, norms, attention and head of the port's state, and
    each layer's feed-forward from ``mlp_state(prefix, layer)``."""
    E, D = config.hidden_size, config.head_dim
    H, H_kv = config.num_heads, config.num_kv_heads
    dtype = config.param_dtype
    state = {
        "embed_tokens": _t(params["embed_tokens"], dtype),
        "final_norm.scale": _t(params["final_norm"]["scale"], dtype),
        "lm_head.weight": _t(np.asarray(params["lm_head"]["kernel"]).T,
                             dtype),
    }
    for i, layer in enumerate(layers):
        p = f"layers.{i}."
        attn = layer["attn"]
        heads = {"q_proj": H, "k_proj": H_kv, "v_proj": H_kv}
        for name, n_heads in heads.items():
            kernel = np.asarray(attn[name]["kernel"])  # [E, heads, D]
            state[p + f"attn.{name}.weight"] = _t(
                kernel.reshape(E, n_heads * D).T, dtype)
        o_kernel = np.asarray(attn["o_proj"]["kernel"])  # [H, D, E]
        state[p + "attn.o_proj.weight"] = _t(
            o_kernel.reshape(H * D, E).T, dtype)
        for name in ("input_norm", "post_attn_norm"):
            state[p + f"{name}.scale"] = _t(layer[name]["scale"], dtype)
        state.update(mlp_state(p, layer))
    return state


def flax_llama_to_state_dict(
    params: Mapping, config: LlamaConfig
) -> Dict[str, torch.Tensor]:
    dtype = config.param_dtype

    def mlp_state(p, layer):
        return {p + f"mlp.{name}.weight":
                _t(np.asarray(layer["mlp"][name]["kernel"]).T, dtype)
                for name in ("gate_proj", "up_proj", "down_proj")}

    return _common(params, config, _layers(params, config), mlp_state)


def flax_moe_to_state_dict(
    params: Mapping, config: LlamaConfig
) -> Dict[str, torch.Tensor]:
    """The reference MoE Llama (``MoELlamaConfig``): the router's
    ``DenseGeneral`` kernel ``[D, E]`` becomes the port's ``[E, D]``; the
    experts' ``gate_proj``/``up_proj`` ``[E, D, H]`` and ``down_proj``
    ``[E, H, D]`` keep their layout."""
    dtype = config.param_dtype

    def mlp_state(p, layer):
        moe = layer["moe_mlp"]
        state = {p + "moe_mlp.router.weight":
                 _t(np.asarray(moe["router"]["kernel"]).T, dtype)}
        for name in ("gate_proj", "up_proj", "down_proj"):
            state[p + f"moe_mlp.{name}"] = _t(moe[name], dtype)
        return state

    return _common(params, config, _layers(params, config), mlp_state)
