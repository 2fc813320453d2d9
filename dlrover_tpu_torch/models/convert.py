"""Map the JAX models' parameter trees onto the port's ``state_dict``s.

The JAX Llama (``dlrover_tpu/models/llama.py``) stacks its layers along a
leading axis under ``layers/layer`` with ``scan_layers=True``, and keeps
one subtree per layer, ``layers_{i}/layer``, without it; the MoE Llama
(``dlrover_tpu/models/moe.py``) always keeps ``layers_{i}``.  GPT and ViT
stack theirs under ``h/block`` and ``encoder/block``, or keep ``h_{i}`` and
``encoder_{i}``.  All keep ``nn.DenseGeneral`` kernels as ``[in, *out]``
(GPT's fused ``attn_qkv`` ``[embed, 3, heads, head_dim]``, ``attn_proj``
``[heads, head_dim, embed]``) and ViT's patch conv kernel as ``[P, P, C,
D]``; the port keeps one module per layer and PyTorch's ``[*out, in]``
weights (``attn_qkv`` ``[3, heads * head_dim, embed]``, the patch rows'
``[D, P*P*C]``), and the MoE's expert tensors in the reference's own
``[E, in, out]`` layout.  This module works
on numpy only: hand it the tree as nested dicts of numpy arrays (the
caller unboxes flax's partitioning metadata first).
"""

from typing import Dict, Mapping

import numpy as np
import torch

from dlrover_tpu_torch.models.llama import LlamaConfig


def _t(x, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(dtype)


def _layers(params: Mapping, num_layers: int, name: str = "layers",
            inner: str = "layer"):
    """Each layer's subtree, from the stacked tree (``name/inner``) or the
    unrolled one (``name_{i}``, or ``name_{i}/inner``)."""
    if name in params:
        stacked = params[name][inner]

        def index(tree, i):
            if isinstance(tree, Mapping):
                return {k: index(v, i) for k, v in tree.items()}
            return np.asarray(tree)[i]

        return [index(stacked, i) for i in range(num_layers)]
    return [params[f"{name}_{i}"].get(inner, params[f"{name}_{i}"])
            for i in range(num_layers)]


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

    return _common(params, config,
                   _layers(params, config.num_layers), mlp_state)


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

    return _common(params, config,
                   _layers(params, config.num_layers), mlp_state)


def _dense(tree: Mapping, n_in_dims: int, dtype) -> Dict[str, torch.Tensor]:
    """A ``DenseGeneral``'s kernel ``[*in, *out]`` (``n_in_dims`` input
    dims) as ``[*out, in]`` (the output dims kept, the input dims
    flattened), and its bias; GPT's ``attn_qkv`` ``[E, 3, H, D]`` becomes
    ``[3, H * D, E]``."""
    kernel = np.asarray(tree["kernel"])
    n_in = int(np.prod(kernel.shape[:n_in_dims]))
    out = kernel.shape[n_in_dims:]
    weight = kernel.reshape(n_in, -1).T.reshape(*out, n_in)
    bias = np.asarray(tree["bias"])
    if len(out) == 3:  # (3, heads, head_dim): heads * head_dim merged
        weight = weight.reshape(out[0], out[1] * out[2], n_in)
        bias = bias.reshape(out[0], -1)
    return {"weight": _t(weight, dtype), "bias": _t(bias, dtype)}


def _blocks(layers, names, dtype) -> Dict[str, torch.Tensor]:
    """The port's ``layers.{i}.*`` of GPT or ViT blocks: ``names`` maps
    each dense layer to its count of input dims; the two LayerNorms."""
    state = {}
    for i, layer in enumerate(layers):
        for name, n_in_dims in names.items():
            for leaf, t in _dense(layer[name], n_in_dims, dtype).items():
                state[f"layers.{i}.{name}.{leaf}"] = t
        for name in ("ln_1", "ln_2"):
            for leaf in ("scale", "bias"):
                state[f"layers.{i}.{name}.{leaf}"] = _t(layer[name][leaf],
                                                        dtype)
    return state


def _norm(tree: Mapping, prefix: str, dtype) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.{leaf}": _t(tree[leaf], dtype)
            for leaf in ("scale", "bias")}


def flax_gpt_to_state_dict(params: Mapping, config
                           ) -> Dict[str, torch.Tensor]:
    """The reference GPT (``GPTConfig``, either ``scan_layers``) as the
    port's ``models/gpt.py`` ``GPT`` state."""
    dtype = config.param_dtype
    layers = _layers(params, config.n_layer, "h", "block")
    state = {"wte": _t(params["wte"], dtype), "wpe": _t(params["wpe"], dtype)}
    state.update(_blocks(layers, {"attn_qkv": 1, "attn_proj": 2,
                                  "mlp_fc": 1, "mlp_proj": 1}, dtype))
    state.update(_norm(params["ln_f"], "ln_f", dtype))
    return state


def flax_vit_to_state_dict(params: Mapping, config
                           ) -> Dict[str, torch.Tensor]:
    """The reference ViT (``ViTConfig``, either ``scan_layers``) as the
    port's ``models/vit.py`` state: the patch conv's kernel ``[P, P, C,
    D]`` is the patch rows' weight ``[D, P*P*C]``, in ``(ph, pw, c)``
    order."""
    dtype = config.param_dtype
    layers = _layers(params, config.num_layers, "encoder", "block")
    conv = params["patch_embed"]
    kernel = np.asarray(conv["kernel"])
    state = {
        "patch_embed.weight": _t(kernel.reshape(-1, kernel.shape[-1]).T,
                                 dtype),
        "patch_embed.bias": _t(conv["bias"], dtype),
        "cls_token": _t(params["cls_token"], dtype),
        "pos_embed": _t(params["pos_embed"], dtype),
    }
    state.update(_blocks(layers, {"attn_qkv": 1, "attn_proj": 2,
                                  "mlp_in": 1, "mlp_out": 1}, dtype))
    state.update(_norm(params["ln_f"], "ln_f", dtype))
    state.update({f"head.{k}": v for k, v in
                  _dense(params["head"], 1, dtype).items()})
    return state
