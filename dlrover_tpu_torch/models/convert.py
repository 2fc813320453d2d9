"""Map the JAX Llama's parameter tree onto the port's ``state_dict``.

The JAX model (``dlrover_tpu/models/llama.py``, ``scan_layers=True``)
stacks the layers along a leading axis under ``layers/layer`` and keeps
``nn.DenseGeneral`` kernels as ``[in, *out]``; the port keeps one module
per layer and PyTorch's ``[out, in]`` weights.  This module works on
numpy only: hand it the tree as nested dicts of numpy arrays (the caller
unboxes flax's partitioning metadata first).
"""

from typing import Dict, Mapping

import numpy as np
import torch

from dlrover_tpu_torch.models.llama import LlamaConfig


def _t(x, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(dtype)


def flax_llama_to_state_dict(
    params: Mapping, config: LlamaConfig
) -> Dict[str, torch.Tensor]:
    E, D = config.hidden_size, config.head_dim
    H, H_kv = config.num_heads, config.num_kv_heads
    dtype = config.param_dtype
    layer = params["layers"]["layer"]
    attn, mlp = layer["attn"], layer["mlp"]
    state = {
        "embed_tokens": _t(params["embed_tokens"], dtype),
        "final_norm.scale": _t(params["final_norm"]["scale"], dtype),
        "lm_head.weight": _t(np.asarray(params["lm_head"]["kernel"]).T,
                             dtype),
    }
    for i in range(config.num_layers):
        p = f"layers.{i}."
        heads = {"q_proj": H, "k_proj": H_kv, "v_proj": H_kv}
        for name, n_heads in heads.items():
            kernel = np.asarray(attn[name]["kernel"][i])  # [E, heads, D]
            state[p + f"attn.{name}.weight"] = _t(
                kernel.reshape(E, n_heads * D).T, dtype)
        o_kernel = np.asarray(attn["o_proj"]["kernel"][i])  # [H, D, E]
        state[p + "attn.o_proj.weight"] = _t(
            o_kernel.reshape(H * D, E).T, dtype)
        for name in ("gate_proj", "up_proj", "down_proj"):
            state[p + f"mlp.{name}.weight"] = _t(
                np.asarray(mlp[name]["kernel"][i]).T, dtype)
        for name in ("input_norm", "post_attn_norm"):
            state[p + f"{name}.scale"] = _t(layer[name]["scale"][i], dtype)
    return state

