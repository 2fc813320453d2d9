"""Llama-family decoder in PyTorch.

Port of ``dlrover_tpu/models/llama.py`` with the same numerics: fp32
master params, bf16 compute, fp32 RMSNorm statistics, split-half rotary
embeddings, GQA attention, SwiGLU MLP and fp32 logits.  Layers sit in an
``nn.ModuleList`` (the JAX model scans a stacked layer; ``models/convert.py``
maps one layout onto the other), and ``remat`` checkpoints each layer with
``torch.utils.checkpoint``, so the layer forward (flash kernel included)
runs again in the backward, as under ``nn.remat``.

Linear weights use PyTorch's ``[out_features, in_features]`` layout; the
q/k/v projections produce heads as ``[..., heads * head_dim]``.
"""

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.device import DeviceLike, resolve_device
from dlrover_tpu_torch.ops.attention import (
    flash_attention,
    reference_attention,
)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    attention_impl: str = "reference"  # reference | flash

    def __post_init__(self):
        valid = ("reference", "flash")
        if self.attention_impl not in valid:
            raise ValueError(
                f"attention_impl={self.attention_impl!r} not in {valid}"
            )
        if self.num_heads % self.num_kv_heads != 0:
            raise ValueError("num_heads must be a multiple of num_kv_heads")

    @classmethod
    def llama2_7b(cls, **kw) -> "LlamaConfig":
        return cls(**kw)

    @classmethod
    def llama2_1b(cls, **kw) -> "LlamaConfig":
        return cls(
            hidden_size=2048, intermediate_size=5504, num_layers=22,
            num_heads=16, num_kv_heads=16, head_dim=128, **kw,
        )

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """Test/debug size: runs on the CPU in seconds."""
        defaults = dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_seq_len=128,
        )
        defaults.update(kw)
        return cls(**defaults)


def _rope_tables(seq_len: int, head_dim: int, theta: float, device):
    """cos/sin of the rotary angles, [1, S, 1, D/2] fp32."""
    freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim
    ))
    positions = torch.arange(seq_len, device=device, dtype=torch.float32)
    angles = positions[:, None] * freq  # [S, D/2]
    return angles.cos()[None, :, None, :], angles.sin()[None, :, None, :]


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotary position embedding, split-half convention; x: [B, S, H, D]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def _linear(x: torch.Tensor, weight: torch.Tensor, dtype: torch.dtype):
    """A dense layer in the compute dtype (flax ``DenseGeneral(dtype=...)``)."""
    return F.linear(x.to(dtype), weight.to(dtype))


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator):
    """flax ``lecun_normal``: truncated normal (±2σ), σ = sqrt(1/fan_in)
    corrected for the truncation."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype, param_dtype, device):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=param_dtype, device=device)
        )

    def forward(self, x):
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        normed = x32 * torch.rsqrt(var + self.eps)
        return (normed * self.scale.float()).to(self.dtype)


class Attention(nn.Module):
    def __init__(self, config: LlamaConfig, device):
        super().__init__()
        self.config = config
        E, D = config.hidden_size, config.head_dim
        H, H_kv = config.num_heads, config.num_kv_heads

        def linear(n_in, n_out):
            return nn.Linear(n_in, n_out, bias=False, device=device,
                             dtype=config.param_dtype)

        self.q_proj = linear(E, H * D)
        self.k_proj = linear(E, H_kv * D)
        self.v_proj = linear(E, H_kv * D)
        self.o_proj = linear(H * D, E)

    def forward(self, x, cos, sin):
        cfg = self.config
        B, S, _ = x.shape
        dt = cfg.dtype
        q = _linear(x, self.q_proj.weight, dt).view(
            B, S, cfg.num_heads, cfg.head_dim)
        k = _linear(x, self.k_proj.weight, dt).view(
            B, S, cfg.num_kv_heads, cfg.head_dim)
        v = _linear(x, self.v_proj.weight, dt).view(
            B, S, cfg.num_kv_heads, cfg.head_dim)
        q = _rope(q, cos, sin)
        k = _rope(k, cos, sin)
        out = self._attend(q, k, v)
        return _linear(out.reshape(B, S, -1), self.o_proj.weight, dt)

    def _attend(self, q, k, v):
        if self.config.attention_impl == "flash":
            return flash_attention(q, k, v, causal=True)
        S = q.shape[1]
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        return reference_attention(q, k, v, mask[None, None])


class MLP(nn.Module):
    def __init__(self, config: LlamaConfig, device):
        super().__init__()
        self.dtype = config.dtype
        E, F_ = config.hidden_size, config.intermediate_size

        def linear(n_in, n_out):
            return nn.Linear(n_in, n_out, bias=False, device=device,
                             dtype=config.param_dtype)

        self.gate_proj = linear(E, F_)
        self.up_proj = linear(E, F_)
        self.down_proj = linear(F_, E)

    def forward(self, x):
        gate = _linear(x, self.gate_proj.weight, self.dtype)
        up = _linear(x, self.up_proj.weight, self.dtype)
        return _linear(F.silu(gate) * up, self.down_proj.weight, self.dtype)


class DecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device):
        super().__init__()
        norm = (config.hidden_size, config.rms_norm_eps, config.dtype,
                config.param_dtype, device)
        self.input_norm = RMSNorm(*norm)
        self.attn = Attention(config, device)
        self.post_attn_norm = RMSNorm(*norm)
        self.mlp = MLP(config, device)

    def forward(self, x, cos, sin):
        x = x + self.attn(self.input_norm(x), cos, sin)
        return x + self.mlp(self.post_attn_norm(x))


class _Fp32Logits(torch.autograd.Function):
    """logits = x @ w^T with fp32 accumulation and fp32 output from
    compute-dtype operands (JAX ``preferred_element_type=float32``).  On
    the card a bf16 product asks cuBLAS for the fp32 output directly;
    elsewhere the operands are upcast, which gives the same exact products.
    The backward casts the fp32 cotangent to the compute dtype and runs the
    two products there, as a bf16 matrix unit would."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        if x2.is_cuda and x2.dtype != torch.float32:
            return torch.mm(x2, w.t(), out_dtype=torch.float32)
        return torch.mm(x2.float(), w.float().t())

    @staticmethod
    def backward(ctx, grad):
        x2, w = ctx.saved_tensors
        grad = grad.to(x2.dtype)
        return grad @ w, grad.t() @ x2


class LMHead(nn.Module):
    """Final projection to fp32 logits; at a 32k vocab it is ~10% of a 1B
    model's FLOPs, so it runs at the compute dtype's rate."""

    def __init__(self, config: LlamaConfig, device):
        super().__init__()
        self.dtype = config.dtype
        self.weight = nn.Parameter(torch.empty(
            config.vocab_size, config.hidden_size,
            dtype=config.param_dtype, device=device,
        ))

    def forward(self, x):
        x2 = x.to(self.dtype).reshape(-1, x.shape[-1])
        logits = _Fp32Logits.apply(x2, self.weight.to(self.dtype))
        return logits.view(*x.shape[:-1], -1)


class LlamaForCausalLM(nn.Module):
    """Decoder-only LM.  Weights are drawn from ``seed`` on ``device`` with
    the JAX model's initializers (embedding N(0, 0.02), lecun-normal dense
    kernels, unit norm scales); the values differ from JAX's, so a parity
    test loads converted weights (``models/convert.py``)."""

    def __init__(self, config: LlamaConfig, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        self.config = config
        device = resolve_device(device)
        self.embed_tokens = nn.Parameter(torch.empty(
            config.vocab_size, config.hidden_size,
            dtype=config.param_dtype, device=device,
        ))
        self.layers = nn.ModuleList(
            DecoderLayer(config, device) for _ in range(config.num_layers)
        )
        self.final_norm = RMSNorm(
            config.hidden_size, config.rms_norm_eps, config.dtype,
            config.param_dtype, device,
        )
        self.lm_head = LMHead(config, device)
        self.init_weights(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.embed_tokens, 0.0, 0.02, generator=generator)
        for module in self.modules():
            if isinstance(module, nn.Linear):
                _lecun_normal_(module.weight, generator)
            elif isinstance(module, RMSNorm):
                module.scale.fill_(1.0)
        _lecun_normal_(self.lm_head.weight, generator)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        S = input_ids.shape[1]
        x = F.embedding(input_ids, self.embed_tokens.to(cfg.dtype))
        cos, sin = _rope_tables(S, cfg.head_dim, cfg.rope_theta, x.device)
        for layer in self.layers:
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, cos, sin, use_reentrant=False)
            else:
                x = layer(x, cos, sin)
        return self.lm_head(self.final_norm(x))

    def num_params(self) -> int:
        cfg = self.config
        attn = cfg.hidden_size * cfg.head_dim * (
            cfg.num_heads * 2 + cfg.num_kv_heads * 2
        )
        mlp = 3 * cfg.hidden_size * cfg.intermediate_size
        per_layer = attn + mlp + 2 * cfg.hidden_size
        return (
            cfg.vocab_size * cfg.hidden_size * 2
            + cfg.num_layers * per_layer
            + cfg.hidden_size
        )
