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

``shard_tensor_parallel(group)`` splits the model over a mesh's ``tp``
axis (``parallel/tensor_parallel.py``): each rank keeps its heads
(``H/tp`` query and ``H_kv/tp`` key/value heads, so the flash kernel runs
unchanged on the local heads), its ``F/tp`` MLP columns and its ``V/tp``
vocab rows; the model then returns this rank's vocab shard of the logits.

``set_context_parallel(group)`` runs it over a mesh's ``cp`` axis: each
rank holds a contiguous chunk of the sequence (``parallel/sharding.py``
``shard_batch``) and takes the rows of the rotary tables at its chunk's
global positions.  ``attention_impl="ring"`` then runs ring attention
(``ops/ring_attention.py``); ``"flash"`` runs the flash kernels in a ring
of blocks (``ring_flash_attention``), the function the reference's flash
attention computes when GSPMD splits its sequence; ``"reference"``
all-gathers the keys and values over ``cp`` and masks by global
position, which is what GSPMD computes for the reference core on a
sequence-sharded mesh.  ``"ring"`` without a ``cp`` group
warns and runs the reference core, as the reference does without a cp
mesh.  ``shard_expert_parallel`` (the MoE's experts over ``ep``,
``models/moe.py``) and ``set_data_parallel`` (the groups of a batch
statistic) do nothing here: the dense model has no expert and no batch
statistic, and its ``ep`` ranks compute the same step.
"""

import dataclasses
import math
import warnings

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.device import DeviceLike, resolve_device
from dlrover_tpu_torch.ops.attention import (
    flash_attention,
    reference_attention,
)
from dlrover_tpu_torch.ops.ring_attention import (
    ring_attention,
    ring_flash_attention,
)
from dlrover_tpu_torch.parallel.tensor_parallel import (
    SplitModel,
    copy_to_tp,
    gather_seq,
    reduce_from_tp,
    vocab_parallel_embedding,
)

# the dim each parameter is split along over tp (the Megatron layout):
# 0 = output features (column shards), 1 = input features (row shards);
# by the parameter's name within its module
TP_DIMS = {"q_proj.weight": 0, "k_proj.weight": 0, "v_proj.weight": 0,
           "o_proj.weight": 1, "gate_proj.weight": 0, "up_proj.weight": 0,
           "down_proj.weight": 1, "embed_tokens": 0, "lm_head.weight": 0}


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
    attention_impl: str = "reference"  # reference | flash | ring

    def __post_init__(self):
        valid = ("reference", "flash", "ring")
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
        """The 1B preset; ``kw`` may override any field (a depth cut)."""
        defaults = dict(
            hidden_size=2048, intermediate_size=5504, num_layers=22,
            num_heads=16, num_kv_heads=16, head_dim=128,
        )
        defaults.update(kw)
        return cls(**defaults)

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


def _rope_tables(seq_len: int, head_dim: int, theta: float, device,
                 offset: int = 0):
    """cos/sin of the rotary angles at positions ``[offset, offset +
    seq_len)``, [1, S, 1, D/2] fp32."""
    freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim
    ))
    positions = torch.arange(offset, offset + seq_len, device=device,
                             dtype=torch.float32)
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


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator,
                   fan_in: int = 0):
    """flax ``lecun_normal``: truncated normal (±2σ), σ = sqrt(1/fan_in)
    corrected for the truncation; ``fan_in`` defaults to an ``[out, in]``
    weight's."""
    std = math.sqrt(1.0 / (fan_in or weight.shape[1])) / 0.87962566103423978
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
        self.tp = None  # the tp group once sharded
        self.cp = None  # the cp group: this rank holds a sequence chunk

    def forward(self, x, cos, sin):
        cfg = self.config
        B, S, _ = x.shape
        dt, D = cfg.dtype, cfg.head_dim
        x = copy_to_tp(x, self.tp)
        # the local head counts (H/tp, H_kv/tp) follow from the shards
        q = _linear(x, self.q_proj.weight, dt).view(B, S, -1, D)
        k = _linear(x, self.k_proj.weight, dt).view(B, S, -1, D)
        v = _linear(x, self.v_proj.weight, dt).view(B, S, -1, D)
        q = _rope(q, cos, sin)
        k = _rope(k, cos, sin)
        out = self._attend(q, k, v)
        out = _linear(out.reshape(B, S, -1), self.o_proj.weight, dt)
        return reduce_from_tp(out, self.tp)

    def _attend(self, q, k, v):
        impl, cp = self.config.attention_impl, self.cp
        if impl == "flash":
            if cp is not None:
                return ring_flash_attention(q, k, v, cp, causal=True)
            return flash_attention(q, k, v, causal=True)
        if impl == "ring":
            # causal only: the model builds no padding mask
            if cp is not None:
                return ring_attention(q, k, v, cp, causal=True)
            warnings.warn(
                "attention_impl='ring' without a cp group of more than one "
                "rank: running reference attention (full S x S scores)",
                stacklevel=2)
        # the local queries against every key, masked by global position
        k, v = gather_seq(k, cp), gather_seq(v, cp)
        S_q, S = q.shape[1], k.shape[1]
        offset = 0 if cp is None else cp.rank * S_q
        rows = torch.arange(offset, offset + S_q, device=q.device)
        mask = rows[:, None] >= torch.arange(S, device=q.device)[None, :]
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
        self.tp = None

    def forward(self, x):
        x = copy_to_tp(x, self.tp)
        gate = _linear(x, self.gate_proj.weight, self.dtype)
        up = _linear(x, self.up_proj.weight, self.dtype)
        out = _linear(F.silu(gate) * up, self.down_proj.weight, self.dtype)
        return reduce_from_tp(out, self.tp)


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
    model's FLOPs, so it runs at the compute dtype's rate.  Sharded over
    tp it gives this rank's vocab columns of the logits."""

    def __init__(self, config: LlamaConfig, device):
        super().__init__()
        self.dtype = config.dtype
        self.weight = nn.Parameter(torch.empty(
            config.vocab_size, config.hidden_size,
            dtype=config.param_dtype, device=device,
        ))
        self.tp = None

    def forward(self, x):
        x = copy_to_tp(x, self.tp)
        x2 = x.to(self.dtype).reshape(-1, x.shape[-1])
        logits = _Fp32Logits.apply(x2, self.weight.to(self.dtype))
        return logits.view(*x.shape[:-1], -1)


class LlamaForCausalLM(SplitModel, nn.Module):
    """Decoder-only LM.  Weights are drawn from ``seed`` on ``device`` with
    the JAX model's initializers (embedding N(0, 0.02), lecun-normal dense
    kernels, unit norm scales); the values differ from JAX's, so a parity
    test loads converted weights (``models/convert.py``)."""

    layer_class = DecoderLayer
    #: the dims split over tp (``SplitModel``; the dense model splits
    #: nothing over ep)
    tp_split = TP_DIMS
    #: checkpoint each layer when ``config.remat`` (the MoE model never does)
    remat_layers = True

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
            self.layer_class(config, device)
            for _ in range(config.num_layers)
        )
        self.final_norm = RMSNorm(
            config.hidden_size, config.rms_norm_eps, config.dtype,
            config.param_dtype, device,
        )
        self.lm_head = LMHead(config, device)
        self.tp = None
        self.cp = None
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
        table = self.embed_tokens.to(cfg.dtype)
        if self.tp is None:
            x = F.embedding(input_ids, table)
        else:
            x = vocab_parallel_embedding(input_ids, table, self.tp)
        offset = 0 if self.cp is None else self.cp.rank * S
        cos, sin = _rope_tables(S, cfg.head_dim, cfg.rope_theta, x.device,
                                offset)
        for layer in self.layers:
            if cfg.remat and self.remat_layers and torch.is_grad_enabled():
                x = checkpoint(layer, x, cos, sin, use_reentrant=False)
            else:
                x = layer(x, cos, sin)
        return self.lm_head(self.final_norm(x))

    @torch.no_grad()
    def shard_tensor_parallel(self, group) -> None:
        """Keep this rank's shard of every parameter that ``TP_DIMS``
        splits (``group``: the tp axis's ``DpGroup``); the others stay
        whole.  Raises ``ValueError`` where tp does not divide the heads,
        the MLP width or the vocab: GSPMD would pad there, the port does
        not."""
        cfg = self.config
        self._check_tp_divides(group, (
            ("num_kv_heads", cfg.num_kv_heads), ("num_heads", cfg.num_heads),
            ("intermediate_size", cfg.intermediate_size),
            ("vocab_size", cfg.vocab_size)))
        self._keep_shards(self.tp_dims(), group, "tp")

    def shard_expert_parallel(self, group) -> None:
        """Keep this rank's experts (``ep_split``; none in the dense
        model, whose ``ep`` ranks then compute the same step)."""
        self._keep_shards(self.ep_dims(), group, "ep")

    def set_context_parallel(self, group) -> None:
        """Run over ``group``, the cp axis's ``DpGroup`` (module
        docstring): every module that holds a ``cp`` takes it."""
        for module in self.modules():
            if hasattr(module, "cp"):
                module.cp = group

    def set_data_parallel(self, groups) -> None:
        """The groups of the data axes, for a statistic over the global
        batch; the dense model has none."""

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
