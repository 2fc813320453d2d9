"""GPT-2 family (nanoGPT-class) in PyTorch.

Port of ``dlrover_tpu/models/gpt.py`` with the same numerics: fp32 master
params, bf16 compute, flax's ``LayerNorm`` (eps 1e-6, fp32 statistics,
var = E[x^2] - E[x]^2), flax's ``DenseGeneral`` (the product rounded to
the compute dtype, then the bias added in it), the tanh GELU of
``nn.gelu`` rounded per op as jitted JAX does, the plain causal attention core (``reference_attention``:
the reference uses no kernel here, so neither does the port) and fp32
logits from the weight-tied head, ``x.float() @ wte.float().T``; ``wte``
gets its gradient from the embedding and the head.

Layers sit in an ``nn.ModuleList``; ``remat`` checkpoints each with
``torch.utils.checkpoint``.  The reference's ``scan_layers`` changes only
its checkpoint layout (``h/block/...`` stacked, or ``h_{i}``), which
``models/convert.py`` reads either way, so the port has no such field.
Linear weights are ``[*out, in]``: the fused ``attn_qkv`` is
``[3, heads * head_dim, embed]`` (the reference's ``[embed, 3, heads,
head_dim]``), ``attn_proj`` ``[embed, heads * head_dim]``.

Dropout runs only with ``deterministic=False`` (the reference's default
is deterministic, and its ``Trainer`` never passes False) and then needs
an explicit ``generator``; the masks are drawn before each layer, so
remat's recompute applies the same ones.

``shard_tensor_parallel(group)`` splits the model over a mesh's ``tp``
axis: ``attn_qkv`` column-parallel over heads (the ``3`` kept), ``attn_proj``
row-parallel, ``mlp_fc`` column- and ``mlp_proj`` row-parallel, and
``wte`` vocab-parallel in the embedding and in the tied head (the model
then returns this rank's vocab columns of the logits; the trainer's loss
is ``vocab_parallel_cross_entropy``).  Biases stay whole on every rank,
as the reference keeps them, and a column shard reads its chunk
(``slice_to_tp``).  The GPT under ``cp`` or ``ep`` is refused in the
forward (``ROADMAP_GPT_VIT_CP_EP``); a state can still be made.
"""

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.device import DeviceLike, resolve_device
from dlrover_tpu_torch.ops.attention import reference_attention
from dlrover_tpu_torch.parallel.tensor_parallel import (
    SplitModel,
    copy_to_tp,
    reduce_from_tp,
    slice_to_tp,
    vocab_parallel_embedding,
)

ROADMAP_GPT_VIT_CP_EP = "ROADMAP queue 1 item 10 (GPT and ViT under cp and ep)"
#: the span around the attention core (the profiled split reads it)
ATTENTION_SPAN = "attention.core"


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    block_size: int = 1024
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True  # recompute each block's activations

    @classmethod
    def gpt2(cls, **kw) -> "GPTConfig":
        return cls(**kw)

    @classmethod
    def gpt2_xl(cls, **kw) -> "GPTConfig":
        """1.5B: the reference Flash-Checkpoint benchmark size."""
        return cls(n_embd=1600, n_layer=48, n_head=25, **kw)

    @classmethod
    def gpt2_large(cls, **kw) -> "GPTConfig":
        return cls(n_embd=1280, n_layer=36, n_head=20, **kw)

    @classmethod
    def tiny(cls, **kw) -> "GPTConfig":
        defaults = dict(vocab_size=256, n_embd=64, n_layer=2, n_head=4,
                        block_size=64)
        defaults.update(kw)
        return cls(**defaults)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=..., param_dtype=...)``: fp32 mean and
    ``var = max(0, E[x^2] - E[x]^2)``, ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias`` in fp32, cast to the compute dtype."""

    def __init__(self, dim: int, dtype, param_dtype, device,
                 eps: float = 1e-6):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=param_dtype,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=param_dtype,
                                             device=device))

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32.square().mean(dim=-1, keepdim=True)
               - mean.square()).clamp(min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.float()
        return ((x32 - mean) * mul + self.bias.float()).to(self.dtype)


class Dense(nn.Module):
    """flax ``nn.DenseGeneral(dtype=...)``: ``x @ W^T`` rounded to
    ``dtype``, then the bias added in ``dtype``.  ``weight`` is ``[*out,
    in]``.  Over tp, a ``"column"`` layer holds a chunk of its last output
    dim and reads its chunk of the whole bias; a ``"row"`` layer holds a
    chunk of its input dim, sums the partial products over tp and adds the
    whole bias once."""

    def __init__(self, n_in: int, out, dtype, param_dtype, device,
                 parallel=None):
        super().__init__()
        out = tuple(out) if isinstance(out, (tuple, list)) else (out,)
        self.weight = nn.Parameter(torch.empty(*out, n_in, dtype=param_dtype,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(*out, dtype=param_dtype,
                                             device=device))
        self.dtype, self.parallel = dtype, parallel
        self.tp = None

    def forward(self, x):
        dt, w, bias = self.dtype, self.weight, self.bias
        if self.parallel == "column":
            x = copy_to_tp(x, self.tp)
            bias = slice_to_tp(bias, self.tp, bias.dim() - 1)
        y = F.linear(x.to(dt), w.reshape(-1, w.shape[-1]).to(dt))
        if self.parallel == "row":
            y = reduce_from_tp(y, self.tp)
        return y + bias.reshape(-1).to(dt)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu`` (the tanh form) as jitted JAX computes it: the
    constants in ``x``'s dtype and each op rounded to it (in bf16,
    ``F.gelu``'s one rounding of the fp32 result differs by up to an ulp
    on ~40% of entries)."""
    c = x.new_tensor(math.sqrt(2.0 / math.pi))
    k = x.new_tensor(0.044715)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * x ** 3))))


def dropout(x, keep, rate: float):
    """flax ``nn.Dropout``: the entries ``keep`` marks (None: all, the
    deterministic forward) scaled by 1 / (1 - rate), the others zero."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def residual_sum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y`` as the LayerNorm after an add reads it under ``jit``: XLA
    fuses the add into the norm's fp32 upcast, so the norm sees the sum
    unrounded, while the stream keeps the rounded sum.  The port follows
    it within a block; between blocks the reference's scan carries the
    rounded stream (ROADMAP queue 3 notes where jitted XLA fuses further:
    the unrolled layout across blocks, and inside the scan body)."""
    return x.float() + y.float()


def causal_mask(S: int, device) -> torch.Tensor:
    return torch.ones(S, S, dtype=torch.bool, device=device).tril()[None,
                                                                    None]


class Block(nn.Module):
    def __init__(self, config: GPTConfig, device):
        super().__init__()
        E, H, dt, pdt = (config.n_embd, config.n_head, config.dtype,
                         config.param_dtype)
        self.n_head, self.rate = H, config.dropout
        self.ln_1 = LayerNorm(E, dt, pdt, device)
        self.attn_qkv = Dense(E, (3, E), dt, pdt, device, "column")
        self.attn_proj = Dense(E, E, dt, pdt, device, "row")
        self.ln_2 = LayerNorm(E, dt, pdt, device)
        self.mlp_fc = Dense(E, 4 * E, dt, pdt, device, "column")
        self.mlp_proj = Dense(4 * E, E, dt, pdt, device, "row")

    def forward(self, x, keeps=(None, None)):
        """``keeps``: the two dropout masks (``GPT._keeps``)."""
        B, S, E = x.shape
        head_dim = E // self.n_head
        qkv = self.attn_qkv(self.ln_1(x)).view(B, S, 3, -1, head_dim)
        q, k, v = qkv.unbind(2)
        with record_function(ATTENTION_SPAN):
            att = reference_attention(q, k, v, causal_mask(S, x.device))
        att = dropout(self.attn_proj(att.reshape(B, S, -1)), keeps[0],
                      self.rate)
        h = gelu(self.mlp_fc(self.ln_2(residual_sum(x, att))))
        return x + att + dropout(self.mlp_proj(h), keeps[1], self.rate)


class DenseFamily(SplitModel, nn.Module):
    """What GPT and ViT share on a mesh: their shards over tp
    (``tp_split``; ``_tp_sizes`` are the sizes tp must divide), and the
    refusal of cp and ep in the forward (``_check_axes``)."""

    def _tp_sizes(self):
        raise NotImplementedError

    @torch.no_grad()
    def shard_tensor_parallel(self, group) -> None:
        """Keep this rank's shard of every parameter in ``tp_split``;
        raises ``ValueError`` where tp does not divide a split size."""
        self._check_tp_divides(group, self._tp_sizes())
        self._keep_shards(self.tp_dims(), group, "tp")

    def shard_expert_parallel(self, group) -> None:
        self.ep = group  # refused in the forward

    def set_context_parallel(self, group) -> None:
        self.cp = group  # refused in the forward

    def set_data_parallel(self, groups) -> None:
        """No statistic over the global batch."""

    def _check_axes(self) -> None:
        for axis in ("cp", "ep"):
            group = getattr(self, axis)
            if group is not None:
                raise NotImplementedError(
                    f"{type(self).__name__} over {axis}={group.world}: GPT "
                    f"and ViT train over dp, fsdp and tp; {axis} is not "
                    f"ported for them yet ({ROADMAP_GPT_VIT_CP_EP})")


class GPT(DenseFamily):
    """Decoder-only LM with a weight-tied head.  Weights are drawn from
    ``seed`` on ``device`` with the JAX model's initializers (N(0, 0.02)
    kernels and embeddings, zero biases, unit norm scales); a parity test
    loads converted weights (``models/convert.py``)."""

    tp_split = {"attn_qkv.weight": 1, "attn_proj.weight": 1,
                "mlp_fc.weight": 0, "mlp_proj.weight": 1, "wte": 0}

    def __init__(self, config: GPTConfig, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        self.config = config
        device = resolve_device(device)
        E, pdt = config.n_embd, config.param_dtype
        self.wte = nn.Parameter(torch.empty(config.vocab_size, E, dtype=pdt,
                                            device=device))
        self.wpe = nn.Parameter(torch.empty(config.block_size, E, dtype=pdt,
                                            device=device))
        self.layers = nn.ModuleList(Block(config, device)
                                    for _ in range(config.n_layer))
        self.ln_f = LayerNorm(E, config.dtype, pdt, device)
        self.tp = self.cp = self.ep = None
        self.init_weights(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for p in (self.wte, self.wpe):
            nn.init.normal_(p, 0.0, 0.02, generator=generator)
        for module in self.modules():
            if isinstance(module, Dense):
                nn.init.normal_(module.weight, 0.0, 0.02, generator=generator)

    def _keeps(self, x, generator):
        """A block's two dropout masks (True: kept)."""
        keep = 1.0 - self.config.dropout
        return tuple(torch.rand(x.shape, generator=generator,
                                device=x.device) < keep for _ in range(2))

    def forward(self, input_ids: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator = None) -> torch.Tensor:
        self._check_axes()
        cfg = self.config
        S = input_ids.shape[1]
        drop = not deterministic and cfg.dropout > 0
        if drop and generator is None:
            raise ValueError("dropout with deterministic=False needs an "
                             "explicit generator")
        wte = self.wte.to(cfg.dtype)
        if self.tp is None:
            x = F.embedding(input_ids, wte)
        else:
            x = vocab_parallel_embedding(input_ids, wte, self.tp)
        x = x + self.wpe.to(cfg.dtype)[:S]
        for layer in self.layers:
            keeps = self._keeps(x, generator) if drop else (None, None)
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, keeps, use_reentrant=False)
            else:
                x = layer(x, keeps)
        x = copy_to_tp(self.ln_f(x), self.tp)
        # the tied head: fp32 logits (this rank's vocab columns over tp)
        return x.float() @ self.wte.float().t()

    def _tp_sizes(self):
        cfg = self.config
        return (("n_head", cfg.n_head), ("mlp width", 4 * cfg.n_embd),
                ("vocab_size", cfg.vocab_size))

    def num_params(self) -> int:
        cfg = self.config
        E = cfg.n_embd
        per_layer = 12 * E * E + 13 * E  # qkv, proj, fc, proj, 2 norms
        return ((cfg.vocab_size + cfg.block_size) * E
                + cfg.n_layer * per_layer + 2 * E)
