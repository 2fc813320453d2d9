"""Vision Transformer family in PyTorch.

Port of ``dlrover_tpu/models/vit.py``, with the numerics of the GPT port
(``models/gpt.py``: flax's ``LayerNorm`` and ``DenseGeneral``, the tanh
GELU, the plain attention core, here bidirectional).  Images come in the
reference's layout, ``[B, H, W, C]``, so one numpy batch feeds both
packages.

The reference patchifies with one stride-P conv, which XLA lowers to a
patch-row matmul.  The port writes that function directly: the images
reshaped to ``[B, N, P*P*C]`` rows in ``(ph, pw, c)`` order and a bf16
``Dense`` with bias (``patch_embed.weight`` is the conv kernel
``[P, P, C, D]`` flattened and transposed, ``[D, P*P*C]``); no conv and
no NCHW transpose.  The zero-initialised ``cls_token`` is prepended and
``pos_embed`` added in bf16; the final ``ln_f``, the class token's row,
and an fp32 ``head`` (zero init) give ``[B, num_classes]`` logits.
``loss`` is the reference's: fp32 ``log_softmax``, one-hot, mean.

Over ``tp`` the blocks split as GPT's do (``attn_qkv`` and ``mlp_in``
column-parallel, ``attn_proj`` and ``mlp_out`` row-parallel) and the
``head`` over classes: the model returns this rank's classes of the
logits, and ``loss`` reduces its log-sum-exp over tp
(``vocab_parallel_cross_entropy``).  Under ``cp`` or ``ep`` the forward
raises, as GPT's does.
"""

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.device import DeviceLike, resolve_device
from dlrover_tpu_torch.models.gpt import (
    ATTENTION_SPAN,
    Dense,
    DenseFamily,
    LayerNorm,
    gelu,
    residual_sum,
)
from dlrover_tpu_torch.ops.attention import reference_attention
from dlrover_tpu_torch.parallel.tensor_parallel import (
    vocab_parallel_cross_entropy,
)

#: image channels (RGB; the reference's conv takes C from the images at
#: init, the port's patch rows need it up front)
CHANNELS = 3


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True

    @classmethod
    def base(cls, **kw) -> "ViTConfig":
        return cls(**kw)

    @classmethod
    def large(cls, **kw) -> "ViTConfig":
        return cls(hidden_size=1024, num_layers=24, num_heads=16, **kw)

    @classmethod
    def tiny(cls, **kw) -> "ViTConfig":
        defaults = dict(image_size=32, patch_size=8, num_classes=10,
                        hidden_size=64, num_layers=2, num_heads=4)
        defaults.update(kw)
        return cls(**defaults)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class EncoderBlock(nn.Module):
    def __init__(self, config: ViTConfig, device):
        super().__init__()
        D, dt, pdt = config.hidden_size, config.dtype, config.param_dtype
        F_ = config.mlp_ratio * D
        self.num_heads = config.num_heads
        self.ln_1 = LayerNorm(D, dt, pdt, device)
        self.attn_qkv = Dense(D, (3, D), dt, pdt, device, "column")
        self.attn_proj = Dense(D, D, dt, pdt, device, "row")
        self.ln_2 = LayerNorm(D, dt, pdt, device)
        self.mlp_in = Dense(D, F_, dt, pdt, device, "column")
        self.mlp_out = Dense(F_, D, dt, pdt, device, "row")

    def forward(self, x):
        B, S, D = x.shape
        qkv = self.attn_qkv(self.ln_1(x)).view(B, S, 3, -1,
                                               D // self.num_heads)
        q, k, v = qkv.unbind(2)
        with record_function(ATTENTION_SPAN):
            att = reference_attention(q, k, v, mask=None)  # bidirectional
        att = self.attn_proj(att.reshape(B, S, -1))
        h = gelu(self.mlp_in(self.ln_2(residual_sum(x, att))))
        return x + att + self.mlp_out(h)


def _xavier_uniform_(weight, generator, fan_in: int, fan_out: int):
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    nn.init.uniform_(weight, -limit, limit, generator=generator)


class ViTForImageClassification(DenseFamily):
    """images ``[B, H, W, CHANNELS]`` -> logits ``[B, num_classes]``
    (fp32).  Weights are drawn from ``seed`` with the JAX model's
    initializers (xavier-uniform kernels, N(0, 0.02) ``pos_embed``, zero
    ``cls_token``, head and biases)."""

    tp_split = {"attn_qkv.weight": 1, "attn_proj.weight": 1,
                "mlp_in.weight": 0, "mlp_out.weight": 1, "head.weight": 0}

    def __init__(self, config: ViTConfig, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        self.config = config
        device = resolve_device(device)
        D, P, pdt = config.hidden_size, config.patch_size, config.param_dtype
        self.patch_embed = Dense(P * P * CHANNELS, D, config.dtype, pdt,
                                 device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D, dtype=pdt,
                                                  device=device))
        self.pos_embed = nn.Parameter(torch.empty(
            1, config.num_patches + 1, D, dtype=pdt, device=device))
        self.layers = nn.ModuleList(EncoderBlock(config, device)
                                    for _ in range(config.num_layers))
        self.ln_f = LayerNorm(D, config.dtype, pdt, device)
        self.head = Dense(D, config.num_classes, torch.float32, pdt, device,
                          "column")
        self.tp = self.cp = self.ep = None
        self.init_weights(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        P = self.config.patch_size
        for module in self.modules():
            if isinstance(module, Dense) and module is not self.head:
                w = module.weight
                fan_in, fan_out = w.shape[-1], math.prod(w.shape[:-1])
                if module is self.patch_embed:  # the conv's receptive field
                    fan_out *= P * P
                _xavier_uniform_(w, generator, fan_in, fan_out)
        nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=generator)
        self.head.weight.zero_()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        self._check_axes()
        cfg = self.config
        P, dt = cfg.patch_size, cfg.dtype
        x = images.to(dt)
        B, H, W, C = x.shape
        rows = (x.reshape(B, H // P, P, W // P, P, C)
                .permute(0, 1, 3, 2, 4, 5).reshape(B, -1, P * P * C))
        x = self.patch_embed(rows)
        cls = self.cls_token.to(dt).expand(B, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        for layer in self.layers:
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, use_reentrant=False)
            else:
                x = layer(x)
        return self.head(self.ln_f(x)[:, 0])

    def loss(self, logits: torch.Tensor, labels: torch.Tensor
             ) -> torch.Tensor:
        """Mean cross entropy in fp32 (over this rank's classes under tp,
        the log-sum-exp reduced over tp)."""
        if self.tp is not None:
            return vocab_parallel_cross_entropy(logits[:, None],
                                                labels[:, None], self.tp)
        logp = torch.log_softmax(logits.float(), dim=-1)
        onehot = F.one_hot(labels.long(), logits.shape[-1]).to(logp.dtype)
        return -(onehot * logp).sum(dim=-1).mean()

    def _tp_sizes(self):
        cfg = self.config
        return (("num_heads", cfg.num_heads),
                ("mlp width", cfg.mlp_ratio * cfg.hidden_size),
                ("num_classes", cfg.num_classes))

    def num_params(self) -> int:
        cfg = self.config
        D, F_ = cfg.hidden_size, cfg.mlp_ratio * cfg.hidden_size
        per_layer = 4 * D * D + 2 * D * F_ + 9 * D + F_
        patch = cfg.patch_size ** 2 * CHANNELS * D + D
        return (patch + D + (cfg.num_patches + 1) * D
                + cfg.num_layers * per_layer + 2 * D
                + D * cfg.num_classes + cfg.num_classes)


def vit_loss_fn(model: ViTForImageClassification):
    """A ``Trainer`` ``loss_fn`` over ``batch["images"]`` and
    ``batch["labels"]``."""

    def loss_fn(batch):
        return model.loss(model(batch["images"]), batch["labels"])

    return loss_fn
