"""Mixture-of-Experts Llama: the ``ep`` mesh axis.

Port of ``dlrover_tpu/models/moe.py``: a top-k routed SwiGLU feed-forward
with capacity-based dispatch (GShard/Switch).  Each expert takes at most
``C = expert_capacity(S, E, top_k, capacity_factor)`` tokens per batch
row, chosen by gate priority: every token's first choice before any
token's second choice.  Dispatch and combine are one-hot einsums of
static shape, so an expert's FLOPs scale with ``top_k * capacity_factor``
and not with E; a token over capacity is dropped (its MoE output is zero
and the residual carries it).  ``router_impl="dense"`` is the numerical
oracle: every expert computes every token, and with a capacity at which
nothing drops the dispatch must match it.

The router runs in fp32; ties in the top-k go to the lower expert index,
as ``lax.top_k`` breaks them (a stable descending sort).  Each ``MoEMLP``
records the Switch load-balancing loss of its last forward as
``aux_loss`` (flax's ``sow``); ``moe_loss_fn`` adds their mean times
``aux_weight`` to the cross entropy.  The aux loss uses the pre-capacity
assignment, so its gradient pushes the router, not the drops.

The expert weights keep the reference's layout, ``gate_proj`` and
``up_proj`` ``[E, D, H]`` and ``down_proj`` ``[E, H, D]`` (batched over
E); the router is an ``nn.Linear`` with PyTorch's ``[E, D]`` weight.  The
model reuses the port's ``Attention`` and ``RMSNorm``, so
``attention_impl="flash"`` runs the flash kernels, and, as the reference
model does, it never checkpoints its layers, whatever ``config.remat``.

On a mesh (``trainer/train.py``) the ranks of ``ep`` see the same tokens
(the rules split the batch over dp and fsdp only) and each keeps E/ep
experts (``shard_expert_parallel``); ``tp`` splits each expert's H.  Every
rank routes every token and dispatches it, computes its own experts'
outputs for its H columns, and combines them: a partial sum over the
``tp`` and ``ep`` ranks, joined by ``reduce_from_tp`` (an all-reduce).
Over the same ranks, ``copy_to_tp`` sums in the backward the dispatch
input's gradient and the gates' gradient, each of which a rank sees only
for its own experts and columns; the routing upstream of the gates then
gets the whole gradient on every rank, as the aux loss's already is.  So
the router's gradient is the same on every ``ep`` rank: the router is
split over ``ep`` by the rules, gathered in the forward, and a shard's
gradient is its slice of the whole (``gather_rows``).  The aux loss is a
product of two means over the global batch: its sums are all-reduced over
the data axes (``set_data_parallel``) and over ``cp`` before the product.

Over ``cp`` (``set_context_parallel``) each rank holds a contiguous chunk
of the sequence, and the reference's dispatch (GSPMD's partition of it)
runs over the whole sequence: the capacity comes from the global S, and
the priority scan is k-major over every rank's tokens, every first choice
of the sequence before any second choice.  So the slot of rank r's token
for choice j of expert e is the count of choices before j to e on every
rank, plus the count of choice j to e on the ranks before r, plus the
local cumsum: one all-gather over ``cp`` of each rank's integer counts
``[B, k, E]`` (no gradient) gives the offsets, and ``keep`` and the slots
equal the reference's token for token.  The expert buffer then needs no
exchange: a slot holds at most one token and the expert FFN is slot-wise
with no bias (FFN(0) = 0), so each rank fills its own tokens' global slots,
leaves the rest zero, runs the FFN and combines its own tokens, which is
exactly what the summed buffer GSPMD builds gives those tokens, in bf16
too.  The expert weights' gradients are then partial sums over the cp
ranks, which the trainer's gradient sum over cp completes.  That reasoning
stops holding for an expert with a bias or an FFN that mixes slots; such
a layer would have to sum the buffer over ``cp`` first.
"""

import dataclasses
import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from dlrover_tpu_torch.models.llama import (
    TP_DIMS,
    Attention,
    LlamaConfig,
    LlamaForCausalLM,
    RMSNorm,
    _lecun_normal_,
)
from dlrover_tpu_torch.parallel.tensor_parallel import (
    all_reduce_sum,
    copy_to_tp,
    gather_rows,
    reduce_from_tp,
)

@dataclasses.dataclass(frozen=True)
class MoELlamaConfig(LlamaConfig):
    num_experts: int = 8
    top_k: int = 2
    # >= num_experts / top_k guarantees zero dropped tokens (oracle mode)
    capacity_factor: float = 1.25
    router_impl: str = "dispatch"  # "dispatch" | "dense"

    def __post_init__(self):
        super().__post_init__()
        if self.router_impl not in ("dispatch", "dense"):
            raise ValueError(f"router_impl={self.router_impl!r} not in "
                             "('dispatch', 'dense')")

    @classmethod
    def tiny_moe(cls, **kw) -> "MoELlamaConfig":
        defaults = dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_seq_len=128, num_experts=4, top_k=2, remat=False,
        )
        defaults.update(kw)
        return cls(**defaults)


def expert_capacity(seq_len: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Per-expert token budget per batch row, a multiple of 8."""
    c = math.ceil(capacity_factor * top_k * seq_len / num_experts)
    return max(8, ((c + 7) // 8) * 8)


def top_k_lower_index(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last dim,
    largest first, ties to the lower index (``lax.top_k``'s order)."""
    values, indices = x.sort(dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _copy_to(x: torch.Tensor, groups) -> torch.Tensor:
    for group in groups:
        x = copy_to_tp(x, group)
    return x


def _reduce_from(x: torch.Tensor, groups) -> torch.Tensor:
    for group in groups:
        x = reduce_from_tp(x, group)
    return x


class MoEMLP(nn.Module):
    """Top-k routed SwiGLU experts."""

    def __init__(self, config: MoELlamaConfig, device):
        super().__init__()
        self.config = config
        E, D, H = (config.num_experts, config.hidden_size,
                   config.intermediate_size)
        self.router = nn.Linear(D, E, bias=False, device=device,
                                dtype=config.param_dtype)

        def expert(*shape):
            return nn.Parameter(torch.empty(*shape, device=device,
                                            dtype=config.param_dtype))

        self.gate_proj = expert(E, D, H)
        self.up_proj = expert(E, D, H)
        self.down_proj = expert(E, H, D)
        self.tp = None
        self.ep = None
        self.cp = None  # this rank holds a chunk of the sequence
        self.data_groups = ()
        self.aux_loss = None  # the Switch loss of the last forward

    def _partial_groups(self):
        """The groups over which this rank's output is a partial sum."""
        return tuple(g for g in (self.tp, self.ep) if g is not None)

    def _local_experts(self) -> slice:
        local = self.gate_proj.shape[0]
        start = 0 if self.ep is None else self.ep.rank * local
        return slice(start, start + local)

    def forward(self, x):
        cfg = self.config
        B, S, _ = x.shape
        E, top_k = cfg.num_experts, cfg.top_k
        with record_function("moe.routing"):
            router = gather_rows(self.router.weight, self.ep)
            logits = F.linear(x.float(), router.float())  # [B, S, E]
            probs = torch.softmax(logits, dim=-1)
            top_vals, top_idx = top_k_lower_index(probs, top_k)
            norm_vals = top_vals / top_vals.sum(
                dim=-1, keepdim=True).clamp(min=1e-9)  # [B, S, k]
            self.aux_loss = self._switch_loss(probs, top_idx, B * S)
        if cfg.router_impl == "dense":
            return self._dense_mixture(x, probs, top_vals, top_idx)
        return self._dispatch(x, norm_vals, top_idx)

    def _switch_loss(self, probs, top_idx, tokens: int) -> torch.Tensor:
        """E * sum_e(frac_assigned_e * mean_prob_e) over the global batch
        and sequence: the sums all-reduced over the data axes and cp
        before the product."""
        cfg = self.config
        E = cfg.num_experts
        groups = self.data_groups + ((self.cp,) if self.cp else ())
        assign = F.one_hot(top_idx, E).float()  # [B, S, k, E]
        assigned = assign.sum(dim=(0, 1, 2))
        prob_sum = probs.sum(dim=(0, 1))
        for group in groups:
            assigned = group.all_reduce(assigned)
            tokens *= group.world
        prob_sum = all_reduce_sum(prob_sum, groups)
        frac = assigned / tokens / cfg.top_k
        return E * torch.sum(frac * (prob_sum / tokens))

    def _expert_ffn(self, expert_in):
        """SwiGLU of this rank's experts on dispatched buffers
        [B, E_local, C, D] (its H columns under tp)."""
        dt = self.config.dtype
        h = torch.einsum("becd,edh->bech", expert_in, self.gate_proj.to(dt))
        u = torch.einsum("becd,edh->bech", expert_in, self.up_proj.to(dt))
        act = F.silu(h) * u
        return torch.einsum("bech,ehd->becd", act, self.down_proj.to(dt))

    def slots(self, mask: torch.Tensor) -> torch.Tensor:
        """Each choice's slot in its expert's buffer by priority, every
        first choice of the (global) sequence before any second choice,
        and -1 where a token did not choose the expert; ``mask``: the
        one-hot choices ``[B, S, k, E]`` of this rank's tokens.  Under cp
        the offsets count the other ranks' choices (module docstring)."""
        counts = mask.sum(dim=1)  # [B, k, E]
        if self.cp is None:
            total, before = counts, 0.0
        else:
            every = self.cp.all_gather(counts)  # [cp, B, k, E]
            total, before = every.sum(dim=0), every[:self.cp.rank].sum(dim=0)
        # the earlier choices on every rank, this choice on earlier ranks
        offset = total.cumsum(dim=1) - total + before
        return (mask.cumsum(dim=1) + offset[:, None]) * mask - 1.0

    def _dispatch(self, x, norm_vals, top_idx):
        """Capacity-based one-hot dispatch: FLOPs scale with top_k, not E."""
        cfg = self.config
        E, S = cfg.num_experts, x.shape[1]
        if self.cp is not None:  # the capacity of the global sequence
            S *= self.cp.world
        C = expert_capacity(S, E, cfg.top_k, cfg.capacity_factor)
        parts, mine = self._partial_groups(), self._local_experts()
        with record_function("moe.routing"):
            mask = F.one_hot(top_idx, E).float()  # [B, S, k, E]
            pos = self.slots(mask)
            keep = mask * (pos >= 0.0) * (pos < C)
            pos_idx = pos.long().clamp(0, C - 1)
            # dispatch [B, S, E, C]: one-hot of each kept token's slot
            disp = (keep[..., None] * F.one_hot(pos_idx, C).float()).sum(2)
            gate_te = (norm_vals[..., None] * keep).sum(dim=2)  # [B, S, E]
            combine = disp * _copy_to(gate_te, parts)[..., None]
        dt = cfg.dtype
        with record_function("moe.dispatch"):
            xc = _copy_to(x, parts).to(dt)
            expert_in = torch.einsum("bsec,bsd->becd",
                                     disp[:, :, mine].to(dt), xc)
        with record_function("moe.experts"):
            out_e = self._expert_ffn(expert_in)
        with record_function("moe.combine"):
            out = torch.einsum("becd,bsec->bsd", out_e,
                               combine[:, :, mine].to(dt))
            return _reduce_from(out, parts)

    def _dense_mixture(self, x, probs, top_vals, top_idx):
        """Numerical oracle: every expert computes every token (E x the
        FLOPs).  For parity tests only."""
        cfg = self.config
        dt = cfg.dtype
        parts, mine = self._partial_groups(), self._local_experts()
        gates = torch.zeros_like(probs).scatter(-1, top_idx, top_vals)
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
        gates = _copy_to(gates, parts)[:, :, mine]
        xc = _copy_to(x, parts).to(dt)
        h = torch.einsum("bsd,edh->bseh", xc, self.gate_proj.to(dt))
        u = torch.einsum("bsd,edh->bseh", xc, self.up_proj.to(dt))
        act = F.silu(h) * u
        out = torch.einsum("bseh,ehd->bsed", act, self.down_proj.to(dt))
        out = torch.einsum("bsed,bse->bsd", out, gates.to(dt))
        return _reduce_from(out, parts)


class MoEDecoderLayer(nn.Module):
    def __init__(self, config: MoELlamaConfig, device):
        super().__init__()
        norm = (config.hidden_size, config.rms_norm_eps, config.dtype,
                config.param_dtype, device)
        self.input_norm = RMSNorm(*norm)
        self.attn = Attention(config, device)
        self.post_attn_norm = RMSNorm(*norm)
        self.moe_mlp = MoEMLP(config, device)

    def forward(self, x, cos, sin):
        x = x + self.attn(self.input_norm(x), cos, sin)
        return x + self.moe_mlp(self.post_attn_norm(x))


class MoELlamaForCausalLM(LlamaForCausalLM):
    """The Llama with an ``MoEMLP`` in every layer; layers never
    checkpointed (module docstring)."""

    layer_class = MoEDecoderLayer
    tp_split = {**TP_DIMS, "moe_mlp.gate_proj": 2, "moe_mlp.up_proj": 2,
                "moe_mlp.down_proj": 1}
    ep_split = {"moe_mlp.router.weight": 0, "moe_mlp.gate_proj": 0,
                "moe_mlp.up_proj": 0, "moe_mlp.down_proj": 0}
    remat_layers = False

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        super().init_weights(generator)
        for module in self.modules():
            if isinstance(module, MoEMLP):
                for w in (module.gate_proj, module.up_proj,
                          module.down_proj):
                    # flax counts E as a receptive field of an
                    # [E, in, out] kernel: fan-in E * in
                    _lecun_normal_(w, generator, w.shape[0] * w.shape[1])

    def moe_layers(self):
        return [m for m in self.modules() if isinstance(m, MoEMLP)]

    def shard_expert_parallel(self, group) -> None:
        """Keep this rank's E/ep experts and router rows; raises
        ``ValueError`` where ep does not divide E."""
        E = self.config.num_experts
        if E % group.world:
            raise ValueError(f"ep={group.world} does not divide "
                             f"num_experts={E}")
        super().shard_expert_parallel(group)

    def set_data_parallel(self, groups) -> None:
        """The aux loss's sums are all-reduced over ``groups``."""
        for module in self.moe_layers():
            module.data_groups = tuple(groups)

    def num_params(self) -> int:
        cfg = self.config
        E, D, H = (cfg.num_experts, cfg.hidden_size,
                   cfg.intermediate_size)
        attn = D * cfg.head_dim * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
        per_layer = attn + D * E + 3 * E * D * H + 2 * D
        return cfg.vocab_size * D * 2 + cfg.num_layers * per_layer + D


def moe_loss_fn(model: MoELlamaForCausalLM,
                aux_weight: float = 0.01) -> Callable[[Dict], torch.Tensor]:
    """A ``Trainer`` ``loss_fn``: the model's cross entropy plus
    ``aux_weight`` times the mean of its layers' aux losses.  Without it
    top-k routing collapses onto a few experts and capacity dispatch
    drops most tokens."""
    from dlrover_tpu_torch.trainer.train import lm_loss

    def loss_fn(batch):
        logits = model(batch["input_ids"])
        loss = lm_loss(model, logits, batch)
        aux = [m.aux_loss for m in model.moe_layers()]
        if aux:
            loss = loss + aux_weight * sum(aux) / len(aux)
        return loss

    return loss_fn
