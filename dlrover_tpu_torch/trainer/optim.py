"""Optimizer factory: the standard LLM pretraining recipe in one call.

Port of ``dlrover_tpu/trainer/optim.py`` (``scale_by_adam_lowp``,
``cosine_schedule``, ``create_optimizer``) together with the few optax
pieces they chain.  Transforms are optax-shaped: ``init(params) -> state``
and ``update(grads, state, params) -> (updates, state)`` over dicts of
tensors keyed by parameter name, so one step of the port and one step of
optax can be compared leaf by leaf.  Each transform returns new tensors;
``apply_updates`` adds the updates to the params in place.

``moment_dtype=torch.bfloat16`` stores BOTH Adam moments in bf16 (fp32
math, bf16 storage), halving optimizer-state memory.

The global norm (clipping and the trainer's ``grad_norm`` metric) is summed
in fp32 whatever the leaves' dtype.  optax sums bf16 leaves in bf16, so on
bf16 grads the two norms differ by bf16 rounding (< 1%); Adam divides out
any constant scale on the grads, so the params barely see it.
"""

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]


class GradientTransformation(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Optional[Params]], Tuple[Params, Any]]


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    squares = [t.float().square().sum() for t in tree.values()]
    return torch.stack(squares).sum().sqrt()


def apply_updates(params: Params, updates: Params) -> None:
    """params += updates, in place (optax.apply_updates)."""
    with torch.no_grad():
        for name, p in params.items():
            p.add_(updates[name].to(p.dtype))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        keep = g_norm < max_norm
        return {
            n: torch.where(keep, t, (t / g_norm.to(t.dtype)) * max_norm)
            for n, t in updates.items()
        }, state

    return GradientTransformation(lambda params: (), update)


class ScaleByAdamState(NamedTuple):
    count: int
    mu: Params
    nu: Params


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count, in fp32 as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    """``optax.scale_by_adam``: moments in the params' dtype.  On bf16
    grads jax rounds the weak-typed ``1 - b1`` and ``1 - b2`` to bf16,
    squares ``g`` in bf16, and the jitted step fuses the rest of each
    moment update into fp32; this computes the same."""

    def init(params):
        return ScaleByAdamState(
            count=0,
            mu={n: torch.zeros_like(p) for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()},
        )

    def update(updates, state, params=None):
        mu, nu = {}, {}
        for n, g in updates.items():
            dtype = state.mu[n].dtype
            c1 = torch.tensor(1 - b1, dtype=g.dtype).item()
            c2 = torch.tensor(1 - b2, dtype=g.dtype).item()
            mu[n] = c1 * g.to(dtype) + b1 * state.mu[n]
            nu[n] = c2 * g.square().to(dtype) + b2 * state.nu[n]
        count = state.count + 1
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
        scaled = {n: (mu[n] / c1) / ((nu[n] / c2).sqrt() + eps)
                  for n in updates}
        return scaled, ScaleByAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def scale_by_adam_lowp(
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    moment_dtype: Optional[torch.dtype] = None,
) -> GradientTransformation:
    """``scale_by_adam`` with BOTH moments stored in ``moment_dtype``
    (fp32 math, low-precision storage)."""

    def store(x):
        return x.to(moment_dtype) if moment_dtype is not None else x

    def init(params):
        def zeros(p):
            return store(torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device))

        return ScaleByAdamState(
            count=0,
            mu={n: zeros(p) for n, p in params.items()},
            nu={n: zeros(p) for n, p in params.items()},
        )

    def update(updates, state, params=None):
        mu = {n: b1 * state.mu[n].float() + (1.0 - b1) * g.float()
              for n, g in updates.items()}
        nu = {n: b2 * state.nu[n].float() + (1.0 - b2) * g.float().square()
              for n, g in updates.items()}
        count = state.count + 1
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
        scaled = {n: (mu[n] / c1) / ((nu[n] / c2).sqrt() + eps)
                  for n in updates}
        return scaled, ScaleByAdamState(
            count=count,
            mu={n: store(m) for n, m in mu.items()},
            nu={n: store(v) for n, v in nu.items()},
        )

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        return {n: g + weight_decay * params[n]
                for n, g in updates.items()}, state

    return GradientTransformation(lambda params: (), update)


class ScaleByScheduleState(NamedTuple):
    count: int


def scale_by_learning_rate(schedule: Schedule) -> GradientTransformation:
    """updates * -schedule(count), count starting at 0."""

    def update(updates, state, params=None):
        step_size = -schedule(state.count)
        return (
            {n: step_size * g for n, g in updates.items()},
            ScaleByScheduleState(count=state.count + 1),
        )

    return GradientTransformation(lambda params: ScaleByScheduleState(0),
                                  update)


def adamw(learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """``optax.adamw`` with no mask: weight decay on every param."""
    return chain(
        scale_by_adam(b1=b1, b2=b2, eps=eps),
        add_decayed_weights(weight_decay),
        scale_by_learning_rate(learning_rate),
    )


def warmup_cosine_decay_schedule(
    init_value: float,
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    end_value: float = 0.0,
) -> Schedule:
    """optax's: linear warmup from ``init_value`` to ``peak_value``, then a
    cosine decay to ``end_value``; ``decay_steps`` includes the warmup."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def cosine_schedule(
    peak_lr: float,
    warmup_steps: int,
    total_steps: int,
    final_ratio: float = 0.1,
) -> Schedule:
    return warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=peak_lr,
        warmup_steps=max(1, warmup_steps),
        decay_steps=max(warmup_steps + 1, total_steps),
        end_value=peak_lr * final_ratio,
    )


def create_optimizer(
    peak_lr: float = 3e-4,
    warmup_steps: int = 2000,
    total_steps: int = 100_000,
    weight_decay: float = 0.1,
    grad_clip_norm: Optional[float] = 1.0,
    b1: float = 0.9,
    b2: float = 0.95,
    schedule: Optional[Schedule] = None,
    moment_dtype: Optional[torch.dtype] = None,
) -> GradientTransformation:
    """AdamW + clip + warmup-cosine (pass ``schedule`` to override).

    ``moment_dtype=torch.bfloat16`` halves Adam-state memory (module
    docstring)."""
    lr = schedule or cosine_schedule(peak_lr, warmup_steps, total_steps)
    transforms = []
    if grad_clip_norm:
        transforms.append(clip_by_global_norm(grad_clip_norm))
    if moment_dtype is not None:
        transforms.extend([
            scale_by_adam_lowp(b1=b1, b2=b2, moment_dtype=moment_dtype),
            add_decayed_weights(weight_decay),
            scale_by_learning_rate(lr),
        ])
    else:
        transforms.append(
            adamw(learning_rate=lr, b1=b1, b2=b2, weight_decay=weight_decay)
        )
    return chain(*transforms)
