"""Training harness: state creation, train step, gradient accumulation.

Port of ``dlrover_tpu/trainer/train.py``, single device, exact path only
(``Trainer._exact_train_step`` and ``_accumulate_scan``).  PyTorch runs
eagerly, so there is no compile step, mesh or sharding: the step is
forward, fp32 cross entropy, backward and the optimizer update.

The state is updated in place: ``train_step`` adds the optimizer's updates
to the fp32 master params of the ``TrainState`` it is given and returns
that same state with ``step`` advanced (JAX donates the old state for the
same reason: one copy of the params in device memory).

``grads_dtype=torch.bfloat16`` keeps the fp32 masters in the state and
runs forward and backward on a bf16 copy held by the model, so the
gradients are bf16; the copy is refreshed from the masters after each
update.  Without it the model's parameters ARE the masters.
"""

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from dlrover_tpu_torch.device import DeviceLike, resolve_device
from dlrover_tpu_torch.trainer import optim


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]  # fp32 masters, by parameter name
    opt_state: Any


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross entropy in fp32; labels [B,S], logits [B,S,V].

    Spelled ``logsumexp - gold_logit``: the only [B,S,V]-sized fp32 value
    is the logits themselves."""
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, labels[..., None].long())[..., 0]
    token_loss = lse - gold
    if mask is not None:
        mask = mask.to(token_loss.dtype)
        return (token_loss * mask).sum() / mask.sum().clamp(min=1)
    return token_loss.mean()


class Trainer:
    """Holds (model, optimizer, device) and exposes init/step.

    Usage::

        trainer = Trainer(model, create_optimizer(...), device="cuda")
        state = trainer.create_state()
        state, metrics = trainer.train_step(state, batch)
    """

    def __init__(
        self,
        model: torch.nn.Module,
        optimizer: optim.GradientTransformation,
        loss_fn: Optional[Callable] = None,
        grad_accum_steps: int = 1,
        grads_dtype: Optional[torch.dtype] = None,
        accum_dtype: Optional[torch.dtype] = None,
        grad_sync: Optional[str] = "exact",
        device: DeviceLike = None,
    ):
        """``accum_dtype`` is the microbatch gradient ACCUMULATOR dtype and
        defaults to fp32 independently of ``grads_dtype``: repeated bf16
        summation swallows small late-microbatch contributions.

        ``grad_sync`` other than ``"exact"`` raises: the data-parallel
        gradient sync (quantized / sharded reduce-scatter) is a later
        slice of the port."""
        if grad_sync not in (None, "exact"):
            raise NotImplementedError(
                f"grad_sync={grad_sync!r} is not ported yet: data-parallel "
                "gradient sync (parallel/collectives.py, bucketing.py and "
                "the ring reduce-scatter kernels) is the port's next slice"
            )
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.optimizer = optimizer
        self.grad_accum_steps = max(1, grad_accum_steps)
        self.grads_dtype = grads_dtype
        self.accum_dtype = accum_dtype
        self._loss_fn = loss_fn or self._default_loss
        self._named = dict(self.model.named_parameters())

    # -- state creation ----------------------------------------------------

    def create_state(self) -> TrainState:
        """fp32 masters from the model's current weights, and the
        optimizer state for them."""
        with torch.no_grad():
            masters = {
                n: p.detach().float().clone() for n, p in self._named.items()
            }
            for n, p in self._named.items():
                p.data = (
                    masters[n] if self.grads_dtype is None
                    else masters[n].to(self.grads_dtype)
                )
        return TrainState(
            step=0, params=masters, opt_state=self.optimizer.init(masters)
        )

    # -- train step ----------------------------------------------------------

    def _default_loss(self, batch):
        logits = self.model(batch["input_ids"])
        return cross_entropy_loss(logits, batch["labels"], batch.get("mask"))

    def _grad_fn(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, grads) w.r.t. the model's parameters (the bf16 copy when
        ``grads_dtype`` is set)."""
        names = list(self._named)
        loss = self._loss_fn(batch)
        grads = torch.autograd.grad(loss, [self._named[n] for n in names])
        return loss.detach(), dict(zip(names, grads))

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {
            k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(self.device)
            for k, v in batch.items()
        }

    def train_step(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        """One step.  Its two phases are ``torch.profiler`` spans,
        ``trainer.forward_backward`` and ``trainer.update``: two context
        managers per step, which record only while a profiler runs."""
        batch = self._to_device(batch)
        with record_function("trainer.forward_backward"):
            if self.grad_accum_steps == 1:
                loss, grads = self._grad_fn(batch)
            else:
                loss_sum, grad_sum, w_sum = self._accumulate(batch)
                w_sum = w_sum.clamp(min=1e-8)
                loss = loss_sum / w_sum
                grads = {n: g / w_sum.to(g.dtype)
                         for n, g in grad_sum.items()}

        with record_function("trainer.update"):
            grad_norm = optim.global_norm(grads)
            updates, state.opt_state = self.optimizer.update(
                grads, state.opt_state, state.params
            )
            optim.apply_updates(state.params, updates)
            if self.grads_dtype is not None:
                with torch.no_grad():
                    for n, p in self._named.items():
                        p.copy_(state.params[n])
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm}

    # -- gradient accumulation -----------------------------------------------

    @staticmethod
    def _mb_weight(mb, default_n: int, device) -> torch.Tensor:
        # token weight so masked (micro)batches average correctly
        if mb.get("mask") is not None:
            return mb["mask"].sum().float()
        return torch.tensor(float(default_n), device=device)

    def _accumulate(self, batch):
        """UNNORMALIZED ``(loss_sum, grad_sum, w_sum)`` over the batch in
        ``grad_accum_steps`` microbatches, mask-weighted so dividing by
        ``w_sum`` reproduces the exact mean."""
        accum = self.grad_accum_steps
        batch_dim = next(iter(batch.values())).shape[0]
        if batch_dim % accum != 0:
            raise ValueError(
                f"batch size {batch_dim} not divisible by "
                f"grad_accum_steps {accum}; no sample may be dropped"
            )
        micro = batch_dim // accum
        accum_dtype = self.accum_dtype or torch.float32
        grad_sum = {
            n: torch.zeros(p.shape, dtype=accum_dtype, device=self.device)
            for n, p in self._named.items()
        }
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        w_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(accum):
            mb = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
            w = self._mb_weight(mb, micro, self.device)
            loss, grads = self._grad_fn(mb)
            loss_sum = loss_sum + loss * w
            for n, g in grads.items():
                acc = grad_sum[n]
                acc += g.to(acc.dtype) * w.to(acc.dtype)
            w_sum = w_sum + w
        return loss_sum, grad_sum, w_sum
