"""Training harness: state creation, train step, gradient accumulation.

Port of ``dlrover_tpu/trainer/train.py``: the single-device step
(``_exact_train_step``, ``_accumulate_scan``) and the flat data-parallel
step with its gradient sync (``_configure_grad_sync``, ``_accumulate_local``,
``_sync_body``).  PyTorch runs eagerly, so there is no compile step, mesh
or sharding: the step is forward, fp32 cross entropy, backward, the dp
gradient sync when there is a dp group, and the optimizer update.

The state is updated in place: ``train_step`` adds the optimizer's updates
to the fp32 master params of the ``TrainState`` it is given and returns
that same state with ``step`` advanced (JAX donates the old state for the
same reason: one copy of the params in device memory).

``grads_dtype=torch.bfloat16`` keeps the fp32 masters in the state and
runs forward and backward on a bf16 copy held by the model, so the
gradients are bf16; the copy is refreshed from the masters after each
update.  Without it the model's parameters ARE the masters.

Data parallelism: ``Trainer(dp_group=...)`` (``parallel/process_group.py``)
runs one rank per process, each on its own slice of the global batch, and
``grad_sync`` picks the sync (``parallel/collectives.GradSyncPolicy``).
Every rank holds the full fp32 masters; with a ``*_sharded`` mode its
optimizer state covers only its shard of each shardable leaf, and
``TrainState.ef_residual`` holds its error-feedback residuals.  A bucket
that resolves to the ``ring_rdma`` tier runs over a ``PeerWindow`` the
trainer builds for the widest such bucket and checks once per step, before
the update; ``Trainer.close()`` releases it.
"""

import dataclasses
import logging
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from dlrover_tpu_torch.device import DeviceLike, resolve_device
from dlrover_tpu_torch.ops.cuda import ring_reduce_scatter as ring
from dlrover_tpu_torch.parallel import collectives
from dlrover_tpu_torch.parallel.bucketing import BucketLayout
from dlrover_tpu_torch.parallel.collectives import GradSyncPolicy
from dlrover_tpu_torch.parallel.peer_memory import PeerWindow
from dlrover_tpu_torch.parallel.process_group import DpGroup
from dlrover_tpu_torch.trainer import optim

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainState:
    """``ef_residual``: this rank's error-feedback residual of the
    quantized grad sync, one fp32 tensor of the leaf's shape per shardable
    leaf, by parameter name; None unless the trainer runs a quantized
    ``grad_sync`` over a dp group of more than one rank."""

    step: int
    params: Dict[str, torch.Tensor]  # fp32 masters, by parameter name
    opt_state: Any
    ef_residual: Optional[Dict[str, torch.Tensor]] = None


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
        grad_sync: Union[str, GradSyncPolicy, None] = "exact",
        dp_group: Optional[DpGroup] = None,
        device: DeviceLike = None,
    ):
        """``accum_dtype`` is the microbatch gradient ACCUMULATOR dtype and
        defaults to fp32 independently of ``grads_dtype``: repeated bf16
        summation swallows small late-microbatch contributions.

        ``dp_group``: this rank's data-parallel group; each rank's
        ``train_step`` takes its own slice of the global batch.
        ``grad_sync`` selects the sync (``GradSyncPolicy``): ``"exact"``
        all-reduces the full-precision gradients and updates every leaf on
        every rank; ``"exact_sharded"`` reduce-scatters them and updates
        this rank's shard (ZeRO-1), then all-gathers the params; the
        ``int8`` / ``int4`` / ``blockwise`` modes (and their ``_sharded``
        variants) quantize the reduce-scatter, with an error-feedback
        residual in the state.  A sharded mode clips with
        ``GradSyncPolicy(clip_norm=...)``: pass an optimizer without a clip
        stage, which would see one rank's shard only."""
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.optimizer = optimizer
        self.grad_accum_steps = max(1, grad_accum_steps)
        self.grads_dtype = grads_dtype
        self.accum_dtype = accum_dtype
        self._loss_fn = loss_fn or self._default_loss
        self._named = dict(self.model.named_parameters())
        self.grad_sync = GradSyncPolicy.parse(grad_sync)
        self.dp_group = dp_group
        self._sync_world = 1
        self._grad_layout: Optional[collectives.GradLayout] = None
        self._bucket_layout: Optional[BucketLayout] = None
        self._peer_window: Optional[PeerWindow] = None
        self._configure_grad_sync()

    # -- data-parallel grad sync ---------------------------------------------

    def _configure_grad_sync(self) -> None:
        """Resolve the policy against the dp world: a world of 1 demotes
        any mode to ``exact`` (keeping ``clip_norm``); otherwise the
        env-deferred fields are made concrete once, here, and the leaf and
        bucket layouts are built from the parameter shapes."""
        world = self.dp_group.world if self.dp_group is not None else 1
        if world <= 1:
            if self.grad_sync.active:
                logger.info("grad_sync=%s demoted to exact: data-parallel "
                            "world is 1", self.grad_sync.mode)
                self.grad_sync = dataclasses.replace(self.grad_sync,
                                                     mode="exact")
            return
        self._sync_world = world
        if not self.grad_sync.active:
            return  # all-reduce of full gradients, replicated update
        self.grad_sync = self.grad_sync.resolve()
        shapes = {n: tuple(p.shape) for n, p in self._named.items()}
        self._grad_layout = collectives.GradLayout(shapes, world)
        bucket_mb = self.grad_sync.bucket_mb or 0.0
        if bucket_mb > 0:
            buckets = BucketLayout.build(self._grad_layout, shapes,
                                         int(bucket_mb * 1024 * 1024))
            if len(buckets):
                self._bucket_layout = buckets
                rdma = [b.width for b in buckets.buckets
                        if self._resolved(b) == "ring_rdma"]
                if rdma:
                    self._peer_window = PeerWindow(self.dp_group, max(rdma))
        if self.grad_sync.sharded_update and self.grad_sync.clip_norm is None:
            logger.warning(
                "grad_sync=%s runs the optimizer on per-rank gradient "
                "shards: if its chain clips by global norm (or holds any "
                "cross-leaf transform), remove that and pass the bound as "
                "GradSyncPolicy(clip_norm=...), or the clip uses shard-local "
                "norms", self.grad_sync.mode)

    def _resolved(self, bucket) -> str:
        return ring.resolve_transport(self.grad_sync, self._sync_world,
                                      bucket.width)

    def close(self) -> None:
        """Release what the grad sync holds outside torch's allocator (the
        ``ring_rdma`` peer window); collective when there is one."""
        if self._peer_window is not None:
            self._peer_window.close()
            self._peer_window = None

    @property
    def _sync_active(self) -> bool:
        return self.grad_sync.active and self._sync_world > 1

    def grad_sync_summary(self) -> Dict:
        """What the sync path does: policy mode and transport request and,
        when bucketed, the bucket count, row widths, layout signature
        (equal across ranks iff the assignments agree) and the transports
        the fallback chain resolved."""
        info: Dict[str, Any] = {
            "mode": self.grad_sync.mode,
            "bucketed": self._bucket_layout is not None,
            "transport": self.grad_sync.transport,
        }
        if self._bucket_layout is not None:
            buckets = self._bucket_layout.buckets
            info.update(
                n_buckets=len(buckets),
                bucket_mb=self.grad_sync.bucket_mb,
                signature=self._bucket_layout.signature(),
                bucket_widths=[b.width for b in buckets],
                transport_resolved=sorted({self._resolved(b)
                                           for b in buckets}),
            )
        return info

    # -- state creation ----------------------------------------------------

    def create_state(self) -> TrainState:
        """fp32 masters from the model's current weights, and the
        optimizer state for them: for this rank's shards only under a
        sharded mode.  A quantized mode starts with zero residuals."""
        with torch.no_grad():
            masters = {
                n: p.detach().float().clone() for n, p in self._named.items()
            }
            for n, p in self._named.items():
                p.data = (
                    masters[n] if self.grads_dtype is None
                    else masters[n].to(self.grads_dtype)
                )
        update_params = masters
        ef = None
        if self._sync_active:
            if self.grad_sync.sharded_update:
                update_params = collectives.shard_like(
                    masters, self._grad_layout, self.dp_group)
            if self.grad_sync.quantized:
                ef = collectives.error_feedback_init(
                    masters, self._grad_layout) or None
        return TrainState(
            step=0, params=masters,
            opt_state=self.optimizer.init(update_params), ef_residual=ef,
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
        """One step on this rank's ``batch``.  Its phases are
        ``torch.profiler`` spans, ``trainer.forward_backward``,
        ``trainer.grad_sync`` (with a dp group) and ``trainer.update``:
        context managers that record only while a profiler runs."""
        batch = self._to_device(batch)
        if self._sync_world > 1:
            metrics = self._sync_step(state, batch)
            state.step += 1
            return state, metrics
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
            # the policy's clip applies here too, so a job whose dp world
            # shrinks to 1 keeps the same update math
            grads = self._clip(grads, grad_norm)
            updates, state.opt_state = self.optimizer.update(
                grads, state.opt_state, state.params
            )
            optim.apply_updates(state.params, updates)
            self._refresh_compute_copy(state)
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm}

    def _clip(self, grads, grad_norm):
        """``GradSyncPolicy.clip_norm``: scale by min(1, clip / norm)."""
        clip = self.grad_sync.clip_norm
        if clip is None:
            return grads
        scale = torch.clamp(clip / grad_norm.clamp(min=1e-12), max=1.0)
        return {n: g * scale.to(g.dtype) for n, g in grads.items()}

    def _refresh_compute_copy(self, state: TrainState) -> None:
        if self.grads_dtype is not None:
            with torch.no_grad():
                for n, p in self._named.items():
                    p.copy_(state.params[n])

    # -- data-parallel step ----------------------------------------------------

    def _accumulate_local(self, batch):
        """This rank's UNNORMALIZED ``(loss_sum, grad_sum, w_sum)``, so
        that ``all_reduce(grad_sum) / all_reduce(w_sum)`` is the exact
        global (mask-weighted) mean gradient; fp32 sums."""
        if self.grad_accum_steps == 1:
            w = self._mb_weight(batch, next(iter(batch.values())).shape[0],
                                self.device)
            loss, grads = self._grad_fn(batch)
            return loss * w, {n: g.float() * w for n, g in grads.items()}, w
        return self._accumulate(batch)

    def _gather(self, tree):
        if self._bucket_layout is not None:
            return collectives.all_gather_tree_bucketed(
                tree, self._grad_layout, self._bucket_layout, self.dp_group)
        return collectives.all_gather_tree(tree, self._grad_layout,
                                           self.dp_group)

    def _sync_step(self, state: TrainState, batch) -> Dict:
        """One rank's step (the reference's ``_sync_body``): local grads,
        the weight and loss all-reduce, ``ghat = grad_sum / w_global``,
        the (quantized, bucketed or per-leaf) sync with error feedback,
        the global norm and clip, then either the sharded update of this
        rank's shards and a param all-gather, or a grad all-gather and the
        full update.  ``exact`` all-reduces the full gradients instead."""
        group, policy, layout = self.dp_group, self.grad_sync, self._grad_layout
        with record_function("trainer.forward_backward"):
            loss_sum, grad_sum, w_sum = self._accumulate_local(batch)
        with record_function("trainer.grad_sync"):
            sums = group.all_reduce(torch.stack([loss_sum.float(),
                                                 w_sum.float()]))
            w_global = sums[1].clamp(min=1e-8)
            loss = sums[0] / w_global
            # in place: grad_sum is not read again
            ghat = {n: g.float().div_(w_global) for n, g in grad_sum.items()}
            new_ef = None
            if not policy.active:
                synced = {n: group.all_reduce(g) for n, g in ghat.items()}
                grad_norm = optim.global_norm(synced)
            else:
                if self._bucket_layout is not None:
                    synced, new_ef = collectives.sync_gradient_tree_bucketed(
                        ghat, state.ef_residual, layout, self._bucket_layout,
                        policy, group, window=self._peer_window)
                    if self._peer_window is not None:
                        # one wait per step, not per bucket; a ring that
                        # ran out of time raises before the update
                        self._peer_window.check()
                else:
                    synced, new_ef = collectives.sync_gradient_tree(
                        ghat, state.ef_residual, layout, policy, group)
                grad_norm = collectives.global_grad_norm(synced, layout,
                                                         group)
            del ghat, grad_sum
            synced = self._clip(synced, grad_norm)
        with record_function("trainer.update"):
            if policy.sharded_update:
                # the shards are views of the masters: the update lands in
                # this rank's chunk of each leaf, the gather fills the rest
                p_shards = collectives.shard_like(state.params, layout, group)
                updates, state.opt_state = self.optimizer.update(
                    synced, state.opt_state, p_shards)
                optim.apply_updates(p_shards, updates)
                del updates, synced
                with torch.no_grad():
                    for n, full in self._gather(p_shards).items():
                        if layout.dims.get(n) is not None:
                            state.params[n].copy_(full)
            else:
                full = self._gather(synced) if policy.active else synced
                updates, state.opt_state = self.optimizer.update(
                    full, state.opt_state, state.params)
                optim.apply_updates(state.params, updates)
            state.ef_residual = new_ef
            self._refresh_compute_copy(state)
        return {"loss": loss, "grad_norm": grad_norm}

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
