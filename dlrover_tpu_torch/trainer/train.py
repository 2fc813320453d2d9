"""Training harness: state creation, train step, gradient accumulation.

Port of ``dlrover_tpu/trainer/train.py``: the single-device step
(``_exact_train_step``, ``_accumulate_scan``), the flat data-parallel
step with its gradient sync (``_configure_grad_sync``, ``_accumulate_local``,
``_sync_body``) and the mesh path (``Trainer(..., mesh)``).  PyTorch runs
eagerly, so there is no compile step: the step is forward, fp32 cross
entropy, backward, the gradient exchange of the mesh or the dp group, and
the optimizer update.

The state is updated in place: ``train_step`` adds the optimizer's updates
to the fp32 master params of the ``TrainState`` it is given and returns
that same state with ``step`` advanced (JAX donates the old state for the
same reason: one copy of the params in device memory).

``grads_dtype=torch.bfloat16`` keeps the fp32 masters in the state and
runs forward and backward on a bf16 copy held by the model, so the
gradients are bf16; the copy is refreshed from the masters after each
update.  Without it the model's parameters ARE the masters.  A state the
trainer did not produce itself (one a checkpoint restore filled in place)
gets the copy refreshed before its first step.

``train_step`` ticks the process's step clock (``utils/step_clock.py``)
with the wall time between successive steps: the flash checkpoint's stage
pacer reads it to bound how much a background snapshot slows the steps.

Telemetry (``observability/``), placed where the reference places it, each
hook guarded so that it never breaks a step: the step runs under
``jitscope.watch`` (the kernel builds it pays become compile events); the
first step stands where the reference's first dispatch does, so the
memory scope registers the state's plan and the first step's live-buffer
delta after it, and the goodput ledger charges its kernel builds as
``compile``; every later step feeds its time to the flight recorder and
the goodput ledger, runs the comm probe every
``DLROVER_TPU_COMM_PROBE_EVERY`` steps (a dp group or a mesh with an
active axis) and, every ``DLROVER_TPU_DIGEST_EVERY`` steps, writes this
rank's digest file ``RUNTIME_METRICS.rank<id>`` atomically: the step
digest and the ``gp_*``, ``fxl_*`` / ``fxb_*``, ``mm_*`` / ``mms_*`` and
``js_*`` keys.  ``telemetry_s`` sums the host seconds spent in these
hooks.

Data parallelism: ``Trainer(dp_group=...)`` (``parallel/process_group.py``)
runs one rank per process, each on its own slice of the global batch, and
``grad_sync`` picks the sync (``parallel/collectives.GradSyncPolicy``).
Every rank holds the full fp32 masters; with a ``*_sharded`` mode its
optimizer state covers only its shard of each shardable leaf, and
``TrainState.ef_residual`` holds its error-feedback residuals.  A bucket
that resolves to the ``ring_rdma`` tier runs over a ``PeerWindow`` the
trainer builds once (its size does not depend on the buckets' widths) and
checks once per step, before the update; ``Trainer.close()`` releases it.

The mesh (``Trainer(model, opt, mesh=build_mesh(...))``,
``parallel/mesh.py``) places every parameter by the logical-axis rules
(``parallel/sharding.py``), as the JAX trainer does:

* ``tp``: the model keeps its Megatron shards (heads, MLP columns, vocab
  rows; ``models/llama.py`` ``shard_tensor_parallel``) and the loss is the
  vocab-parallel cross entropy;
* ``fsdp``: FSDP2 ``fully_shard`` on each layer and on the root, over
  the ``DATA_AXES`` submesh (HSDP: replicated over dp, sharded over
  fsdp), each parameter split along the dim the rules give ``fsdp``.
  The sharded fp32 parameters are the masters; FSDP casts them to
  ``grads_dtype`` when it gathers a layer (the compute copy), reduces the
  gradients in fp32, and the trainer rounds each reduced shard to
  ``grads_dtype``, so the norm, the clip and the update see the gradients
  of that dtype, as on one device.  The loss is weighted before the
  backward so that FSDP's mean over the data ranks is the global token
  mean.  A parameter the rules replicate over fsdp (GPT's and ViT's norms
  and biases) stays whole outside FSDP (``ignored_params``): it is its own
  fp32 master, the model casts it where it reads it, and the trainer
  takes the mean of its gradient over the data ranks itself.  GPT's tied
  ``wte`` sits in the root's unit with both of its uses;
* ``dp`` alone (no fsdp): the dp grad sync above over the mesh's dp group,
  every ``grad_sync`` mode with it;
* ``cp``: each rank holds a contiguous chunk of its rows' sequence
  (``shard_batch``) and the model attends across the chunks
  (``models/llama.py`` ``set_context_parallel``: ring attention, or the
  reference core over gathered keys).  Every parameter is replicated over
  cp, but the cp ranks hold different tokens, so every gradient is summed
  over cp: with the data ranks in one group (``dp`` and ``cp`` flattened)
  outside FSDP, after FSDP's reduce under it, each rank's loss weighted by
  its tokens over the global tokens;
* ``ep``: the MoE model keeps E/ep experts on each rank
  (``models/moe.py``); the ep ranks see the same tokens, and the model's
  own exchanges make every non-expert gradient equal on them, so no sync
  runs over ep.

Each (micro)batch's loss is weighted by its tokens before its backward: on
a mesh a rank's loss reaches the other ranks' parameters (through the ring,
the gathered keys, the MoE aux loss's global sums), so its weight must ride
the gradient it sends them.

Each rank's ``TrainState`` holds its local shards (the masters and, since
the optimizer's ``init`` maps over them, the moments); the update is
elementwise and runs on them with no communication; the global norm
all-reduces each leaf's partial sum over the axes that shard it
(``optim.sharded_leaves``).  ``placements`` records each parameter's DTensor
placements on the mesh; ``full_params`` gathers the whole leaves;
``state_layout`` places each local tensor in its global leaf for the flash
checkpoint, and ``load_state`` restores a state across a change of the dp
degree (the reference's).  ``live_reshard`` makes that change in place on a
pure data-parallel mesh (``parallel/reshard.py``): the survivors keep their
tensors, the world re-forms, joiners (``join_live_reshard``) take their
state over it, and the result equals ``load_state``'s bit for bit; a
request the agent stages (``stage_live_reshard``, or the staging file the
trainer polls on its digest cadence) applies at the next step boundary.

The trainer takes the Llama, the MoE Llama, GPT (its default LM loss) and
ViT (``models/vit.vit_loss_fn``) on dp, fsdp and tp; GPT and ViT refuse
cp and ep in their forward (``models/gpt.py``).  It does not pipeline,
as the reference's ``Trainer`` does not: ``pp`` > 1 raises, naming
``models/pipeline_llama.PipelinedLlama``, the function-style pp path.
"""

import dataclasses
import json
import logging
import math
import os
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.profiler import record_function

from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.common.constants import ConfigPath, NodeEnv
from dlrover_tpu_torch.common.pytree import flatten_with_path
from dlrover_tpu_torch.device import DeviceLike, resolve_device
from dlrover_tpu_torch.ops.cuda import ring_reduce_scatter as ring
from dlrover_tpu_torch.parallel import collectives, sharding
from dlrover_tpu_torch.parallel.bucketing import BucketLayout
from dlrover_tpu_torch.parallel.collectives import GradSyncPolicy
from dlrover_tpu_torch.parallel.mesh import (
    MESH_AXIS_NAMES,
    axes_group,
    axis_group,
    mesh_shape,
)
from dlrover_tpu_torch.parallel.peer_memory import PeerWindow
from dlrover_tpu_torch.parallel.process_group import DpGroup
from dlrover_tpu_torch.parallel.tensor_parallel import (
    vocab_parallel_cross_entropy,
)
from dlrover_tpu_torch.trainer import optim
from dlrover_tpu_torch.utils.step_clock import get_step_clock

logger = logging.getLogger(__name__)

# the mesh axes the batch is split over (the reference's default)
DATA_AXES = ("dp", "fsdp")

# the axes whose shards the trainer gathers, in the order they were taken
SPLIT_AXES = ("fsdp", "tp", "ep")


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


def lm_loss(model: torch.nn.Module, logits: torch.Tensor,
            batch) -> torch.Tensor:
    """The next-token loss of ``model``'s logits: over this rank's vocab
    shard when the model is split over tp."""
    tp = getattr(model, "tp", None)
    if tp is not None:
        return vocab_parallel_cross_entropy(
            logits, batch["labels"], tp, batch.get("mask"))
    return cross_entropy_loss(logits, batch["labels"], batch.get("mask"))


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
        mesh=None,
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
        ``GradSyncPolicy(clip_norm=...)``: build the optimizer with
        ``optim.create_sharded_sync_optimizer``, which moves the clip out
        of the chain (a chain clip would see one rank's shard only).

        ``mesh`` (``parallel/mesh.build_mesh``; not with ``dp_group``)
        places the model and its state by ``sharding.DEFAULT_LOGICAL_RULES``
        (module docstring); each rank's ``train_step`` takes its own rows
        (its block of the global batch over ``DATA_AXES``,
        ``rows_of_global_batch``) and their sequence's chunk over cp
        (``shard_batch``).  A non-exact ``grad_sync`` needs a pure
        data-parallel mesh (only dp active).  ``dp_group`` is then the
        group the gradients are summed over outside FSDP: dp, cp, or both
        flattened into one."""
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.optimizer = optimizer
        self.grad_accum_steps = max(1, grad_accum_steps)
        self.grads_dtype = grads_dtype
        self.accum_dtype = accum_dtype
        self._loss_fn = loss_fn or self._default_loss
        self.grad_sync = GradSyncPolicy.parse(grad_sync)
        # the policy as requested: a live reshard re-resolves it against
        # the new world (a dp=1 demotion must not outlive the shrink)
        self._grad_sync_requested = self.grad_sync
        self.mesh = mesh
        # the mesh's layout: leaf name -> groups that hold its other
        # shards, and its placements over MESH_AXIS_NAMES
        self._shard_groups: Dict[str, Tuple[DpGroup, ...]] = {}
        self.placements: Dict[str, Tuple] = {}
        self._data_groups: Tuple[DpGroup, ...] = ()
        self._cp: Optional[DpGroup] = None
        self._fsdp = False
        if mesh is not None:
            if dp_group is not None:
                raise ValueError("pass a mesh or a dp_group, not both")
            dp_group = self._configure_mesh()
        elif dp_group is not None:
            self._data_groups = (dp_group,)
        self._named = dict(self.model.named_parameters())
        self.dp_group = dp_group
        self._sync_world = 1
        self._grad_layout: Optional[collectives.GradLayout] = None
        self._bucket_layout: Optional[BucketLayout] = None
        self._peer_window: Optional[PeerWindow] = None
        self._configure_grad_sync()
        # the state the model's compute copy was last refreshed from
        self._copy_source: Optional[weakref.ref] = None
        self._step_clock = get_step_clock()
        self._last_step_ts: Optional[float] = None
        self._init_telemetry()
        # the live-reshard handshake: a request staged from the agent or
        # the sentinel thread, applied at the next step boundary; the
        # trainer registers as the process target and baselines the
        # staging file, so a stale request cannot reshard a fresh trainer
        self._reshard_mu = threading.Lock()
        self._pending_reshard: Optional[Dict] = None
        self._reshard_seq: Optional[int] = None
        if mesh is not None:
            from dlrover_tpu_torch.parallel import reshard

            reshard.register_reshard_target(self)
            self._reshard_seq = reshard.staged_seq()

    # -- the mesh ----------------------------------------------------------

    def _configure_mesh(self) -> Optional[DpGroup]:
        """Check the mesh against what the port runs; split the model over
        tp (its Megatron shards), ep (its experts) and fsdp (the dim the
        rules give fsdp); hand it the cp group and the data groups; and
        return the group the gradients are summed over outside FSDP (dp,
        cp or both; None under FSDP or with neither)."""
        shape = mesh_shape(self.mesh)
        if shape["pp"] > 1:
            raise NotImplementedError(
                f"pp={shape['pp']}: the Trainer does not pipeline, as the "
                "reference's Trainer does not; pipeline a Llama over pp "
                "function-style with models.pipeline_llama.PipelinedLlama")
        active = [a for a in DATA_AXES if shape[a] > 1]
        if self.grad_sync.active:
            # the reference's refusals (_configure_grad_sync)
            nondata = [a for a, n in shape.items()
                       if a not in DATA_AXES and n > 1]
            if nondata:
                raise ValueError(
                    f"grad_sync={self.grad_sync.mode!r} needs a pure "
                    f"data-parallel mesh; non-data axes {nondata} are "
                    "active (use grad_sync='exact' with model parallelism)")
            bad = [a for a in active if a != "dp"]
            if bad:
                raise ValueError(
                    f"grad_sync={self.grad_sync.mode!r} requires replicated "
                    f"params over the sync axes; active data axes {bad} "
                    "shard params (use grad_sync='exact' with fsdp)")
        groups = {a: axis_group(self.mesh, a)
                  for a in ("fsdp", "tp", "cp", "ep") if shape[a] > 1}
        dims = {"tp": self.model.tp_dims() if "tp" in groups else {},
                "ep": self.model.ep_dims() if "ep" in groups else {}}
        if "tp" in groups:
            self.model.shard_tensor_parallel(groups["tp"])
        if "ep" in groups:
            self.model.shard_expert_parallel(groups["ep"])
        self._cp = groups.get("cp")
        if self._cp is not None:
            self.model.set_context_parallel(self._cp)
        self._data_groups = tuple(axis_group(self.mesh, a) for a in active)
        self.model.set_data_parallel(self._data_groups)
        if "fsdp" in groups:
            self._fully_shard(shape["fsdp"])
        # what was applied: the model's tp and ep shards, FSDP's placements
        for n, p in self.model.named_parameters():
            place = dict.fromkeys(MESH_AXIS_NAMES, Replicate())
            for axis in ("tp", "ep"):
                if n in dims[axis]:
                    place[axis] = Shard(dims[axis][n])
            if isinstance(p, DTensor):  # FSDP's; else whole over fsdp
                place["fsdp"] = p.placements[
                    p.device_mesh.mesh_dim_names.index("fsdp")]
            self.placements[n] = tuple(place.values())
            self._shard_groups[n] = tuple(
                groups[a] for a in SPLIT_AXES
                if a in groups and isinstance(place[a], Shard))
        if self._fsdp:
            return None
        summed = [a for a in ("dp", "cp") if shape[a] > 1]
        return axes_group(self.mesh, summed) if summed else None

    def _fully_shard(self, fsdp: int) -> None:
        """FSDP2 over ``DATA_AXES`` (HSDP) or ``fsdp`` alone: each layer,
        then the root, every parameter split along the dim the rules give
        fsdp; the parameters the rules replicate over fsdp are left out."""
        from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard

        named = dict(self.model.named_parameters())
        fsdp_index = MESH_AXIS_NAMES.index("fsdp")
        by_id, whole = {}, set()
        for n, axes in sharding.param_logical_axes(named).items():
            p = named[n]
            place = sharding.logical_to_mesh_sharding(
                axes, MESH_AXIS_NAMES)[fsdp_index]
            if not isinstance(place, Shard):
                whole.add(p)
                continue
            if p.shape[place.dim] % fsdp:
                raise ValueError(
                    f"fsdp={fsdp} must split {n} {tuple(p.shape)} evenly "
                    f"along the dim the rules give it ({place}): the port "
                    "does not pad an fsdp shard")
            by_id[id(p)] = place
        data = DATA_AXES if mesh_shape(self.mesh)["dp"] > 1 else "fsdp"
        kw = dict(
            mesh=self.mesh[data],
            shard_placement_fn=lambda p: by_id[id(p)],
            # the inputs keep their dtypes: the rope tables stay fp32
            mp_policy=MixedPrecisionPolicy(
                param_dtype=self.grads_dtype,
                reduce_dtype=self.accum_dtype or torch.float32,
                cast_forward_inputs=False),
            ignored_params=whole)
        for layer in self.model.layers:
            fully_shard(layer, **kw)
        fully_shard(self.model, **kw)
        self._fsdp = True

    def shard_batch(self, batch):
        """What this rank computes on of its own rows ``batch``: the rows
        as they are, as the reference's ``shard_batch`` takes each
        process's local data, and on a mesh with cp their sequence's chunk
        (``sharding.shard_batch``).  ``rows_of_global_batch`` cuts a rank's
        rows from a global batch."""
        if self.mesh is not None:
            return sharding.shard_batch(self.mesh, batch)
        return batch

    def rows_of_global_batch(self, batch):
        """This rank's rows of the global ``batch``: over the mesh's data
        axes, or over the dp group; the whole batch on one device."""
        if self.mesh is not None:
            return sharding.rows_of_global_batch(self.mesh, batch, DATA_AXES)
        if self.dp_group is not None:
            g = self.dp_group
            n = next(iter(batch.values())).shape[0] // g.world
            return {k: v[g.rank * n:(g.rank + 1) * n]
                    for k, v in batch.items()}
        return batch

    def _data_world(self) -> int:
        return math.prod(g.world for g in self._data_groups)

    def adjust_accum_for_world(self, global_batch: int,
                               per_device_batch: int) -> int:
        """Preserve the global batch across mesh-size changes (the
        reference ElasticTrainer's gradient-accumulation adjustment)."""
        denom = max(1, per_device_batch * self._data_world())
        self.grad_accum_steps = max(1, global_batch // denom)
        return self.grad_accum_steps

    def state_placements(self, state: "TrainState") -> Dict[str, Tuple]:
        """Placements over ``MESH_AXIS_NAMES`` of the masters and their
        moments in ``state``, by each leaf's path."""
        params = {n: self.placements[n] for n in state.params}
        out = {f"params/{n}": p for n, p in params.items()}
        out.update({f"opt_state/{k}": v for k, v in
                    optim.moment_placements(state.opt_state, params).items()})
        return out

    def state_layout(self, state: "TrainState",
                     rank: Optional[int] = None) -> Dict[str, Tuple]:
        """Where this rank's local tensors of ``state`` sit in their global
        leaves, by each leaf's path: ``{path: (global shape, index box)}``,
        the flash checkpoint's ``snapshot.Layout``; with ``rank``, where
        that rank of the world holds its tensors of the same leaves (each
        rank's local shapes are this rank's: the splits are even), from
        the mesh and the placements alone, with no communication — what
        the distributed persist derives each shard's owner from.  On a
        mesh, the masters
        and moments that a mesh axis splits, by their placements at this
        rank's mesh coordinate (the model's tp and ep shards hold FSDP's
        inside them); under a sharded dp update, each moment's chunk of its
        leaf; under a quantized sync, this rank's row ``[r, r + 1)`` of the
        residual stacked over the dp ranks, ``(dp, *leaf)``, the
        reference's layout.  A leaf it does not name is whole on every
        rank."""
        layout: Dict[str, Tuple] = {}
        local = dict(flatten_with_path(state))
        if self.mesh is not None:
            if rank is None:
                at = self.mesh.get_coordinate()
            else:
                where = (self.mesh.mesh == int(rank)).nonzero()
                if len(where) != 1:
                    raise ValueError(f"rank {rank} is not on the mesh")
                at = where[0].tolist()
            coord = dict(zip(self.mesh.mesh_dim_names, at))
            sizes = mesh_shape(self.mesh)
            for path, place in self.state_placements(state).items():
                if any(isinstance(p, Shard) for p in place):
                    layout[path] = _placed_box(tuple(local[path].shape),
                                               place, coord, sizes)
        if self._sync_active:
            world = self._sync_world
            if rank is None:
                rank = self.dp_group.rank
            elif self.dp_group.group is not None:
                rank = dist.get_group_rank(self.dp_group.group, int(rank))
            if self.grad_sync.sharded_update:
                names = optim.moment_placements(
                    state.opt_state, {n: n for n in self._named})
                for path, name in names.items():
                    dim = self._grad_layout.dims.get(name)
                    if dim is None:
                        continue
                    gshape = list(self._named[name].shape)
                    box = [[0, d] for d in gshape]
                    chunk = gshape[dim] // world
                    box[dim] = [rank * chunk, (rank + 1) * chunk]
                    layout[f"opt_state/{path}"] = (gshape, box)
            for name, t in (state.ef_residual or {}).items():
                layout[f"ef_residual/{name}"] = (
                    [world, *t.shape],
                    [[rank, rank + 1]] + [[0, d] for d in t.shape])
        return layout

    def full_params(self, state: "TrainState") -> Dict[str, torch.Tensor]:
        """The whole fp32 masters, gathered from every shard (collective
        over the mesh's fsdp, tp and ep groups)."""
        groups = {a: axis_group(self.mesh, a) for a in SPLIT_AXES
                  if self.mesh is not None and mesh_shape(self.mesh)[a] > 1}
        out = {}
        for n, t in state.params.items():
            for axis, group in groups.items():  # fsdp split the others
                place = self.placements[n][MESH_AXIS_NAMES.index(axis)]
                if isinstance(place, Shard):
                    parts = group.all_gather(t.contiguous())
                    t = torch.cat(list(parts), dim=place.dim)
            out[n] = t
        return out

    # -- elasticity ----------------------------------------------------------

    def load_state(self, checkpointer) -> Tuple[Optional[TrainState], int]:
        """The flash checkpoint's restore into a fresh state of this
        trainer (``create_state``, filled in place), surviving a change of
        the dp degree under a quantized ``grad_sync``: the reference's
        ``Trainer.load_state``.  Collective: every rank calls it.

        The optimizer moments keep dp-independent global shapes, so the
        storage restore reshards them.  The error-feedback residuals are
        the one dp-shaped leaf (``(dp, *leaf)``, ``state_layout``): when
        the stored degree differs, the stacks are summed on the host and
        every new replica carries ``sum(old residuals) / dp_new``, which
        keeps the total error the old fleet still owed.

        Returns ``(state, step)``; ``(None, -1)`` when nothing restores."""
        target = self.create_state()
        state, step = checkpointer.load_checkpoint(target, trainer=self)
        if target.ef_residual is None:
            return state, step
        if state is None:
            return self._load_state_rebuild_ef(checkpointer, target)
        # the first load covers the EF stacks, so it restored a step saved
        # at this degree; a newer step saved at another degree was skipped
        # by its scan.  The newest step is agreed, so that every rank takes
        # the same branch (a failed agreement keeps this restore)
        engine = checkpointer.engine
        newest = engine.agree_on_step(engine.latest_step())
        if newest <= step:
            return state, step
        logger.info("grad-sync restore: step %d restored but step %d exists "
                    "(saved at another dp degree); restoring the newer step "
                    "with redistributed error feedback", step, newest)
        newer_state, newer_step = self._load_state_rebuild_ef(checkpointer,
                                                              target)
        if newer_state is None or newer_step <= step:
            return state, step
        return newer_state, newer_step

    def _load_state_rebuild_ef(self, checkpointer, target: TrainState):
        """``load_state``'s fallback: the rest of the state without the
        residuals (collective), then residuals rebuilt from what the agreed
        step stores: stacks of another degree redistributed over this one,
        zero where a leaf has none (a checkpoint of an exact policy, or a
        leaf that only this degree shards)."""
        state, step = checkpointer.load_checkpoint(
            dataclasses.replace(target, ef_residual=None), trainer=self)
        if state is None:
            return None, -1
        paths = {f"ef_residual/{n}": n for n in target.ef_residual}
        # on the host, summed per leaf as read (as the reference sums, in
        # numpy): the host holds one leaf's stack at a time
        stored = checkpointer.engine.storage_leaf_sums(list(paths), step)
        totals = {n: np.zeros(tuple(t.shape), np.float32)
                  for n, t in target.ef_residual.items()}
        for path, total in (stored or {}).items():
            totals[paths[path]] = total
        world = self._sync_world
        logger.info("grad-sync restore at step %d: redistributing the "
                    "error-feedback residuals over dp=%d (%d/%d stacks "
                    "stored, the rest zero)", step, world,
                    len(stored or {}), len(totals))
        # what convergence needs is the TOTAL un-injected error: each
        # replica adds its residual back before it quantizes, and the
        # reduce sums over the replicas; so every replica of the new
        # degree carries total / world (the reference's
        # materialize_ef_stack; a rank holds its own row only)
        ef = {n: torch.from_numpy(total / np.float32(world)).to(self.device)
              for n, total in totals.items()}
        return dataclasses.replace(state, ef_residual=ef), step

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
                if any(self._resolved(b) == "ring_rdma"
                       for b in buckets.buckets):
                    self._peer_window = PeerWindow(self.dp_group)
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
            if self._fsdp:
                # FSDP's sharded fp32 params are the masters (views: the
                # update lands where the next gather reads)
                masters = {n: _local(p).detach()
                           for n, p in self._named.items()}
            else:
                masters = {n: p.detach().float().clone()
                           for n, p in self._named.items()}
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
        state = TrainState(
            step=0, params=masters,
            opt_state=self.optimizer.init(update_params), ef_residual=ef,
        )
        self._copy_source = weakref.ref(state)
        return state

    # -- train step ----------------------------------------------------------

    def _default_loss(self, batch):
        return lm_loss(self.model, self.model(batch["input_ids"]), batch)

    def _grad_fn(self, batch, weight: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, grads) w.r.t. the model's parameters (the bf16 copy when
        ``grads_dtype`` is set); with ``weight``, the grads of the loss
        times ``weight``."""
        names = list(self._named)
        loss = self._loss_fn(batch)
        target = loss if weight is None else loss * weight
        grads = torch.autograd.grad(target, [self._named[n] for n in names])
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
        context managers that record only while a profiler runs.  The
        telemetry hooks run around it (module docstring).  A staged live
        reshard applies first, at this step boundary
        (``stage_live_reshard``): the step then runs on the new mesh and
        on the state it returns."""
        if self._pending_reshard is not None:
            with self._reshard_mu:
                pending, self._pending_reshard = self._pending_reshard, None
            state = self._apply_pending_reshard(pending, state)
        if not self._steps_begun:
            result = self._first_step(state, batch)
        else:
            result = self._step_fn(state, batch)
            dur = self._tick()
            t0 = time.perf_counter()
            self._digest_steps += 1
            self._note_step_time(self._digest_steps, dur)
            self.telemetry_s += time.perf_counter() - t0
        self._world_steps += 1
        self._world_cadence(self._world_steps - 1)
        return result

    def _step(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        batch = self._to_device(batch)
        if self._copy_source is None or self._copy_source() is not state:
            self.refresh_compute_copy(state)
        if self._sync_world > 1:
            with optim.sharded_leaves(self._shard_groups):
                metrics = self._sync_step(state, batch)
            state.step += 1
            return state, metrics
        with record_function("trainer.forward_backward"):
            if self._fsdp:
                loss, grads = self._fsdp_grads(batch)
            elif self.grad_accum_steps == 1:
                loss, grads = self._grad_fn(batch)
            else:
                loss_sum, grad_sum, w_sum = self._accumulate(batch)
                w_sum = w_sum.clamp(min=1e-8)
                loss = loss_sum / w_sum
                grads = {n: g / w_sum.to(g.dtype)
                         for n, g in grad_sum.items()}

        with record_function("trainer.update"), \
                optim.sharded_leaves(self._shard_groups):
            grad_norm = optim.global_norm(grads)
            # the policy's clip applies here too, so a job whose dp world
            # shrinks to 1 keeps the same update math
            grads = self._clip(grads, grad_norm)
            updates, state.opt_state = self.optimizer.update(
                grads, state.opt_state, state.params
            )
            optim.apply_updates(state.params, updates)
            self.refresh_compute_copy(state)
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm}

    def _tick(self) -> Optional[float]:
        """Feed the staging pacer: the wall time between successive steps
        tracks the step cadence in any loop that reads a result.  Returns
        that time (None at the first step)."""
        now = time.monotonic()
        dur = None
        if self._last_step_ts is not None:
            dur = now - self._last_step_ts
            self._step_clock.record(dur)
        self._last_step_ts = now
        return dur

    # -- telemetry (observability/) ------------------------------------------

    def _init_telemetry(self) -> None:
        """The comm probe over the mesh's active axes or the dp group
        (when ``DLROVER_TPU_COMM_PROBE_EVERY`` > 0) and the watched step
        (``jitscope.watch``, when the compile scope is on)."""
        self._comm_probe = None
        self._comm_bucket_scope = None
        self._digest_steps = 0
        # steps since this trainer's world formed: every rank of a world
        # counts the same (rebind_mesh restarts it; a joiner starts at 0)
        self._world_steps = 0
        self._steps_begun = False
        self.telemetry_s = 0.0
        self._step_fn = self._step
        self._comm_probe = self._make_comm_probe()
        try:
            from dlrover_tpu_torch.observability import jitscope

            if jitscope.enabled():
                # the kernel builds a step pays become classified compile
                # events; the hot path costs two counter reads
                self._step_fn = jitscope.watch(
                    self._step, "trainer.train_step",
                    static={"donate": True, "accum": self.grad_accum_steps})
        except Exception as e:  # noqa: BLE001 - telemetry must not break
            logger.debug("jitscope watch unavailable: %s", e)  # the step

    def _make_comm_probe(self):
        """The comm probe over the mesh's active axes or the dp group, or
        None (``DLROVER_TPU_COMM_PROBE_EVERY`` is 0, or it failed)."""
        try:
            from dlrover_tpu_torch.observability import commscope

            if commscope.probe_every() > 0:
                return (commscope.MeshProbe.for_mesh(self.mesh)
                        if self.mesh is not None
                        else commscope.MeshProbe.for_group("dp",
                                                           self.dp_group))
        except Exception as e:  # noqa: BLE001 - telemetry must not break
            logger.debug("comm probe unavailable: %s", e)  # construction
        return None

    def _first_step(self, state: TrainState, batch):
        """The first step, where the reference has its first dispatch:
        the memory scope's device probe before it, then the goodput
        ledger's compile window (when it built kernels) and the memory
        scope's registration after it."""
        t0 = time.perf_counter()
        mem_before = 0.0
        try:
            from dlrover_tpu_torch.observability import memscope

            if memscope.enabled():
                memscope.scope().bind_device(self.device)
                mem_before = memscope.scope().device_used_bytes()
        except Exception:  # noqa: BLE001 - telemetry must not break
            pass  # a training step
        self.telemetry_s += time.perf_counter() - t0
        start = time.time()
        result = self._step_fn(state, batch)
        end = time.time()
        self._tick()
        t0 = time.perf_counter()
        try:
            from dlrover_tpu_torch.observability import goodput

            event = getattr(self._step_fn, "last_event", None)
            if event and event["compile_s"] > 0:
                # measured build seconds split the window: the compile
                # head, the step's execution the remainder
                goodput.charge_compile_window(start, end,
                                              event["compile_s"])
        except Exception:  # noqa: BLE001 - the ledger must not break
            pass  # a training step
        self._register_memscope(state, mem_before)
        self._steps_begun = True
        self.telemetry_s += time.perf_counter() - t0
        return result

    def mesh_axes(self) -> Optional[Dict[str, int]]:
        """Axis name -> size of this trainer's layout: the mesh's, or the
        dp group's as one axis ``dp``; None on one device."""
        if self.mesh is not None:
            return mesh_shape(self.mesh)
        if self.dp_group is not None:
            return {"dp": self.dp_group.world}
        return None

    def state_axes(self, state: TrainState) -> Dict[str, List[str]]:
        """The axes that split each leaf of ``state``, by its path: on a
        mesh the axes of its ``Shard`` placements (``state_placements``);
        under a sharded dp update ``dp`` for the moments of each leaf the
        layout shards (each rank keeps a chunk), and under a quantized
        sync ``dp`` for the residuals (``(dp, *leaf)``, ``state_layout``).
        A leaf it does not name is whole on every rank.  No
        communication: the memory scope prices the state from it, where
        the reference reads each leaf's ``PartitionSpec``."""
        axes: Dict[str, List[str]] = {}
        if self.mesh is not None:
            for path, place in self.state_placements(state).items():
                split = [a for a, p in zip(MESH_AXIS_NAMES, place)
                         if isinstance(p, Shard)]
                if split:
                    axes[path] = split
        if self._sync_active:
            if self.grad_sync.sharded_update:
                names = optim.moment_placements(
                    state.opt_state, {n: n for n in self._named})
                for path, name in names.items():
                    if self._grad_layout.dims.get(name) is not None:
                        axes.setdefault(f"opt_state/{path}", []).append("dp")
            for name in state.ef_residual or {}:
                axes[f"ef_residual/{name}"] = ["dp"]
        return axes

    def _register_memscope(self, state: TrainState, mem_before_b: float):
        """Adopt the live train state as the memory scope's attribution
        plan, price the bucketed grad-sync buffers, and book the first
        step's live-buffer delta.  Never raises into the training
        loop."""
        try:
            from dlrover_tpu_torch.observability import memscope

            if not memscope.enabled():
                return
            sc = memscope.scope()
            sc.register_state(state, self.mesh_axes(),
                              self.state_axes(state))
            if self._bucket_layout is not None:
                sc.register_buckets(self._bucket_layout, self._sync_world)
            if mem_before_b > 0:
                sc.note_compile_delta(mem_before_b, sc.device_used_bytes())
        except Exception as e:  # noqa: BLE001 - telemetry must not break
            logger.debug("memscope registration failed: %s", e)  # a step

    def _maybe_probe_comm(self, step: int):
        """On the probe cadence, run the comm probe (and, when the sync
        is bucketed, each bucket's chain) into the process comm scope.
        Every rank fires them at the same step; a broken probe never
        breaks the step."""
        if self._comm_probe is None:
            return
        try:
            from dlrover_tpu_torch.observability import commscope

            every = commscope.probe_every()
            if every <= 0 or step % every != 0:
                return
            self._comm_probe.probe_once(commscope.scope().fabric)
            # the reference re-prices its transport grid here
            # (_maybe_retune): ROADMAP item 6d
            if (self._bucket_layout is not None
                    and envs.get_bool("DLROVER_TPU_COMM_BUCKET_PROBE")):
                if self._comm_bucket_scope is None:
                    self._comm_bucket_scope = (
                        commscope.BucketScope.for_trainer(self))
                if self._comm_bucket_scope is not None:
                    self._comm_bucket_scope.measure(reps=1)
        except Exception as e:  # noqa: BLE001 - telemetry must not break
            logger.debug("comm probe failed: %s", e)  # a training step

    def _note_step_time(self, step: int, dur_s: float):
        """Feed the flight recorder's step ring and the goodput ledger
        and, every ``DLROVER_TPU_DIGEST_EVERY`` steps, write this rank's
        digest file (``ConfigPath.RUNTIME_METRICS``.rank<id>), the file an
        agent folds into its heartbeat.  Never raises into the training
        loop."""
        try:
            from dlrover_tpu_torch.observability import (
                commscope,
                flight_recorder,
                goodput,
                jitscope,
                memscope,
            )

            flight_recorder.on_step(step, dur_s)
            goodput.on_step(step, dur_s)
            every = envs.get_int("DLROVER_TPU_DIGEST_EVERY")
            if every <= 0 or step % every != 0:
                return
            digest = flight_recorder.recorder().step_digest()
            if not digest:
                return
            # this rank's cumulative goodput account, the fabric model
            # (fxl_/fxb_), the memory account sampled here (mm_/mms_) and
            # the compile counters (js_) ride the same file
            if goodput.enabled():
                digest.update(goodput.ledger().digest())
            digest.update(commscope.scope().digest())
            memscope.sample()
            digest.update(memscope.scope().digest())
            if jitscope.enabled():
                digest.update(jitscope.scope().digest())
            path = (envs.get_str(ConfigPath.ENV_RUNTIME_METRICS)
                    + f".rank{_process_id()}")
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(digest, f)
            os.replace(tmp, path)
        except Exception as e:  # noqa: BLE001 - telemetry must not break
            logger.debug("step digest drop failed: %s", e)  # a step

    def _world_cadence(self, step: int) -> None:
        """The collectives that ride the step cadence: the comm probe and
        the staged-reshard poll.  ``step`` is the world's step count less
        the first step, which every rank of a world reaches at the same
        step (a joiner and the survivors of a grow too), so the ranks enter
        these collectives together."""
        if step <= 0:
            return
        t0 = time.perf_counter()
        self._maybe_probe_comm(step)
        self._maybe_poll_reshard(step)
        self.telemetry_s += time.perf_counter() - t0

    def _maybe_poll_reshard(self, step: int) -> None:
        """On the digest cadence, stage any live reshard the agent wrote to
        the staging file: a brain-ordered transition applies within
        ``DLROVER_TPU_DIGEST_EVERY`` steps plus one step boundary.  Only a
        pure data-parallel mesh polls (the port re-lays the dp axis of such
        a mesh only); over several ranks the sequence is the world's
        minimum, an all-reduce outside any telemetry guard, so an error
        fails every rank's step alike."""
        every = envs.get_int("DLROVER_TPU_DIGEST_EVERY")
        if every <= 0 or step % every != 0 or self.mesh is None:
            return
        if any(s > 1 for a, s in mesh_shape(self.mesh).items() if a != "dp"):
            return
        # the staged DCN-demotion poll goes here too: ROADMAP item 6d
        from dlrover_tpu_torch.parallel import reshard

        several = dist.is_initialized() and dist.get_world_size() > 1
        self._reshard_seq = reshard.poll_staged_reshard(
            self, self._reshard_seq,
            agree=self._agree_min if several else None)

    def _agree_min(self, value: int) -> int:
        """The smallest ``value`` over the world's ranks (collective)."""
        if not dist.is_initialized() or dist.get_world_size() <= 1:
            return int(value)
        t = DpGroup(self.device).all_reduce(
            torch.tensor([int(value)], dtype=torch.int64,
                         device=self.device), op=dist.ReduceOp.MIN)
        return int(t.item())

    # -- live elastic resharding ---------------------------------------------

    def rebind_mesh(self, new_mesh) -> None:
        """Re-form this trainer around ``new_mesh`` without its process
        restarting (the live reshard): restores the originally requested
        grad-sync policy, re-resolves the mesh's groups and the sync's
        world, and rebuilds every mesh-derived artifact: the leaf and
        bucket layouts (through the same deterministic
        ``BucketLayout.signature()`` path a fresh start takes), the comm
        probe, the compute-copy source and the step-time baseline (the
        reshard gap is not charged as a step).  The world's step count
        restarts, so the new world's ranks keep the step cadence's
        collectives in step, and the trainer becomes the process's
        live-reshard target.  The model keeps its parameters;
        ``create_state`` gives the state's new layout."""
        self.mesh = new_mesh
        self._shard_groups = {}
        self.placements = {}
        self._data_groups = ()
        self._cp = None
        self._fsdp = False
        self.grad_sync = self._grad_sync_requested
        self.dp_group = (self._configure_mesh() if new_mesh is not None
                         else None)
        self._sync_world = 1
        self._grad_layout = None
        self._bucket_layout = None
        self._peer_window = None
        self._configure_grad_sync()
        self._copy_source = None
        self._comm_probe = self._make_comm_probe()
        self._comm_bucket_scope = None
        self._world_steps = 0
        self._step_clock.reset()
        self._last_step_ts = None
        if new_mesh is not None:
            from dlrover_tpu_torch.parallel import reshard

            reshard.register_reshard_target(self)

    def stage_live_reshard(self, axes, reason: str = "") -> None:
        """Stage a live mesh transition (safe from the agent or sentinel
        thread); the training thread applies it at the next step
        boundary, never mid-step."""
        axes = {str(a): int(s) for a, s in dict(axes or {}).items()}
        if not axes:
            return
        with self._reshard_mu:
            self._pending_reshard = {"axes": axes,
                                     "reason": str(reason or "")}
        logger.info("live reshard to %s staged: applies at the next step "
                    "boundary (%s)", axes, reason or "unspecified")

    def live_reshard(self, state: TrainState, new_axes, *, survivors=None,
                     donor=None, reason: str = ""):
        """Synchronous in-place transition of a survivor
        (``parallel/reshard.py``): plan (gated by the measured fit
        report), pull the survivors' state over the world, read from the
        sealed donor manifest only the shards no survivor holds, re-form
        the world and rebind this trainer to the new mesh.  Collective
        over the survivors of ``survivors`` (default: every old rank) and
        the joiners (``join_live_reshard``).  Returns ``(new_state,
        report)``; a rank the new world has no room for gets ``(None,
        report)`` and has left the world.  Raises
        ``reshard.ReshardRefused`` when the plan cannot be honoured,
        before any world changes: the caller falls back to the restart
        path."""
        from dlrover_tpu_torch.parallel import reshard

        plan = reshard.plan_reshard(self.mesh_axes() or {}, new_axes,
                                    survivors=survivors, reason=reason)
        if donor is None:
            donor = reshard.donor_engine()
        return reshard.execute_reshard(self, state, plan, donor=donor)

    def join_live_reshard(self, new_axes, rank: int, *, donor=None,
                          reason: str = ""):
        """A joiner's side of a live grow: this trainer (its model and
        optimizer; no mesh, no state) enters the re-formed world as new
        rank ``rank`` and takes the state from the survivors.  Returns
        ``(state, report)``."""
        from dlrover_tpu_torch.parallel import reshard

        return reshard.join_reshard(self, new_axes, rank, donor=donor,
                                    reason=reason)

    def _apply_pending_reshard(self, pending, state: TrainState):
        """Apply one staged request at the step boundary: reshard onto the
        new mesh.  A refusal (a grow among them: nothing staged starts its
        joiners) logs and keeps the old mesh and state; a rank
        the new world has no room for raises ``reshard.LeftWorld`` (its
        process is done)."""
        from dlrover_tpu_torch.parallel import reshard

        axes = dict((pending or {}).get("axes") or {})
        if not axes:
            return state
        try:
            if (reshard.replica_world(axes)
                    > reshard.replica_world(self.mesh_axes() or {})):
                # every old rank survives a staged request, and nothing
                # staged starts the joiners a grow needs
                raise reshard.ReshardRefused(
                    f"a staged grow to {axes} has no joiners to start; "
                    "a grow is Trainer.live_reshard with joiners in "
                    "join_live_reshard")
            new_state, report = self.live_reshard(
                state, axes, reason=str(pending.get("reason", "")))
        except reshard.ReshardRefused as e:
            logger.warning("staged live reshard to %s refused; continuing "
                           "on the current mesh: %s", axes, e)
            return state
        if new_state is None:
            raise reshard.LeftWorld(
                f"this rank left the world at the live reshard to {axes}")
        logger.info("live reshard applied at the step boundary: %s -> %s "
                    "(%d donor bytes)", report["old_axes"],
                    report["new_axes"], report["donor_bytes_read"])
        return new_state

    def _clip(self, grads, grad_norm):
        """``GradSyncPolicy.clip_norm``: scale by min(1, clip / norm)."""
        clip = self.grad_sync.clip_norm
        if clip is None:
            return grads
        scale = torch.clamp(clip / grad_norm.clamp(min=1e-12), max=1.0)
        return {n: g * scale.to(g.dtype) for n, g in grads.items()}

    def refresh_compute_copy(self, state: TrainState) -> None:
        """Copy the masters of ``state`` into the model's compute copy
        (with ``grads_dtype``; without it the model's parameters are the
        masters of the state ``create_state`` made).  Under FSDP the
        sharded params are the masters and each gather makes the copy;
        a state the trainer did not make is copied into them."""
        if self._fsdp:
            with torch.no_grad():
                for n, p in self._named.items():
                    local = _local(p)
                    if local.data_ptr() != state.params[n].data_ptr():
                        local.copy_(state.params[n])
        elif self.grads_dtype is not None:
            with torch.no_grad():
                for n, p in self._named.items():
                    p.copy_(state.params[n])
        self._copy_source = weakref.ref(state)

    def _fsdp_grads(self, batch) -> Tuple[torch.Tensor,
                                          Dict[str, torch.Tensor]]:
        """The global mean loss and this rank's shards of the global mean
        gradient under FSDP.  FSDP reduces each backward's gradients to
        their mean over the data ranks, so each microbatch's loss is
        weighted by ``w_mb * data_world / w_global`` (its token weight over
        the global weight, all-reduced before the first backward): the
        reduced sum is then exactly the global mask-weighted mean."""
        accum = self.grad_accum_steps
        batch_dim = next(iter(batch.values())).shape[0]
        if batch_dim % accum != 0:
            raise ValueError(
                f"batch size {batch_dim} not divisible by "
                f"grad_accum_steps {accum}; no sample may be dropped")
        micro = batch_dim // accum
        mbs = [{k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
               for i in range(accum)]
        weights = [self._mb_weight(mb, micro, self.device) for mb in mbs]
        w_global = self._token_all_reduce(torch.stack(weights).sum())
        w_global = w_global.clamp(min=1e-8)
        scale = self._data_world() / w_global
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        grads: Dict[str, torch.Tensor] = {}
        for mb, w in zip(mbs, weights):
            loss = self._loss_fn(mb)
            (loss * (w * scale)).backward()
            loss_sum = loss_sum + loss.detach().float() * w
            for n, p in self._named.items():
                # FSDP reduces in fp32 into the fp32 shard (over the data
                # ranks; the sum over cp follows): round to grads_dtype,
                # the gradients the other paths update with
                if not isinstance(p.grad, DTensor):
                    # whole, outside FSDP: the same mean and sum, here
                    g = self._token_all_reduce(p.grad) / self._data_world()
                else:
                    g = p.grad.to_local()
                    if self._cp is not None:
                        g = self._cp.all_reduce(g)
                if self.grads_dtype is not None:
                    g = g.to(self.grads_dtype)
                if accum == 1:
                    grads[n] = g
                elif n in grads:
                    grads[n] += g.to(grads[n].dtype)
                else:
                    grads[n] = g.to(self.accum_dtype or torch.float32)
                p.grad = None
        return self._token_all_reduce(loss_sum) / w_global, grads

    def _token_all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over every rank that holds other tokens: the data
        ranks and the cp ranks."""
        for group in self._data_groups + ((self._cp,) if self._cp else ()):
            t = group.all_reduce(t)
        return t

    # -- data-parallel step ----------------------------------------------------

    def _accumulate_local(self, batch):
        """This rank's UNNORMALIZED ``(loss_sum, grad_sum, w_sum)``, so
        that ``all_reduce(grad_sum) / all_reduce(w_sum)`` is the exact
        global (mask-weighted) mean gradient; fp32 sums."""
        if self.grad_accum_steps == 1:
            w = self._mb_weight(batch, next(iter(batch.values())).shape[0],
                                self.device)
            loss, grads = self._grad_fn(batch, w)
            return loss * w, {n: g.float() for n, g in grads.items()}, w
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
            self.refresh_compute_copy(state)
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
            loss, grads = self._grad_fn(mb, w)
            loss_sum = loss_sum + loss * w
            for n, g in grads.items():
                acc = grad_sum[n]
                acc += g.to(acc.dtype)
            w_sum = w_sum + w
        return loss_sum, grad_sum, w_sum


def _process_id() -> int:
    """This rank's id in its digest file's name: the rank of the
    ``torch.distributed`` world when one is initialised (the port's
    identity of a rank), else ``NodeEnv.PROCESS_ID``."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return envs.get_int(NodeEnv.PROCESS_ID)


def _placed_box(shape: Tuple[int, ...], placements, coord: Dict[str, int],
                sizes: Dict[str, int]) -> Tuple[list, list]:
    """``(global shape, index box)`` of a local tensor of ``shape`` with
    ``placements`` over ``MESH_AXIS_NAMES`` at mesh coordinate ``coord``.
    Along a dim split by several axes the model's shards (tp, ep) are the
    outer split and FSDP's the inner one, as ``full_params`` gathers
    them."""
    gshape, box = list(shape), [[0, d] for d in shape]
    for dim, size in enumerate(shape):
        axes = [a for a in ("tp", "ep", "fsdp")
                if isinstance(placements[MESH_AXIS_NAMES.index(a)], Shard)
                and placements[MESH_AXIS_NAMES.index(a)].dim % len(shape)
                == dim]
        if not axes:
            continue
        gshape[dim] = size * math.prod(sizes[a] for a in axes)
        start, length = 0, gshape[dim]
        for a in axes:
            length //= sizes[a]
            start += coord[a] * length
        box[dim] = [start, start + size]
    return gshape, box


def _local(p: torch.Tensor) -> torch.Tensor:
    """This rank's shard of an FSDP parameter; a whole one as it is."""
    return p.to_local() if isinstance(p, DTensor) else p
