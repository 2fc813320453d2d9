"""Pipeline-parallel Llama: GPipe stages over the ``pp`` mesh axis.

Port of ``dlrover_tpu/models/pipeline_llama.py``.  ``PipelinedLlama``
runs a ``LlamaForCausalLM`` (``.model``; the reference builds its own
from the config, here the caller hands it the model with its weights)
and uses its parameters and their names unchanged: the pipeline is
another schedule over the same state, so a state trained one way loads
into the other.  Stage ``r`` runs
``layers[r·L/P : (r+1)·L/P]`` (``parallel/pipeline.py``) on the
full-sequence rope rows, each layer under ``config.attention_impl`` (the
flash kernels with ``"flash"``: forward, dQ and dK/dV once per
microbatch and layer, and the forward again in remat's recompute) and
checkpointed when ``config.remat``, as the reference remats each layer.
The embedding, final norm and LM head run replicated on every pp rank
(the head with compute-dtype operands and fp32 accumulation, the model's
``LMHead``); only the decoder-layer stack is staged.

The reference refuses ``scan_layers=False`` because its stages are
slices of the scan-stacked layer params; the port's layers are always
unrolled (one module per layer), so there is nothing to refuse.

Like the reference, this is a function-style path: the ``Trainer`` does
not pipeline.  A step (``parallel/mesh_workers.pipeline_worker``) runs the
forward on this rank's rows (``shard_batch``), its loss and backward, then
``sync_grads``: layer and embedding gradients are summed over pp (only
the owning stage, or stage 0 for the embedding, produces them; the
others hold zeros), head and final-norm gradients are already equal on
every pp rank, and every gradient is averaged over dp; so every rank
holds the whole gradient and, after the optimizer, the whole updated
state, as the reference's replicated optax step does.  The pipeline
composes with dp only (the reference's: tp and fsdp inside a stage are
future work there too).
"""

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.models.llama import LlamaForCausalLM, _rope_tables
from dlrover_tpu_torch.parallel import sharding
from dlrover_tpu_torch.parallel.mesh import axis_group, mesh_shape
from dlrover_tpu_torch.parallel.pipeline import pipeline_apply, stage_params


class PipelinedLlama:
    """Same parameters as ``LlamaForCausalLM``, pipelined execution over
    the mesh's ``pp`` stages; composes with ``dp``."""

    def __init__(self, model: LlamaForCausalLM, mesh,
                 num_microbatches: int = 4):
        config = model.config
        shape = mesh_shape(mesh)
        other = {a: n for a, n in shape.items()
                 if a not in ("dp", "pp") and n > 1}
        if other:
            raise ValueError(f"PipelinedLlama composes with dp only; the "
                             f"mesh has {other}")
        self.config, self.mesh = config, mesh
        self.num_stages = shape["pp"]
        if config.num_layers % self.num_stages:
            raise ValueError(
                f"{config.num_layers} layers not divisible by "
                f"{self.num_stages} pipeline stages")
        self.num_microbatches = num_microbatches
        self.model = model
        self.pp = axis_group(mesh, "pp")
        self.dp = axis_group(mesh, "dp") if shape["dp"] > 1 else None
        self._stages = stage_params(list(self.model.layers),
                                    self.num_stages)
        self._piped = pipeline_apply(self._stage_fn, mesh, num_microbatches)

    def num_params(self) -> int:
        return self.model.num_params()

    def _stage_fn(self, layers, h):
        cfg = self.config
        cos, sin = _rope_tables(h.shape[1], cfg.head_dim, cfg.rope_theta,
                                h.device)
        for layer in layers:
            if cfg.remat:
                h = checkpoint(layer, h, cos, sin, use_reentrant=False)
            else:
                h = layer(h, cos, sin)
        return h

    def __call__(self, input_ids: torch.Tensor) -> torch.Tensor:
        """fp32 logits of this rank's rows ``input_ids`` ([B, S]), on
        every pp rank.  Collective over pp."""
        model, cfg = self.model, self.config
        x = F.embedding(input_ids, model.embed_tokens.to(cfg.dtype))
        x = self._piped(self._stages, x)
        return model.lm_head(model.final_norm(x))

    def shard_batch(self, batch):
        """What this rank computes on of its own rows ``batch``: the rows
        as they are, as the reference's ``shard_batch`` takes each
        process's local data (the pp ranks of one dp rank pass the same
        rows; ``rows_of_global_batch`` cuts them from a global batch)."""
        return sharding.shard_batch(self.mesh, batch)

    def rows_of_global_batch(self, batch):
        """This rank's rows of the global ``batch`` over dp."""
        return sharding.rows_of_global_batch(self.mesh, batch, ("dp",))

    @torch.no_grad()
    def sync_grads(self) -> None:
        """Make every parameter's ``.grad`` the whole gradient of the
        global mean loss (module docstring); collective over pp and dp."""
        replicated = {"final_norm.scale", "lm_head.weight"}
        for name, p in self.model.named_parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            if name not in replicated:
                p.grad = self.pp.all_reduce(p.grad)
            if self.dp is not None:
                p.grad = self.dp.all_reduce(p.grad) / self.dp.world
