"""A rank function for the mesh tests (not a test module: pytest does
not collect it).  ``process_group.spawn`` runs it in gloo ranks on the CPU;
this module imports torch and the port only, so a spawned rank that
unpickles the function never imports JAX."""

import os
import tempfile
from typing import Any, Dict, List, Tuple

import torch

from dlrover_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from dlrover_tpu_torch.models.moe import MoELlamaConfig, MoELlamaForCausalLM
from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu_torch.parallel.process_group import DpGroup
from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
    CheckpointEngine,
)
from dlrover_tpu_torch.trainer.optim import create_optimizer
from dlrover_tpu_torch.trainer.train import Trainer


def _trainer(axes: Dict[str, int], model=None, **kw) -> Trainer:
    mesh = build_mesh(MeshConfig.from_dict(axes), device="cpu")
    model = model or LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32),
                                      device="cpu")
    return Trainer(model, create_optimizer(), mesh=mesh, device="cpu", **kw)


def refusal_worker(group: DpGroup) -> Dict[str, Tuple[str, str]]:
    """On 8 ranks: ``{case: (exception type, message)}`` of each refused
    trainer (``("accepted", "")`` for a mesh the trainer takes) and of the
    flash checkpoint (accepted: ``"process <rank> of <world>"``, its
    identity from the world), and ``adjust_accum_for_world``'s
    answer for 64 rows at 1 per device on dp=4 x fsdp=2."""
    cases = {
        "int8 on tp=2": (dict(dp=4, tp=2), dict(grad_sync="int8")),
        "int8 on fsdp=2": (dict(dp=4, fsdp=2), dict(grad_sync="int8")),
        "cp=2": (dict(dp=4, cp=2), {}),
        "ep=2": (dict(dp=4, ep=2), {}),
        "pp=2": (dict(dp=4, pp=2), {}),
        "mesh and dp_group": (dict(dp=8), dict(dp_group=group)),
        "tp=4 over 2 kv heads": (dict(dp=2, tp=4), {}),
        "flash on cp=2": (dict(dp=4, cp=2), dict(model=LlamaForCausalLM(
            LlamaConfig.tiny(attention_impl="flash"), device="cpu"))),
        "moe on cp=2": (dict(dp=4, cp=2), dict(model=MoELlamaForCausalLM(
            MoELlamaConfig.tiny_moe(), device="cpu"))),
        "ep=8 over 4 experts": (dict(dp=1, ep=8), dict(
            model=MoELlamaForCausalLM(MoELlamaConfig.tiny_moe(),
                                      device="cpu"))),
    }
    out = {}
    for case, (axes, kw) in cases.items():
        try:
            _trainer(axes, **kw)
        except (ValueError, NotImplementedError) as e:
            out[case] = (type(e).__name__, str(e))
        else:
            out[case] = ("accepted", "")
    with tempfile.TemporaryDirectory() as tmp:
        try:
            engine = CheckpointEngine(tmp, scope=os.path.basename(tmp),
                                      device="cpu")
        except (ValueError, NotImplementedError) as e:
            out["flash checkpoint"] = (type(e).__name__, str(e))
        else:
            out["flash checkpoint"] = (
                "accepted",
                f"process {engine.process_id} of {engine.num_processes}")
            engine.close()
    out["accum"] = _trainer(dict(dp=4, fsdp=2)).adjust_accum_for_world(64, 1)
    return out


def own_rows_worker(group: DpGroup, spec: Dict[str, Any]) -> List[float]:
    """A mesh trainer (``spec["axes"]``) of ``dp_workers.make_model(spec)``
    fed, as the reference's scripts feed each process, only this rank's
    own rows (``spec["rank_rows"][rank]``) through ``shard_batch``; the
    losses of ``spec["steps"]`` steps."""
    from dlrover_tpu_torch.parallel.dp_workers import make_model

    trainer = Trainer(make_model(spec, "cpu"),
                      create_optimizer(**spec["optimizer"]),
                      mesh=build_mesh(MeshConfig.from_dict(spec["axes"]),
                                      device="cpu"), device="cpu")
    state = trainer.create_state()
    batch = trainer.shard_batch(spec["rank_rows"][group.rank])
    losses = []
    for _ in range(spec["steps"]):
        state, metrics = trainer.train_step(state, batch)
        losses.append(metrics["loss"].item())
    return losses
