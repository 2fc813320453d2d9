"""A rank function for the GPT and ViT trainer tests (not a test module:
pytest does not collect it).  ``process_group.spawn`` runs it in gloo
ranks on the CPU; it imports torch and the port only."""

from typing import Any, Dict

import numpy as np

from dlrover_tpu_torch.parallel import dp_workers
from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu_torch.parallel.process_group import DpGroup


def worker(group: DpGroup, spec: Dict[str, Any]) -> Dict[str, Any]:
    """``dp_workers.train_worker`` over ``spec["runs"]``, then each case of
    ``spec["refusals"]`` (``{name: {"axes", "spec"}}``, the spec's keys
    replaced by the case's): the trainer on that mesh, ``create_state``,
    and one ``train_step`` on the first rows of the batch.  Returns the
    training record and, per case, whether the state was made and
    ``("accepted", "")`` or the step's exception's type and message."""
    out = dp_workers.train_worker(group, spec)
    out["refusals"] = {name: _attempt(group, dict(spec, **case["spec"]),
                                      case["axes"])
                       for name, case in spec.get("refusals", {}).items()}
    return out


def _attempt(group: DpGroup, spec: Dict[str, Any], axes) -> Dict[str, Any]:
    from dlrover_tpu_torch.trainer.optim import create_optimizer
    from dlrover_tpu_torch.trainer.train import Trainer

    model = dp_workers.make_model(spec, group.device)
    trainer = Trainer(model, create_optimizer(**spec["optimizer"]),
                      loss_fn=dp_workers.make_loss(spec, model),
                      mesh=build_mesh(MeshConfig.from_dict(axes),
                                      device=group.device),
                      device=group.device)
    state = trainer.create_state()
    rows = {k: np.asarray(v)[:2] for k, v in spec["batch"].items()}
    try:
        trainer.train_step(state, rows)
        result = ("accepted", "")
    except NotImplementedError as e:
        result = (type(e).__name__, str(e))
    return {"state_step": state.step, "step": result}
