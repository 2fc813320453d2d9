"""A rank function for the telemetry tests (not a test module: pytest does
not collect it).  ``process_group.spawn`` runs it in gloo ranks on the CPU;
this module imports torch and the port only, so a spawned rank that
unpickles the function never imports JAX."""

from typing import Any, Dict

from dlrover_tpu_torch.observability import flight_recorder, memscope
from dlrover_tpu_torch.parallel import dp_workers
from dlrover_tpu_torch.parallel.process_group import DpGroup


def telemetry_worker(group: DpGroup, spec: Dict[str, Any]) -> Dict[str, Any]:
    """Each run of ``spec["runs"]`` from the same weights, with its
    ``"env"`` set while its trainer is made and steps: ``spec["steps"]``
    steps (none for a run with ``"steps": 0``).

    Returns, per run: the losses; the memory scope's plan of the state
    (``plan_from_state`` over ``Trainer.mesh_axes`` and
    ``Trainer.state_axes``) priced per chip as laid out and at dp=1; the
    host seconds of the trainer's hooks; and, when the run wrote a digest,
    this rank's digest file and the ``comm.bucket<i>`` spans' attributes
    from the flight recorder (``dp_workers.telemetry_record``)."""
    out = {}
    for run in spec["runs"]:
        with dp_workers.env(run.get("env", {})):
            trainer, batch = dp_workers.build_trainer(group, spec, run)
            state = trainer.create_state()
            plan = memscope.plan_from_state(state, trainer.mesh_axes(),
                                            trainer.state_axes(state))
            flight_recorder.recorder().reset()
            losses = []
            for _ in range(run.get("steps", spec.get("steps", 0))):
                state, metrics = trainer.train_step(state, batch)
                losses.append(metrics["loss"].item())
            rec = {"loss": losses, "per_chip": plan.per_chip(),
                   "per_chip_dp1": plan.per_chip({"dp": 1}),
                   "telemetry_s": trainer.telemetry_s, "buckets": []}
            dp_workers.telemetry_record(rec)
            rec["buckets"] = rec.pop("comm_buckets", [])
            trainer.close()
        out[run["name"]] = rec
    return out
