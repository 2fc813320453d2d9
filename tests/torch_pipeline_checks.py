"""A rank function for the pipeline tests (not a test module: pytest does
not collect it).  ``process_group.spawn`` runs it in gloo ranks on the
CPU; this module imports torch and the port only, so a spawned rank that
unpickles the function never imports JAX."""

from typing import Dict

import torch

from dlrover_tpu_torch.parallel import sharding
from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu_torch.parallel.pipeline import pipeline_apply, stage_params
from dlrover_tpu_torch.parallel.process_group import DpGroup


def chain_worker(group: DpGroup, spec: Dict) -> Dict:
    """The tanh chain of tests/test_pipeline.py's
    ``test_generic_pipeline_matches_sequential``: ``spec["w"]`` ([L, n,
    n]) split into ``pp`` stages of ``tanh(h @ w_i)``, this rank's rows of
    ``spec["x"]`` over dp, ``spec["num_microbatches"]``; then the
    backward of sum(y * dy).  Returns this rank's dp rows (as a slice),
    its y, and its gradients of w and x (zero where another rank owns
    them)."""
    mesh = build_mesh(MeshConfig.from_dict(spec["axes"]), device="cpu")
    pp = dict(zip(mesh.mesh_dim_names, mesh.shape))["pp"]
    w = torch.from_numpy(spec["w"]).requires_grad_()
    rows = sharding.rows_of_global_batch(
        mesh, {"x": torch.from_numpy(spec["x"]),
               "dy": torch.from_numpy(spec["dy"])}, ("dp",))
    x = rows["x"].clone().requires_grad_()

    def stage(sp, h):
        for wi in sp:
            h = torch.tanh(h @ wi)
        return h

    piped = pipeline_apply(stage, mesh, spec["num_microbatches"])
    y = piped(stage_params(w, pp), x)
    (y * rows["dy"]).sum().backward()
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    n = x.shape[0]
    return {"dp": coord["dp"], "pp": coord["pp"],
            "rows": (coord["dp"] * n, (coord["dp"] + 1) * n),
            "y": y.detach().numpy(), "dw": w.grad.numpy(),
            "dx": (torch.zeros_like(x) if x.grad is None  # not stage 0
                   else x.grad).numpy(),
            "refusals": _refusals(mesh)}


def _refusals(mesh) -> Dict[str, str]:
    """``PipelinedLlama``'s refusals: 3 layers over 4 stages, and a mesh
    with tp (the pipeline composes with dp only)."""
    from dlrover_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from dlrover_tpu_torch.models.pipeline_llama import PipelinedLlama

    out = {}
    cases = {"3 layers over pp=4": (LlamaConfig.tiny(num_layers=3), mesh),
             "tp=2 x pp=4": (LlamaConfig.tiny(num_layers=4), build_mesh(
                 MeshConfig(dp=1, tp=2, pp=4), device="cpu"))}
    for name, (cfg, on) in cases.items():
        try:
            PipelinedLlama(LlamaForCausalLM(cfg, device="cpu"), on)
            out[name] = "accepted"
        except ValueError as e:
            out[name] = str(e)
    return out
