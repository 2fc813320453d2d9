"""A rank function for the ring attention tests (not a test module:
pytest does not collect it).  ``process_group.spawn`` runs it in gloo
ranks on the CPU; this module imports torch and the port only, so a
spawned rank that unpickles the function never imports JAX."""

from typing import Dict, List

import torch
import torch.distributed as dist

from dlrover_tpu_torch.ops.ring_attention import (
    ring_attention,
    ring_attention_sharded,
)
from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu_torch.parallel.process_group import DpGroup


def _subgroups(group: DpGroup, sizes) -> Dict[int, DpGroup]:
    """For each size, this rank's group of that many consecutive ranks
    (every rank creates every group, in the same order)."""
    out = {}
    for size in sorted(set(sizes)):
        for start in range(0, group.world, size):
            ranks = list(range(start, start + size))
            pg = dist.new_group(ranks)
            if group.rank in ranks:
                out[size] = DpGroup(group.device, group=pg)
    return out


def ring_worker(group: DpGroup, cases: List[Dict]) -> List[Dict]:
    """Each case: the global ``q``, ``k``, ``v`` and ``dout`` ([B, S, H,
    D] numpy) and ``causal``, over either ``cp`` consecutive ranks
    (``ring_attention``) or the mesh of ``axes`` (``ring_attention_sharded``
    on this rank's block: its rows over dp, its chunk over cp).  Returns
    per case this rank's block coordinates and its blocks of the output
    and of the gradients of sum(out * dout) w.r.t. q, k and v."""
    cps = _subgroups(group, [c["cp"] for c in cases if "cp" in c])
    meshes = {}
    results = []
    for case in cases:
        if "cp" in case:
            cp, mesh = cps[case["cp"]], None
            (row, rows), (chunk, chunks) = (0, 1), (cp.rank, cp.world)
        else:
            key = tuple(sorted(case["axes"].items()))
            if key not in meshes:
                meshes[key] = build_mesh(MeshConfig.from_dict(case["axes"]),
                                         device="cpu")
            mesh = meshes[key]
            names, coord = list(mesh.mesh_dim_names), mesh.get_coordinate()
            dp, seq = names.index("dp"), names.index("cp")
            row, rows = coord[dp], mesh.shape[dp]
            chunk, chunks = coord[seq], mesh.shape[seq]

        def block(a, grad=True):
            t = torch.from_numpy(a).chunk(rows, dim=0)[row]
            t = t.chunk(chunks, dim=1)[chunk].clone()
            return t.requires_grad_() if grad else t

        q, k, v = block(case["q"]), block(case["k"]), block(case["v"])
        if mesh is None:
            out = ring_attention(q, k, v, cp, causal=case["causal"])
        else:
            out = ring_attention_sharded(mesh, q, k, v,
                                         causal=case["causal"])
        (out * block(case["dout"], grad=False)).sum().backward()
        results.append(dict(row=row, chunk=chunk, out=out.detach().numpy(),
                            dq=q.grad.numpy(), dk=k.grad.numpy(),
                            dv=v.grad.numpy()))
    return results
