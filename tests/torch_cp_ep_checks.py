"""Rank functions for the ring attention tests (not a test module:
pytest does not collect it).  ``process_group.spawn`` runs it in gloo
ranks on the CPU; this module imports torch and the port only, so a
spawned rank that unpickles the function never imports JAX."""

from typing import Dict, List

import torch
import torch.distributed as dist

from dlrover_tpu_torch.ops.ring_attention import (
    ring_attention,
    ring_attention_sharded,
    ring_flash_attention,
    ring_flash_forward,
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


class _Reversed:
    """A cp group whose ring turns the other way: ``shift(d)`` is the
    group's ``shift(-d)``."""

    def __init__(self, group: DpGroup):
        self.group, self.world, self.rank = group, group.world, group.rank

    def shift(self, tensors, d):
        return self.group.shift(tensors, -d)


def ring_flash_worker(group: DpGroup, cases: List[Dict]) -> List[Dict]:
    """Each case: the global ``q``, ``k``, ``v`` and ``dout`` ([B, S, H,
    D] numpy), ``causal``, ``cp`` consecutive ranks, ``dtype`` and
    optionally ``reverse`` (the ring turned the other way).  Returns per
    case this rank's chunk index and its chunks (fp32 numpy) of
    ``ring_flash_attention``'s output, of its merged LSE
    ([B*H, S_local]) and of the gradients of sum(out * dout) w.r.t. q, k
    and v."""
    cps = _subgroups(group, [c["cp"] for c in cases])
    results = []
    for case in cases:
        cp = cps[case["cp"]]
        ring = _Reversed(cp) if case.get("reverse") else cp
        dtype = getattr(torch, case["dtype"])

        def chunk(a, grad=True):
            t = torch.from_numpy(a).chunk(cp.world, dim=1)[cp.rank]
            t = t.to(dtype).clone()
            return t.requires_grad_() if grad else t

        q, k, v = chunk(case["q"]), chunk(case["k"]), chunk(case["v"])
        out = ring_flash_attention(q, k, v, ring, causal=case["causal"])
        _, lse = ring_flash_forward(q.detach(), k.detach(), v.detach(),
                                    ring, causal=case["causal"])
        (out.float() * chunk(case["dout"], grad=False).float()).sum() \
            .backward()
        results.append(dict(
            chunk=cp.rank, lse=lse.numpy(),
            **{name: t.detach().float().numpy() for name, t in (
                ("out", out), ("dq", q.grad), ("dk", k.grad),
                ("dv", v.grad))}))
    return results


def moe_cp_worker(group: DpGroup, spec: Dict) -> List[Dict]:
    """``MoEMLP`` (``spec["config"]`` fields over ``tiny_moe``, fp32,
    loaded with ``spec["state_dict"]``) over ``cp`` consecutive ranks for
    each cp of ``spec["cps"]``, on this rank's chunk of ``spec["x"]``
    ([B, S, D] numpy).  Returns per cp this rank's chunk index, its
    ``keep`` ([B, S_local, k, E]) and slots (``MoEMLP.slots`` of its
    routing's one-hot choices), its output, the aux loss, and the
    gradients of sum(out * dout) w.r.t. its x chunk and the weights."""
    import torch.nn.functional as F

    from dlrover_tpu_torch.models.moe import (
        MoELlamaConfig,
        MoEMLP,
        expert_capacity,
        top_k_lower_index,
    )

    cfg = MoELlamaConfig.tiny_moe(dtype=torch.float32, **spec["config"])
    cps = _subgroups(group, spec["cps"])
    results = []
    for cp_size in spec["cps"]:
        cp = cps[cp_size]
        mlp = MoEMLP(cfg, device="cpu")
        mlp.load_state_dict({k: torch.from_numpy(v)
                             for k, v in spec["state_dict"].items()})
        mlp.cp = cp

        def chunk(a):
            return torch.from_numpy(a).chunk(cp.world, dim=1)[cp.rank] \
                .clone()

        x = chunk(spec["x"]).requires_grad_()
        out = mlp(x)
        (out * chunk(spec["dout"])).sum().backward()
        with torch.no_grad():
            probs = torch.softmax(F.linear(x, mlp.router.weight), dim=-1)
            _, top_idx = top_k_lower_index(probs, cfg.top_k)
            mask = F.one_hot(top_idx, cfg.num_experts).float()
            pos = mlp.slots(mask)
        C = expert_capacity(x.shape[1] * cp.world, cfg.num_experts,
                            cfg.top_k, cfg.capacity_factor)
        keep = mask * (pos >= 0) * (pos < C)
        results.append(dict(
            chunk=cp.rank, keep=keep.numpy(), pos=pos.numpy(),
            out=out.detach().numpy(), aux=mlp.aux_loss.item(),
            dx=x.grad.numpy(), grads={n: p.grad.numpy() for n, p in
                                      mlp.named_parameters()}))
    return results
