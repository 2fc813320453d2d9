"""Logical-axis sharding rules.

Port of ``dlrover_tpu/parallel/sharding.py``.  Parameters and activations
carry *logical* axis names ("embed", "heads", "batch"...); one table maps
logical names to mesh axes.  In JAX, GSPMD inserts the collectives from
those annotations; here the table decides where each tensor is split:

* ``spec_for_logical_axes`` maps a tuple of logical axes to the port's
  spec, one mesh-axis entry per tensor dim (a name, a tuple of names or
  None), with the reference's rule: a mesh axis appears once (a later
  repeat is dropped) and trailing Nones are trimmed;
* ``logical_to_mesh_sharding`` turns logical axes into DTensor placements
  on the mesh, one per mesh axis: ``Shard(dim)`` on the axes that split
  the tensor, ``Replicate()`` on the others;
* ``param_logical_axes`` is the table of every parameter of the port's
  Llama (``models/llama.py``), MoE Llama (``models/moe.py``), GPT
  (``models/gpt.py``) and ViT (``models/vit.py``) to its logical axes, in
  the port's layout (``[*out, in]`` linear weights, the experts' ``[E, in,
  out]``), taken from the reference models' ``with_logical_partitioning``
  calls.  GPT's and ViT's LayerNorm scales and biases and their Dense
  biases carry no annotation in the reference, so their axes are empty:
  replicated over every mesh axis.  The port's params are plain tensors,
  so there is nothing to unbox (the reference's ``unbox_params``);
* ``shard_batch`` takes this rank's own rows, as the reference's takes
  each process's local data (``make_array_from_process_local_data``), and
  cuts only, where the rules split the sequence (``cp``), its chunk of
  their sequence: ranks that differ only in cp, tp or ep pass the same
  rows.  ``rows_of_global_batch`` is what a caller that holds the whole
  global batch feeds it: this rank's block of rows over the data axes.
"""

import re
from typing import Dict, List, Optional, Sequence, Tuple, Union

from torch.distributed.tensor import Replicate, Shard

MeshAxis = Union[str, Tuple[str, ...], None]
Spec = Tuple[MeshAxis, ...]

# logical axis -> mesh axis (or tuple of axes, or None = replicated)
DEFAULT_LOGICAL_RULES: List[Tuple[str, MeshAxis]] = [
    ("batch", ("dp", "fsdp")),  # global batch over all data-ish axes
    ("seq", "cp"),              # context parallelism over sequence
    ("vocab", "tp"),
    ("embed", "fsdp"),          # ZeRO-3-style param shard over fsdp
    ("heads", "tp"),
    ("kv_heads", "tp"),
    ("head_dim", None),
    ("mlp", "tp"),
    ("expert", "ep"),
    ("capacity", None),         # per-expert token buffer (MoE dispatch)
    ("layers", None),           # scanned-layer leading axis stays replicated
]


def rules_to_dict(
    rules: Sequence[Tuple[str, MeshAxis]]
) -> Dict[str, MeshAxis]:
    return dict(rules)


def spec_for_logical_axes(
    logical_axes: Sequence[Optional[str]],
    rules: Optional[Sequence[Tuple[str, MeshAxis]]] = None,
) -> Spec:
    """Map a tuple of logical axis names to the mesh axes of each dim."""
    table = rules_to_dict(rules or DEFAULT_LOGICAL_RULES)
    out = []
    used = set()
    for name in logical_axes:
        axis = table.get(name) if name else None
        # a mesh axis may appear only once in a spec; drop repeats
        if axis is not None:
            flat = axis if isinstance(axis, tuple) else (axis,)
            if any(a in used for a in flat):
                axis = None
            else:
                used.update(flat)
        out.append(axis)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def spec_axes(spec: Spec) -> Dict[str, int]:
    """``{mesh axis: tensor dim}`` of a spec."""
    where = {}
    for dim, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                where[axis] = dim
    return where


def logical_to_mesh_sharding(
    logical_axes: Sequence[Optional[str]],
    mesh_axis_names: Sequence[str],
    rules: Optional[Sequence[Tuple[str, MeshAxis]]] = None,
):
    """DTensor placements on a mesh with axes ``mesh_axis_names`` (a
    ``DeviceMesh``'s ``mesh_dim_names``) for a tuple of logical axes."""
    where = spec_axes(spec_for_logical_axes(logical_axes, rules))
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh_axis_names)


# the port's Llama and MoE Llama, parameter name -> logical axes of its
# weight (the reference's dense kernels are [in, *out]: q_proj ("embed",
# "heads", "head_dim") is the port's [out, in] [heads * head_dim, embed],
# and the router's ("embed", "expert") its [E, D]; the experts keep the
# reference's [E, in, out])
_LLAMA_AXES = (
    (r"embed_tokens", ("vocab", "embed")),
    (r"layers\.\d+\.attn\.q_proj\.weight", ("heads", "embed")),
    (r"layers\.\d+\.attn\.[kv]_proj\.weight", ("kv_heads", "embed")),
    (r"layers\.\d+\.attn\.o_proj\.weight", ("embed", "heads")),
    (r"layers\.\d+\.mlp\.(gate|up)_proj\.weight", ("mlp", "embed")),
    (r"layers\.\d+\.mlp\.down_proj\.weight", ("embed", "mlp")),
    (r"layers\.\d+\.moe_mlp\.router\.weight", ("expert", "embed")),
    (r"layers\.\d+\.moe_mlp\.(gate|up)_proj", ("expert", "embed", "mlp")),
    (r"layers\.\d+\.moe_mlp\.down_proj", ("expert", "mlp", "embed")),
    (r"layers\.\d+\.(input_norm|post_attn_norm)\.scale", ("embed",)),
    (r"final_norm\.scale", ("embed",)),
    (r"lm_head\.weight", ("vocab", "embed")),
)

# the port's GPT and ViT (the reference's attn_qkv ("embed", None, "heads",
# "head_dim") is the port's [3, heads * head_dim, embed]; the patch conv's
# (None, None, None, "embed") the patch rows' [D, P*P*C])
_GPT_VIT_AXES = (
    (r"wte", ("vocab", "embed")),
    (r"wpe", (None, "embed")),
    (r"layers\.\d+\.attn_qkv\.weight", (None, "heads", "embed")),
    (r"layers\.\d+\.attn_proj\.weight", ("embed", "heads")),
    (r"layers\.\d+\.(mlp_fc|mlp_in)\.weight", ("mlp", "embed")),
    (r"layers\.\d+\.(mlp_proj|mlp_out)\.weight", ("embed", "mlp")),
    (r"patch_embed\.weight", ("embed", None)),
    (r"cls_token|pos_embed", (None, None, "embed")),
    (r"head\.weight", ("vocab", "embed")),
    # no annotation in the reference: replicated
    (r"layers\.\d+\.(attn_qkv|attn_proj|mlp_fc|mlp_proj|mlp_in|mlp_out)"
     r"\.bias", ()),
    (r"(layers\.\d+\.ln_[12]|ln_f)\.(scale|bias)", ()),
    (r"(patch_embed|head)\.bias", ()),
)


def param_logical_axes(names) -> Dict[str, Tuple[str, ...]]:
    """Logical axes of each named parameter of the port's Llama, MoE
    Llama, GPT or ViT; raises for a name the table does not know."""
    out = {}
    for name in names:
        for pattern, axes in _LLAMA_AXES + _GPT_VIT_AXES:
            if re.fullmatch(pattern, name):
                out[name] = axes
                break
        else:
            raise KeyError(f"no logical axes for parameter {name!r}")
    return out


def _data_index(mesh, data_axes: Sequence[str] = ("dp", "fsdp")
               ) -> Tuple[int, int]:
    """(this rank's block, the number of blocks) of the batch split over
    ``data_axes``, row-major as JAX's ``PartitionSpec(data_axes)``."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for axis in data_axes:
        size = mesh.shape[names.index(axis)]
        index = index * size + coord[names.index(axis)]
        count *= size
    return index, count


def rows_of_global_batch(mesh, batch,
                         data_axes: Tuple[str, ...] = ("dp", "fsdp")):
    """This rank's rows of the global ``batch`` (a dict of arrays or
    tensors, [B, ...] with the batch leading): the batch split into as many
    equal blocks of rows as the data axes hold ranks, block ``index`` for
    this rank.  Ranks that differ only in other axes (tp, cp, ep) get the
    same block.  Hand the result to ``shard_batch``."""
    index, count = _data_index(mesh, data_axes)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % count:
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not "
                             f"split over {count} data ranks")
        n = v.shape[0] // count
        out[k] = v[index * n:(index + 1) * n]
    return out


def shard_batch(mesh, batch):
    """What this rank computes on of its own rows ``batch`` (a dict of
    arrays or tensors, [B, S, ...] with the batch leading): the rows as
    they are, as the reference's ``shard_batch`` takes each process's local
    data, and, over the axis the rules give ``seq`` (cp), their sequence
    split into contiguous chunks, chunk ``r`` for cp rank ``r`` (the
    ring's order).  The ranks that differ only in cp, tp or ep pass the
    same rows (``rows_of_global_batch`` cuts them from a global batch)."""
    seq_axis = rules_to_dict(DEFAULT_LOGICAL_RULES)["seq"]
    chunk, chunks = _data_index(mesh, (seq_axis,))
    if chunks == 1:
        return dict(batch)
    out = {}
    for k, v in batch.items():
        if v.ndim < 2 or v.shape[1] % chunks:
            raise ValueError(f"batch {k!r} of shape {tuple(v.shape)} "
                             f"does not split its sequence over "
                             f"{chunks} {seq_axis} ranks")
        s = v.shape[1] // chunks
        out[k] = v[:, chunk * s:(chunk + 1) * s]
    return out
