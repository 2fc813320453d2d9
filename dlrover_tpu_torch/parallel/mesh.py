"""The named device mesh.

Port of ``dlrover_tpu/parallel/mesh.py``: one
``torch.distributed.device_mesh.DeviceMesh`` over every rank, with the
reference's named axes

    dp    — data parallel (params replicated)
    fsdp  — fully-sharded data parallel (params sharded, ZeRO-3 style)
    tp    — tensor parallel (Megatron-style within attention and the MLP)
    cp    — context parallel (ring attention over sequence chunks)
    ep    — expert parallel (the MoE's experts)
    pp    — pipeline parallel (``models/pipeline_llama.PipelinedLlama``,
            function-style; the ``Trainer`` does not pipeline)

One rank is one process and one device, so the mesh is a grid of ranks
(row-major over ``MESH_AXIS_NAMES``): rank ``r`` sits at the coordinates
of ``r`` in that grid, and each axis has a process group per line of the
grid (``axis_group``); ``axes_group`` flattens several axes into one group.
``mesh_shape`` reads a mesh's shape as a dict, as
the JAX ``Mesh.shape`` does.

The two-level slice mesh (``DLROVER_TPU_SLICE_COUNT > 1``) and the hybrid
DCN mesh (``devices_per_slice``) are not ported yet: both raise
``NotImplementedError`` naming ROADMAP queue 1 item 6.
"""

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.device import DeviceLike, resolve_device
from dlrover_tpu_torch.parallel.process_group import DpGroup

MESH_AXIS_NAMES = ("dp", "fsdp", "tp", "cp", "ep", "pp")

ROADMAP_SLICES = "ROADMAP queue 1 item 6 (multi-slice and elastic compute)"

#: the DCN-domain axis of the two-level layout (the reference's r18)
SLICE_AXIS = "slice"

#: fabric tiers: which interconnect a mesh axis rides.  The slice axis is
#: the slow cross-domain boundary; every in-slice axis is the fast one.
FABRIC_ICI = "ici"
FABRIC_DCN = "dcn"
FABRIC_TIERS: Dict[str, str] = {
    SLICE_AXIS: FABRIC_DCN,
    **{a: FABRIC_ICI for a in MESH_AXIS_NAMES},
}


def axis_fabric(axis: Union[str, Tuple[str, ...]]) -> str:
    """Fabric tier of a collective axis.  A tuple axis (a collective over
    several mesh axes at once) is priced at its slowest member."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    for name in names:
        if FABRIC_TIERS.get(name, FABRIC_ICI) == FABRIC_DCN:
            return FABRIC_DCN
    return FABRIC_ICI


@dataclasses.dataclass(frozen=True)
class SliceTopology:
    """The two-level shape of a slice mesh: ``num_slices`` DCN domains of
    ``ici_dp`` data-parallel replicas each."""

    num_slices: int
    ici_dp: int

    @property
    def world(self) -> int:
        return self.num_slices * self.ici_dp


@dataclasses.dataclass
class MeshConfig:
    """Requested mesh shape; -1 axes are inferred from the device count.

    At most one axis may be -1.  Axes default to 1 (inactive).
    """

    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    cp: int = 1
    ep: int = 1
    pp: int = 1
    # hint: devices per slice (ICI domain); used for hybrid DCN meshes
    devices_per_slice: int = 0

    def axis_sizes(self, num_devices: int) -> Tuple[int, ...]:
        sizes = [self.dp, self.fsdp, self.tp, self.cp, self.ep, self.pp]
        unknown = [i for i, s in enumerate(sizes) if s == -1]
        if len(unknown) > 1:
            raise ValueError("at most one mesh axis may be -1 (inferred)")
        known = math.prod(s for s in sizes if s != -1)
        if unknown:
            if num_devices % known != 0:
                raise ValueError(
                    f"{num_devices} devices not divisible by fixed axes {known}"
                )
            sizes[unknown[0]] = num_devices // known
        if math.prod(sizes) != num_devices:
            raise ValueError(
                f"mesh {sizes} needs {math.prod(sizes)} devices, "
                f"have {num_devices}"
            )
        return tuple(sizes)

    @classmethod
    def from_dict(cls, axes: Dict[str, int]) -> "MeshConfig":
        return cls(**{k: v for k, v in axes.items() if k in
                      (*MESH_AXIS_NAMES, "devices_per_slice")})


def slice_count_from_env() -> int:
    """``DLROVER_TPU_SLICE_COUNT`` (0/1 = flat single-slice mesh)."""
    return envs.get_int("DLROVER_TPU_SLICE_COUNT")


def _one_rank_group(device_type: str) -> None:
    """A world of one process that nothing initialised gets a one-rank
    group over an in-process store (the bootstrap initialises nothing at
    world 1, as the reference does; a ``DeviceMesh`` needs a group)."""
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def build_mesh(config: Optional[MeshConfig] = None,
               device: DeviceLike = None) -> DeviceMesh:
    """The named mesh over every rank of ``torch.distributed``'s world,
    on the card (each rank on its ``torch.cuda.current_device()``, which
    ``bootstrap.init`` sets) unless the caller passes ``device="cpu"``."""
    config = config or MeshConfig()
    num_slices = slice_count_from_env()
    if num_slices > 1:
        raise NotImplementedError(
            f"DLROVER_TPU_SLICE_COUNT={num_slices}: the two-level slice "
            f"mesh is not ported yet ({ROADMAP_SLICES})")
    if config.devices_per_slice:
        raise NotImplementedError(
            f"devices_per_slice={config.devices_per_slice}: the hybrid DCN "
            f"mesh is not ported yet ({ROADMAP_SLICES})")
    device_type = resolve_device(device).type
    if not dist.is_initialized():
        _one_rank_group(device_type)
    sizes = config.axis_sizes(dist.get_world_size())
    return init_device_mesh(device_type, sizes,
                            mesh_dim_names=MESH_AXIS_NAMES)


def mesh_from_axes(axes: Dict[str, int], device: DeviceLike = None):
    return build_mesh(MeshConfig.from_dict(axes), device)


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """``{axis name: size}``, as the JAX ``Mesh.shape`` reads."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _rank_device(mesh: DeviceMesh):
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return mesh.device_type


def axis_group(mesh: DeviceMesh, axis: str) -> DpGroup:
    """This rank's group along ``axis`` (the ranks that differ from it in
    that coordinate only), with the port's collectives (``DpGroup``)."""
    return DpGroup(_rank_device(mesh), group=mesh.get_group(axis))


def axes_group(mesh: DeviceMesh, axes: Sequence[str]) -> DpGroup:
    """This rank's group along several axes at once (the ranks that
    differ from it in those coordinates only), as one flattened axis;
    collective: every rank calls it."""
    if len(axes) == 1:
        return axis_group(mesh, axes[0])
    flat = mesh[tuple(axes)]._flatten("_".join(axes))
    return DpGroup(_rank_device(mesh), group=flat.get_group())

