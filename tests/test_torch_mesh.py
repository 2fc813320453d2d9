"""The port's mesh and logical-axis rules (dlrover_tpu_torch/parallel/
mesh.py, sharding.py) against the JAX package's (dlrover_tpu/parallel/):
MeshConfig.axis_sizes over a list of shapes and device counts, the
cases of tests/test_models.py's TestMesh, spec_for_logical_axes over a
hypothesis sweep of logical-axis tuples and rule tables, the DTensor
placements of logical_to_mesh_sharding, the mesh axes each leaf of the
tiny Llama is split over by the rules, the fabric tiers, the env knobs
the bootstrap and the mesh read, optim.create_sharded_sync_optimizer,
and the mesh itself at world 1 with its refusals (the slice and hybrid
meshes, no card).  Everything is exact: no tolerance."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from dlrover_tpu.common import envs as jenvs  # noqa: E402
from dlrover_tpu.models.llama import LlamaConfig as JaxLlamaConfig  # noqa: E402
from dlrover_tpu.models.llama import LlamaForCausalLM as JaxLlama  # noqa: E402
from dlrover_tpu.parallel import collectives as jcollectives  # noqa: E402
from dlrover_tpu.parallel import mesh as jmesh  # noqa: E402
from dlrover_tpu.parallel import sharding as jsharding  # noqa: E402
from dlrover_tpu.trainer import optim as joptim  # noqa: E402
from dlrover_tpu_torch.common import envs  # noqa: E402
from dlrover_tpu_torch.models.llama import (  # noqa: E402
    LlamaConfig,
    LlamaForCausalLM,
)
from dlrover_tpu_torch.parallel import collectives, mesh, sharding  # noqa: E402
from dlrover_tpu_torch.trainer import optim  # noqa: E402

SHAPES = [
    dict(dp=-1, fsdp=2, tp=2), dict(dp=3, fsdp=1, tp=1), dict(dp=-1),
    dict(dp=2, fsdp=2, tp=2), dict(dp=1, tp=2), dict(dp=-1, tp=4),
    dict(dp=-1, fsdp=-1), dict(dp=4, fsdp=2), dict(dp=-1, cp=2, ep=2),
    dict(dp=2, fsdp=-1, pp=2), dict(dp=-1, fsdp=3), dict(dp=0),
]


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("n", [1, 2, 4, 8, 12])
@pytest.mark.parametrize("axes", SHAPES, ids=str)
def test_axis_sizes_match_the_reference(axes, n):
    got = _outcome(lambda: mesh.MeshConfig(**axes).axis_sizes(n))
    want = _outcome(lambda: jmesh.MeshConfig(**axes).axis_sizes(n))
    assert got == want


def test_the_reference_mesh_cases():
    """tests/test_models.py TestMesh, on the port."""
    assert mesh.MeshConfig(dp=-1, fsdp=2, tp=2).axis_sizes(8) == (
        2, 2, 2, 1, 1, 1)
    with pytest.raises(ValueError):
        mesh.MeshConfig(dp=3, fsdp=1, tp=1).axis_sizes(8)
    # "embed"->fsdp is dropped (fsdp already used by batch), then trimmed
    assert sharding.spec_for_logical_axes(("batch", "seq", "embed")) == (
        ("dp", "fsdp"), "cp")
    # an already-used mesh axis drops the whole later mapping
    assert sharding.spec_for_logical_axes(("embed", "batch")) == ("fsdp",)


def test_tables_match_the_reference():
    assert mesh.MESH_AXIS_NAMES == jmesh.MESH_AXIS_NAMES
    assert mesh.FABRIC_TIERS == jmesh.FABRIC_TIERS
    assert sharding.DEFAULT_LOGICAL_RULES == jsharding.DEFAULT_LOGICAL_RULES
    for axis in ("dp", "tp", "slice", ("dp", "fsdp"), ("slice", "dp"),
                 ("tp", "cp")):
        assert mesh.axis_fabric(axis) == jmesh.axis_fabric(axis)
    assert mesh.SliceTopology(3, 4).world == jmesh.SliceTopology(3, 4).world
    assert mesh.MeshConfig.from_dict(
        dict(dp=2, tp=4, other=1, devices_per_slice=8)) == mesh.MeshConfig(
        dp=2, tp=4, devices_per_slice=8)


LOGICAL = [name for name, _ in jsharding.DEFAULT_LOGICAL_RULES] + [
    "unknown", None]
MESH_AXES = st.sampled_from([None, "dp", "fsdp", "tp", "cp", "ep", "pp",
                             ("dp", "fsdp"), ("tp", "cp"), ("fsdp", "tp")])


@settings(max_examples=300, deadline=None, derandomize=True)
@given(axes=st.lists(st.sampled_from(LOGICAL), max_size=5),
       rules=st.one_of(st.none(), st.lists(
           st.tuples(st.sampled_from(LOGICAL[:-2]), MESH_AXES),
           min_size=1, max_size=8)))
def test_spec_for_logical_axes_matches_the_reference(axes, rules):
    got = sharding.spec_for_logical_axes(axes, rules)
    want = jsharding.spec_for_logical_axes(axes, rules)
    assert got == tuple(want)


@settings(max_examples=100, deadline=None, derandomize=True)
@given(axes=st.lists(st.sampled_from(LOGICAL), max_size=4))
def test_placements_shard_the_spec_dims(axes):
    spec = sharding.spec_for_logical_axes(axes)
    placements = sharding.logical_to_mesh_sharding(
        tuple(axes), mesh.MESH_AXIS_NAMES)
    assert len(placements) == len(mesh.MESH_AXIS_NAMES)
    for axis, place in zip(mesh.MESH_AXIS_NAMES, placements):
        dims = [d for d, e in enumerate(spec)
                if axis in (e if isinstance(e, tuple) else (e,))]
        assert place == (Shard(dims[0]) if dims else Replicate())


def _jax_param_axes():
    """``{leaf key: set of mesh axes}`` of the JAX tiny Llama's params by
    the default rules (the stacked layer axis maps to None)."""
    cfg = JaxLlamaConfig.tiny(dtype=jnp.float32)
    abstract = jax.eval_shape(
        lambda: JaxLlama(cfg).init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 8), jnp.int32)))
    specs = nn.get_partition_spec(abstract)["params"]
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))[0]:
        names = [str(getattr(k, "key", k)) for k in path]
        logical = tuple(spec)
        mapped = jsharding.spec_for_logical_axes(logical)
        axes = {a for e in mapped for a in
                (e if isinstance(e, tuple) else (e,)) if a is not None}
        out[_leaf_key(names)] = axes
    return out


def _leaf_key(parts) -> str:
    parts = [p for p in parts if p not in ("layers", "layer")
             and not p.isdigit()]
    if parts[-1] in ("kernel", "weight"):
        parts = parts[:-1]
    return ".".join(parts)


def test_every_llama_leaf_maps_to_the_reference_mesh_axes():
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    names = [n for n, _ in model.named_parameters()]
    logical = sharding.param_logical_axes(names)
    assert set(logical) == set(names)
    want = _jax_param_axes()
    for n in names:
        spec = sharding.spec_for_logical_axes(logical[n])
        assert set(sharding.spec_axes(spec)) == want[_leaf_key(
            n.split("."))], n
    # the model's Megatron dims are where the rules put tp
    for n, dim in model.tp_dims().items():
        spec = sharding.spec_for_logical_axes(logical[n])
        assert sharding.spec_axes(spec)["tp"] == dim, n
    with pytest.raises(KeyError):
        sharding.param_logical_axes(["not.a.param"])


def test_env_knobs_match_the_reference():
    for name in ("DLROVER_TPU_NODE_RANK", "DLROVER_TPU_NODE_NUM",
                 "DLROVER_TPU_COORDINATOR_ADDR", "DLROVER_TPU_PLATFORM",
                 "DLROVER_TPU_LOCAL_RANK", "DLROVER_TPU_RESTART_COUNT",
                 "DLROVER_TPU_RDZV_ROUND", "DLROVER_TPU_SLICE_COUNT",
                 "DLROVER_TPU_PROCESS_ID", "DLROVER_TPU_NUM_PROCESSES"):
        assert envs.DEFAULTS[name] == jenvs.knob(name).default, name


@pytest.fixture
def world_of_one():
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_world_of_one_builds_a_mesh_of_ones(world_of_one):
    m = mesh.build_mesh(mesh.MeshConfig(), device="cpu")
    assert m.mesh_dim_names == mesh.MESH_AXIS_NAMES
    assert mesh.mesh_shape(m) == dict.fromkeys(mesh.MESH_AXIS_NAMES, 1)
    assert mesh.mesh_from_axes({"dp": 1}, device="cpu").mesh_dim_names == \
        mesh.MESH_AXIS_NAMES
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    assert mesh.axis_group(m, "tp").world == 1
    rows = sharding.shard_batch(m, {"x": np.arange(6)})
    np.testing.assert_array_equal(rows["x"], np.arange(6))
    with pytest.raises(ValueError):
        mesh.build_mesh(mesh.MeshConfig(dp=2), device="cpu")


def test_slice_and_hybrid_meshes_raise(world_of_one, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_SLICE_COUNT", "2")
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        mesh.build_mesh(device="cpu")
    monkeypatch.delenv("DLROVER_TPU_SLICE_COUNT")
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        mesh.build_mesh(mesh.MeshConfig(devices_per_slice=4), device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="has a card")
def test_mesh_on_the_card_without_one_raises(world_of_one):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.build_mesh()
    assert not dist.is_initialized()


SYNC_OPTIMIZERS = [
    ("exact", {}), ("exact", dict(grad_clip_norm=0.5)),
    ("exact_sharded", {}), ("exact_sharded", dict(grad_clip_norm=None)),
    ("int8_sharded", dict(grad_clip_norm=2.0)), ("int8", {}),
    (dict(mode="int8_sharded", clip_norm=1.0), {}),
    (dict(mode="int8_sharded", clip_norm=1.0), dict(grad_clip_norm=1.0)),
    (dict(mode="int8_sharded", clip_norm=1.0), dict(grad_clip_norm=3.0)),
]


@pytest.mark.parametrize("grad_sync,kwargs", SYNC_OPTIMIZERS, ids=str)
def test_create_sharded_sync_optimizer_matches_the_reference(grad_sync,
                                                            kwargs):
    """The policy it returns and whether the chain holds a clip stage (one
    more state in the chain) are the reference's; a conflicting bound
    raises in both."""
    def parse(mod, spec):
        return (mod.GradSyncPolicy(**spec) if isinstance(spec, dict)
                else spec)

    def outcome(make, mod, params):
        try:
            opt, policy = make(parse(mod, grad_sync), **dict(kwargs))
        except ValueError as e:
            return "ValueError", str(e)
        return len(opt.init(params)), (policy.mode, policy.clip_norm)

    got = outcome(optim.create_sharded_sync_optimizer, collectives,
                  {"w": torch.ones(4)})
    want = outcome(joptim.create_sharded_sync_optimizer, jcollectives,
                   {"w": jnp.ones(4)})
    assert got == want
