"""The port's Trainer on meshes with cp and ep (dlrover_tpu_torch/trainer/
train.py with ``mesh=``) against the JAX Trainer on the same mesh: the
tiny Llama (ring attention, the flash kernels and the reference core
over cp) and the tiny MoE Llama with ``moe_loss_fn`` (over ep and cp),
each from the JAX model's init (models/convert.py), the same global
batch (B=16, S=16), 4 steps of create_optimizer (clip 1.0 in the chain,
lr 1e-3 after one warm-up step at 0), in fp32.  The meshes: cp=2 with
ring attention (remat on, so the backward runs the ring's rotations again)
and with the reference core (tests/test_models.py:138's axis), dp=2 x
tp=2 x cp=2 with ring attention (remat off; tests/test_ops.py:156),
ep=2, fsdp=2 x ep=2, and dp=2 x tp=2 x ep=2 (tests/test_moe.py:159); and
with the flash kernels over cp (the ring of flash blocks, their plain
versions here; JAX's flash on the CPU is its reference core) cp=2 with
remat and dp=2 x tp=2 x cp=2, and the MoE over cp: cp=2 with flash
attention, ep=2 x cp=2, and cp=4 at capacity_factor 0.5, where tokens
drop and the cross-rank offsets of the priority scan decide which (the
reference computes the same losses on one device and on these meshes).
The JAX runs take the 8 virtual CPU devices of tests/conftest.py; the
port's ranks run on gloo, one spawn per world size (2, 4 and 8 ranks),
in the background.  Also: every leaf (each param and its two moments) is
split over the mesh axes the rules give it in JAX, and ``shard_batch``
gives each rank its rows and its chunk of the sequence.

Tolerances, as tests/test_torch_train_mesh.py states them for fp32 (the
two trainers differ in summation order only: the ring's and the
reduces' orders, the norm over shards): losses within 1e-6 relative,
grad norms within 2e-5, each leaf's mean param difference within 1e-6
and its largest within DRIFT = 2 * (sum of the lrs), params within
lr / 10 but for at most 4 elements of the model.
"""

import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.models import moe as jmoe  # noqa: E402
from dlrover_tpu.models.llama import LlamaConfig as JaxLlamaConfig  # noqa: E402
from dlrover_tpu.models.llama import LlamaForCausalLM as JaxLlama  # noqa: E402
from dlrover_tpu.parallel.mesh import MeshConfig as JaxMeshConfig  # noqa: E402
from dlrover_tpu.parallel.mesh import build_mesh as jax_build_mesh  # noqa: E402
from dlrover_tpu.trainer import optim as joptim  # noqa: E402
from dlrover_tpu.trainer.train import Trainer as JaxTrainer  # noqa: E402
from dlrover_tpu_torch.models.convert import (  # noqa: E402
    flax_llama_to_state_dict,
    flax_moe_to_state_dict,
)
from dlrover_tpu_torch.models.llama import LlamaConfig  # noqa: E402
from dlrover_tpu_torch.models.moe import MoELlamaConfig  # noqa: E402
from dlrover_tpu_torch.parallel import (  # noqa: E402
    dp_workers,
    mesh_workers,
    process_group,
)
from dlrover_tpu_torch.parallel import sharding  # noqa: E402
from dlrover_tpu_torch.trainer import optim as toptim  # noqa: E402
from torch_mesh_checks import own_rows_worker  # noqa: E402

B, S, STEPS = 16, 16, 4
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=100)
LR = OPT["peak_lr"]
DRIFT = 2 * sum(toptim.cosine_schedule(**OPT)(t) for t in range(STEPS))
SPAWN_TIMEOUT_S = 240.0

# (name, mesh axes, family, config fields (the port's; JAX's without
# remat, which JAX keeps off for the ring as its tests do), ranks)
MESHES = [
    ("cp2_ring", dict(dp=1, cp=2), "llama",
     dict(attention_impl="ring", remat=True), 2),
    ("cp2_reference", dict(dp=1, cp=2), "llama", {}, 2),
    ("ep2", dict(dp=1, ep=2), "moe", {}, 2),
    ("fsdp2_ep2", dict(dp=1, fsdp=2, ep=2), "moe", {}, 4),
    ("dp2_tp2_cp2_ring", dict(dp=2, tp=2, cp=2), "llama",
     dict(attention_impl="ring", remat=False), 8),
    ("dp2_tp2_ep2", dict(dp=2, tp=2, ep=2), "moe", {}, 8),
    ("cp2_flash", dict(dp=1, cp=2), "llama",
     dict(attention_impl="flash", remat=True), 2),
    ("dp2_tp2_cp2_flash", dict(dp=2, tp=2, cp=2), "llama",
     dict(attention_impl="flash", remat=False), 8),
    ("cp2_moe", dict(dp=1, cp=2), "moe", dict(attention_impl="flash"), 2),
    ("ep2_cp2_moe", dict(dp=1, ep=2, cp=2), "moe", {}, 4),
    ("cp4_moe_drop", dict(dp=1, cp=4), "moe", dict(capacity_factor=0.5), 4),
]


def _batch():
    ids = np.random.default_rng(0).integers(0, 256, size=(B, S + 1))
    return {"input_ids": ids[:, :-1].astype(np.int32),
            "labels": ids[:, 1:].astype(np.int32)}


def _jax_model(family, fields):
    fields = {k: v for k, v in fields.items() if k != "remat"}
    if family == "moe":
        return jmoe.MoELlamaForCausalLM(
            jmoe.MoELlamaConfig.tiny_moe(dtype=jnp.float32, **fields))
    remat = {"remat": False} if fields else {}
    return JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, **fields,
                                        **remat))


def _leaf_key(parts) -> str:
    """One name for a JAX leaf path or a port parameter name, the layer
    index dropped: ``attn.q_proj``, ``moe_mlp.router``, ``lm_head``."""
    parts = [p for p in parts if not re.fullmatch(r"layers?(_\d+)?|\d+", p)]
    if parts[-1] in ("kernel", "weight"):
        parts = parts[:-1]
    return ".".join(parts)


def _jax_axes(tree, mesh):
    """``{leaf key: set of active mesh axes in its sharding spec}``."""
    shape = dict(mesh.shape)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [str(getattr(k, "key", getattr(k, "name", k))) for k in path]
        axes = set()
        for entry in leaf.sharding.spec:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None and shape[a] > 1:
                    axes.add(a)
        out[_leaf_key(names)] = axes
    return out


def _run_jax(axes, family, fields, n_devices):
    model = _jax_model(family, fields)
    mesh = jax_build_mesh(JaxMeshConfig(**axes),
                          devices=jax.devices()[:n_devices])
    loss_fn = jmoe.moe_loss_fn(model) if family == "moe" else None
    trainer = JaxTrainer(model, joptim.create_optimizer(**OPT), mesh,
                         loss_fn=loss_fn)
    batch = _batch()
    state = trainer.create_state(jax.random.PRNGKey(0), batch["input_ids"])
    init = jax.tree.map(np.asarray, nn.meta.unbox(state.params))
    params_axes = _jax_axes(nn.meta.unbox(state.params), mesh)
    losses, norms = [], []
    for _ in range(STEPS):
        state, metrics = trainer.train_step(state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    final = jax.tree.map(np.asarray, nn.meta.unbox(state.params))
    return dict(init=init, final=final, loss=np.array(losses),
                grad_norm=np.array(norms), params_axes=params_axes)


def _init(family):
    model = _jax_model(family, {})
    return jax.tree.map(np.asarray, nn.meta.unbox(jax.jit(
        lambda rng: model.init(rng, _batch()["input_ids"]))(
            jax.random.PRNGKey(0))["params"]))


def _port_cfg(family):
    if family == "moe":
        return MoELlamaConfig.tiny_moe(dtype=torch.float32)
    return LlamaConfig.tiny(dtype=torch.float32)


def _convert(family, params):
    convert = (flax_moe_to_state_dict if family == "moe"
               else flax_llama_to_state_dict)
    return convert(params, _port_cfg(family))


@pytest.fixture(scope="module")
def runs():
    """The port's meshes, one spawn of gloo ranks per world size, in the
    background from the JAX models' initial weights, while the JAX
    Trainer runs each mesh here."""
    inits = {f: _init(f) for f in ("llama", "moe")}
    spec = dict(model=dict(dtype=torch.float32), batch=_batch(),
                optimizer=OPT, grads_dtype=None, return_params=True)
    family_spec = {
        "llama": dict(preset="tiny", state_dict={
            k: v.numpy() for k, v in _convert("llama",
                                              inits["llama"]).items()}),
        "moe": dict(family="moe", preset="tiny_moe",
                    state_dict={k: v.numpy() for k, v in _convert(
                        "moe", inits["moe"]).items()}),
    }
    worlds = sorted({m[4] for m in MESHES})
    with ThreadPoolExecutor(len(worlds)) as pool:
        spawns = {
            world: pool.submit(
                process_group.spawn, dp_workers.train_worker, world,
                (dict(spec, runs=[
                    dict(name=name, axes=axes, steps=STEPS, model=fields,
                         spec=family_spec[family])
                    for name, axes, family, fields, n in MESHES
                    if n == world]),),
                device="cpu", timeout_s=SPAWN_TIMEOUT_S)
            for world in worlds}
        jax_runs = {name: _run_jax(axes, family, fields, n)
                    for name, axes, family, fields, n in MESHES}
        ranks = {world: f.result() for world, f in spawns.items()}
    port = {name: [r["runs"][name] for r in ranks[n]]
            for name, _, _, _, n in MESHES}
    return dict(jax=jax_runs, port=port, inits=inits)


@pytest.mark.parametrize("name,family", [(m[0], m[2]) for m in MESHES])
def test_jax_starts_from_the_weights_the_port_loads(runs, name, family):
    for a, b in zip(jax.tree.leaves(runs["inits"][family]),
                    jax.tree.leaves(runs["jax"][name]["init"])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,family", [(m[0], m[2]) for m in MESHES])
def test_matches_the_jax_trainer_on_the_same_mesh(runs, name, family):
    records = runs["port"][name]
    want = runs["jax"][name]
    for rec in records:  # every rank reports the global loss and norm
        np.testing.assert_allclose(rec["loss"], want["loss"], rtol=1e-6)
        np.testing.assert_allclose(rec["grad_norm"], want["grad_norm"],
                                   rtol=2e-5)
    assert records[0]["loss"][-1] < records[0]["loss"][0]
    got = records[0]["params"]
    final = {k: v.numpy() for k, v in _convert(family,
                                                want["final"]).items()}
    assert set(got) == set(final)
    beyond = 0
    for n in got:
        assert got[n].dtype == np.float32  # fp32 masters
        diff = np.abs(got[n] - final[n])
        assert diff.max() <= DRIFT, (n, diff.max())
        assert diff.mean() <= 1e-6, (n, diff.mean())
        beyond += int((diff > LR / 10).sum())
    assert beyond <= 4, beyond


@pytest.mark.parametrize("name", [m[0] for m in MESHES])
def test_every_leaf_is_split_as_the_rules_split_it_in_jax(runs, name):
    """Each param and each of its moments: the set of mesh axes (of size
    > 1) that split it in the port equals the set in its JAX sharding,
    and its local shard is the whole leaf divided along them."""
    jax_axes = runs["jax"][name]["params_axes"]
    sizes = runs["port"][name][0]["shape"]
    full = runs["port"][name][0]["params"]
    for rec in runs["port"][name]:
        assert rec["shape"] == sizes
        for n, shape in rec["local_shapes"].items():
            axes = rec["axes"][f"params/{n}"]
            assert set(axes) == jax_axes[_leaf_key(n.split("."))], (n, axes)
            moments = [v for k, v in rec["axes"].items()
                       if k.startswith("opt_state/") and k.endswith("/" + n)]
            assert moments == [axes, axes], (n, moments)
            split = int(np.prod([sizes[a] for a in axes]))
            assert np.prod(shape) * split == full[n].size, (n, shape)


class _FakeMesh:
    """What ``shard_batch`` reads of a ``DeviceMesh``."""

    def __init__(self, axes, coord):
        self.mesh_dim_names = ("dp", "fsdp", "tp", "cp", "ep", "pp")
        self.shape = tuple(axes.get(a, 1) for a in self.mesh_dim_names)
        self._coord = tuple(coord.get(a, 0) for a in self.mesh_dim_names)

    def get_coordinate(self):
        return self._coord


OWN_ROWS = {"dp2": (dict(dp=2), 2), "dp2_cp2": (dict(dp=2, cp=2), 4)}


@pytest.fixture(scope="module")
def own_rows():
    """Each mesh of ``OWN_ROWS`` (one spawn each, at once), every rank fed
    only its own rows (``own_rows_worker``), and one process on the global
    batch: the losses."""
    batch = _batch()
    spec = dict(preset="tiny", model=dict(dtype=torch.float32),
                state_dict=None, seed=0, optimizer=OPT, grads_dtype=None,
                steps=STEPS)

    def rows(world):
        n, per_dp = B // 2, world // 2
        return [{k: v[(r // per_dp) * n:(r // per_dp + 1) * n]
                 for k, v in batch.items()} for r in range(world)]

    with ThreadPoolExecutor(len(OWN_ROWS)) as pool:
        ranks = {name: pool.submit(
            process_group.spawn, own_rows_worker, world,
            (dict(spec, axes=axes, rank_rows=rows(world)),), device="cpu",
            timeout_s=SPAWN_TIMEOUT_S)
            for name, (axes, world) in OWN_ROWS.items()}
        want = mesh_workers.reference_losses(dict(spec, batch=batch), STEPS,
                                             "cpu")["loss"]
        return {name: r.result() for name, r in ranks.items()}, want


@pytest.mark.parametrize("name", list(OWN_ROWS))
def test_ranks_fed_their_own_rows_train_as_one_process(own_rows, name):
    """The reference's way of feeding ranks (examples/train_llama_ckpt.py:
    47-51, 68): each rank is handed only its own rows of the global batch,
    its block over the data axes (the cp ranks of a dp rank get the same
    rows), and passes them to ``Trainer.shard_batch``.  The losses are one
    process's on the global batch, within 1e-6 relative (fp32: the two
    differ in summation order only, as tests/test_torch_train_mesh.py
    states)."""
    ranks, want = own_rows
    for losses in ranks[name]:
        np.testing.assert_allclose(losses, want, rtol=1e-6)


def test_shard_batch_splits_rows_over_data_and_sequence_over_cp():
    """dp=2 x tp=2 x cp=2: rank (dp=i, cp=r) holds rows [8i, 8i + 8) and
    positions [8r, 8r + 8) of them, the same on both tp ranks; the JAX
    rules put "batch" on (dp, fsdp) and "seq" on cp.  The rows are cut
    from the global batch by ``rows_of_global_batch``, and ``shard_batch``
    keeps the rows it is given (they are the rank's own, as the
    reference's ``shard_batch`` takes each process's local data) and cuts
    their sequence over cp."""
    batch = _batch()
    assert sharding.spec_for_logical_axes(("batch", "seq")) == (
        ("dp", "fsdp"), "cp")
    for i in range(2):
        for r in range(2):
            for t in range(2):
                mesh = _FakeMesh(dict(dp=2, tp=2, cp=2),
                                 dict(dp=i, tp=t, cp=r))
                rows = sharding.rows_of_global_batch(mesh, batch)
                block = sharding.shard_batch(mesh, rows)
                for k, v in batch.items():
                    np.testing.assert_array_equal(rows[k],
                                                  v[8 * i:8 * i + 8])
                    np.testing.assert_array_equal(
                        block[k], v[8 * i:8 * i + 8, 8 * r:8 * r + 8])
    with pytest.raises(ValueError, match="does not split its sequence"):
        sharding.shard_batch(_FakeMesh(dict(cp=3), dict(cp=0)), batch)
    with pytest.raises(ValueError, match="does not split over 3 data"):
        sharding.rows_of_global_batch(_FakeMesh(dict(dp=3), dict(dp=0)),
                                      batch)
