"""The port's Trainer on a mesh (dlrover_tpu_torch/trainer/train.py with
``mesh=``) against the JAX Trainer on the same mesh, on a tiny Llama
from the same weights (models/convert.py) and the same global batch
(B=16, S=16), 4 steps of create_optimizer (clip 1.0 in the chain, lr 1e-3
after one warm-up step at 0).  The meshes are the cases of
tests/test_models.py's TestShardedTraining: dp=2 x fsdp=2 x tp=2, dp=8,
dp=4 x fsdp=2 with grad_accum_steps=2, and dp=4 x tp=2 (the dp grad sync
over the mesh's dp group with tp-split leaves) (the JAX run on 8 virtual
CPU devices, the port on 8 gloo ranks of one spawn), and tp=2 (2 ranks
started as the agent starts workers, through bootstrap.init over a tcp
coordinator).  Also: every leaf (each param and its two moments) is split
over the set of mesh axes the rules give in JAX, and its local shard has
the shape that split implies; adjust_accum_for_world; and the refusals
that need ranks (a quantized sync with tp > 1 or with fsdp > 1, pp > 1,
an ep that does not divide the experts), beside the cp and ep meshes the
trainer takes, the flash kernels and the MoE under cp among them.

The meshes are run in fp32, and dp=2 x fsdp=2 x tp=2 once more with bf16
compute and bf16 grads on the fp32 masters (FSDP's mixed precision: it
gathers each layer in bf16 and reduces the gradients in fp32, which the
trainer rounds to bf16 before the norm and the update; the row shards of
tp sum two bf16 partial outputs).

Tolerances, set with margin over what was measured (in brackets), as
tests/test_torch_train.py states them for its cases.  In fp32 the two
trainers differ in summation order only (the reduce over ranks, the norm
over shards, the vocab-parallel log-sum-exp): losses within 1e-6
relative [0, 1.0e-7]; grad norms (the clip's, over the sharded leaves;
~6.6, so the clip at 1.0 engages) within 2e-5 [3.9e-6]; each leaf's
mean param difference within 1e-6 [1.1e-7], and params within lr / 10 =
1e-4 [6.4e-5] but for at most 4 elements of the model [tp=2 and dp=4 x
tp=2: 1 (2 in another run), the others 0].  Those few may drift up to
DRIFT = 2 * (sum of the lrs) [1.47e-4]: Adam moves every param by ~lr a
step whatever its gradient's size, so an element whose gradient is near
zero moves by an amount that summation order decides.  One element
of layer 0's k_proj does so in the reference itself: the JAX Trainer on
one device and on tp=2 differ there by 4.5e-5, and the port on one device
and JAX on one device by 8.9e-5.  In bf16 the activations round at other
points: losses within 2e-3 relative [2.5e-4], grad norms within 2e-2
[2.4e-3; JAX's norm over bf16 leaves is itself bf16], params within DRIFT
[4.4e-3], each leaf's mean within 2e-4 [8.9e-5: a 64-element norm scale,
where a few elements moved the other way weigh most; the weight matrices
5.4e-5].
"""

import re
import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Replicate  # noqa: E402

from dlrover_tpu.models.llama import LlamaConfig as JaxLlamaConfig  # noqa: E402
from dlrover_tpu.models.llama import LlamaForCausalLM as JaxLlama  # noqa: E402
from dlrover_tpu.parallel.mesh import MeshConfig as JaxMeshConfig  # noqa: E402
from dlrover_tpu.parallel.mesh import build_mesh as jax_build_mesh  # noqa: E402
from dlrover_tpu.trainer import optim as joptim  # noqa: E402
from dlrover_tpu.trainer.train import Trainer as JaxTrainer  # noqa: E402
from dlrover_tpu_torch.models.convert import (  # noqa: E402
    flax_llama_to_state_dict,
)
from dlrover_tpu_torch.common.pytree import flatten_with_path  # noqa: E402
from dlrover_tpu_torch.models.llama import (  # noqa: E402
    LlamaConfig,
    LlamaForCausalLM,
)
from dlrover_tpu_torch.parallel import (  # noqa: E402
    dp_workers,
    mesh_workers,
    process_group,
)
from dlrover_tpu_torch.parallel.mesh import build_mesh  # noqa: E402
from dlrover_tpu_torch.trainer import bootstrap  # noqa: E402
from dlrover_tpu_torch.trainer import optim as toptim  # noqa: E402
from dlrover_tpu_torch.trainer.flash_checkpoint.checkpointer import (  # noqa: E402,E501
    Checkpointer,
    StorageType,
)
from dlrover_tpu_torch.trainer.train import Trainer  # noqa: E402
from torch_mesh_checks import refusal_worker  # noqa: E402

B, S, STEPS = 16, 16, 4
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=100)
LR = OPT["peak_lr"]
DRIFT = 2 * sum(toptim.cosine_schedule(**OPT)(t) for t in range(STEPS))
SPAWN_TIMEOUT_S = 180.0

# (name, mesh axes, grad_accum_steps, ranks, bf16 compute and grads)
MESHES = [
    ("dp2_fsdp2_tp2", dict(dp=2, fsdp=2, tp=2), 1, 8, False),
    ("dp8", dict(dp=8), 1, 8, False),
    ("dp4_fsdp2_accum2", dict(dp=4, fsdp=2), 2, 8, False),
    ("tp2", dict(dp=1, tp=2), 1, 2, False),
    ("dp4_tp2", dict(dp=4, tp=2), 1, 8, False),
    ("dp2_fsdp2_tp2_bf16", dict(dp=2, fsdp=2, tp=2), 1, 8, True),
]


def _batch():
    ids = np.random.default_rng(0).integers(0, 256, size=(B, S + 1))
    return {"input_ids": ids[:, :-1].astype(np.int32),
            "labels": ids[:, 1:].astype(np.int32)}


def _leaf_key(parts) -> str:
    """One name for a JAX leaf path or a port parameter name, the layer
    index dropped: ``attn.q_proj``, ``input_norm.scale``, ``lm_head``."""
    parts = [p for p in parts if p not in ("layers", "layer")
             and not p.isdigit()]
    if parts[-1] in ("kernel", "weight"):
        parts = parts[:-1]
    return ".".join(parts)


def _jax_axes(tree, mesh):
    """``{leaf key: set of active mesh axes in its sharding spec}``."""
    shape = dict(mesh.shape)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [getattr(k, "key", getattr(k, "name", str(k))) for k in path]
        axes = set()
        for entry in leaf.sharding.spec:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None and shape[a] > 1:
                    axes.add(a)
        out[_leaf_key([str(n) for n in names])] = axes
    return out


def _run_jax(axes, accum, n_devices, bf16):
    dtype = jnp.bfloat16 if bf16 else jnp.float32
    cfg = JaxLlamaConfig.tiny(dtype=dtype)
    mesh = jax_build_mesh(JaxMeshConfig(**axes),
                          devices=jax.devices()[:n_devices])
    trainer = JaxTrainer(JaxLlama(cfg), joptim.create_optimizer(**OPT), mesh,
                         grad_accum_steps=accum,
                         grads_dtype=dtype if bf16 else None)
    batch = _batch()
    state = trainer.create_state(jax.random.PRNGKey(0), batch["input_ids"])
    init = jax.tree.map(np.asarray, nn.meta.unbox(state.params))
    params_axes = _jax_axes(nn.meta.unbox(state.params), mesh)
    mu = nn.meta.unbox(state.opt_state[1][0].mu)
    moment_axes = _jax_axes(mu, mesh)
    losses, norms = [], []
    for _ in range(STEPS):
        state, metrics = trainer.train_step(state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    final = jax.tree.map(np.asarray, nn.meta.unbox(state.params))
    return dict(init=init, final=final, loss=np.array(losses),
                grad_norm=np.array(norms),
                params_axes=params_axes, moment_axes=moment_axes,
                trainer=trainer)


@pytest.fixture(scope="module")
def runs():
    """The port (the three 8-rank meshes in ONE spawn of 8 gloo ranks,
    and tp=2 in one launch of 2 workers through bootstrap.init) in the
    background, from the JAX model's initial weights, while the JAX
    Trainer runs each mesh here."""
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    model = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32))
    init = jax.tree.map(np.asarray, nn.meta.unbox(jax.jit(
        lambda rng: model.init(rng, _batch()["input_ids"]))(
            jax.random.PRNGKey(0))["params"]))
    state_dict = {k: v.numpy() for k, v in
                  flax_llama_to_state_dict(init, cfg).items()}
    spec = dict(preset="tiny", model=dict(dtype=torch.float32),
                state_dict=state_dict, batch=_batch(),
                optimizer=OPT, grads_dtype=None, return_params=True)
    eight = dict(spec, runs=[
        dict(name=name, axes=axes, steps=STEPS, grad_accum=accum,
             **(dict(model=dict(dtype=torch.bfloat16),
                     grads_dtype=torch.bfloat16) if bf16 else {}))
        for name, axes, accum, n, bf16 in MESHES if n == 8])
    two = dict(spec, platform="cpu", runs=[
        dict(name=name, axes=axes, steps=STEPS, grad_accum=accum)
        for name, axes, accum, n, _ in MESHES if n == 2])
    with ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(process_group.spawn, dp_workers.train_worker,
                            8, (eight,), device="cpu",
                            timeout_s=SPAWN_TIMEOUT_S)
        workers = pool.submit(process_group.launch,
                              mesh_workers.bootstrap_worker, 2, (two,),
                              timeout_s=SPAWN_TIMEOUT_S)
        jax_runs = {name: _run_jax(axes, accum, n, bf16)
                    for name, axes, accum, n, bf16 in MESHES}
        ranks, workers = ranks.result(), workers.result()
    port = {}
    for name, _, _, n, _ in MESHES:
        records = ([r["runs"][name] for r in ranks] if n == 8 else
                   [w["train"]["runs"][name] for w in workers])
        port[name] = records
    return dict(cfg=cfg, jax=jax_runs, port=port, workers=workers,
                init=init)


def test_jax_init_is_the_same_on_every_mesh(runs):
    """One set of weights, the JAX model's init, serves every port run:
    the JAX Trainer's state starts from it on every mesh."""
    ref = jax.tree.leaves(runs["init"])
    for name, *_ in MESHES:
        for a, b in zip(ref, jax.tree.leaves(runs["jax"][name]["init"])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,bf16", [(m[0], m[4]) for m in MESHES])
def test_matches_the_jax_trainer_on_the_same_mesh(runs, name, bf16):
    records = runs["port"][name]
    want = runs["jax"][name]
    for rec in records:  # every rank reports the global loss and norm
        np.testing.assert_allclose(rec["loss"], want["loss"],
                                   rtol=2e-3 if bf16 else 1e-6)
        np.testing.assert_allclose(rec["grad_norm"], want["grad_norm"],
                                   rtol=2e-2 if bf16 else 2e-5)
    assert records[0]["loss"][-1] < records[0]["loss"][0]
    got = records[0]["params"]
    final = {k: v.numpy() for k, v in
             flax_llama_to_state_dict(want["final"], runs["cfg"]).items()}
    assert set(got) == set(final)
    beyond = 0
    for n in got:
        assert got[n].dtype == np.float32  # fp32 masters
        diff = np.abs(got[n] - final[n])
        assert diff.max() <= DRIFT, (n, diff.max())
        assert diff.mean() <= (2e-4 if bf16 else 1e-6), (n, diff.mean())
        beyond += int((diff > LR / 10).sum())
    if not bf16:
        assert beyond <= 4, beyond


@pytest.mark.parametrize("name", [m[0] for m in MESHES])
def test_every_leaf_is_split_as_the_rules_split_it_in_jax(runs, name):
    """Each param and each of its moments: the set of mesh axes (of size
    > 1) that split it in the port equals the set in its JAX sharding,
    and its local shard is the whole leaf divided along them."""
    jax_run = runs["jax"][name]
    sizes = runs["port"][name][0]["shape"]
    full = runs["port"][name][0]["params"]
    for rec in runs["port"][name]:
        assert rec["shape"] == sizes
        for n, shape in rec["local_shapes"].items():
            key = _leaf_key(n.split("."))
            axes = rec["axes"][f"params/{n}"]
            assert set(axes) == jax_run["params_axes"][key], (n, axes)
            moments = [v for k, v in rec["axes"].items()
                       if k.startswith("opt_state/") and k.endswith("/" + n)]
            assert moments == [axes, axes], (n, moments)
            assert jax_run["moment_axes"][key] == set(axes)
            split = int(np.prod([sizes[a] for a in axes]))
            assert np.prod(shape) * split == full[n].size, (n, shape)


def test_tp2_ran_through_bootstrap_over_tcp(runs):
    workers = runs["workers"]
    for rank, w in enumerate(workers):
        assert w["initialised_by_init"] and w["backend"] == "gloo"
        assert w["world"] == 2 and w["ranks_seen"] == [0, 1]
        ctx = w["context"]
        assert (ctx["process_id"], ctx["num_processes"]) == (rank, 2)
        assert re.fullmatch(r"127\.0\.0\.1:\d+", ctx["coordinator_addr"])


@pytest.fixture(scope="module")
def refusals():
    return process_group.spawn(refusal_worker, 8, (), device="cpu",
                               timeout_s=SPAWN_TIMEOUT_S)


def test_adjust_accum_for_world(runs, refusals):
    """64 rows at 1 per device on dp=4 x fsdp=2: 8 accumulation steps,
    as the reference computes (tests/test_models.py)."""
    assert runs["jax"]["dp4_fsdp2_accum2"]["trainer"].adjust_accum_for_world(
        global_batch=64, per_device_batch=1) == 8
    assert [r["accum"] for r in refusals] == [8] * 8


def test_refusals_on_ranks(refusals):
    """A quantized sync needs a pure dp mesh (ValueError, the reference's
    two messages); cp and ep are taken (the dense Llama's ep ranks compute
    the same step), and so are the flash kernels and the MoE model under
    cp; pp raises NotImplementedError naming the function-style pp path
    (the Trainer does not pipeline, as the reference's does not); a mesh
    and a dp group together raise ValueError, and so do a tp that does not
    divide the kv heads and an ep that does not divide the experts; the
    flash checkpoint takes the world: its process id and count are the
    rank's and the world's."""
    want = {
        "int8 on tp=2": ("ValueError", "non-data axes ['tp']"),
        "int8 on fsdp=2": ("ValueError", "active data axes ['fsdp']"),
        "cp=2": ("accepted", ""),
        "ep=2": ("accepted", ""),
        "pp=2": ("NotImplementedError", "models.pipeline_llama.PipelinedLlama"),
        "mesh and dp_group": ("ValueError", "not both"),
        "tp=4 over 2 kv heads": ("ValueError",
                                 "tp=4 does not divide num_kv_heads=2"),
        "flash on cp=2": ("accepted", ""),
        "moe on cp=2": ("accepted", ""),
        "ep=8 over 4 experts": ("ValueError",
                                "ep=8 does not divide num_experts=4"),
        "flash checkpoint": ("accepted", " of 8"),
    }
    for index, rank in enumerate(refusals):
        assert rank["flash checkpoint"][1] == f"process {index} of 8"
        assert set(rank) == set(want) | {"accum"}
        for case, (kind, text) in want.items():
            assert rank[case][0] == kind, (case, rank[case])
            assert text in rank[case][1], (case, rank[case])


def test_a_mesh_state_at_world_one_saves_and_restores(tmp_path):
    """bootstrap -> build_mesh -> Trainer(mesh=...) in one process: the
    mesh of ones holds whole leaves, so its state checkpoints as the
    single-device state does: restored bit for bit, and the next step
    from the restore equals the next step from the state saved."""
    def trainer():
        model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32),
                                 device="cpu")
        t = Trainer(model, toptim.create_optimizer(**OPT),
                    mesh=build_mesh(device="cpu"), device="cpu")
        return t, t.create_state()

    assert bootstrap.init(platform="cpu").num_processes == 1
    ckpt = ckpt2 = None
    try:
        first, state = trainer()
        assert all(p == (Replicate(),) * 6
                   for p in first.placements.values())
        batch = first.shard_batch(_batch())
        state, _ = first.train_step(state, batch)
        want = {p: (v.clone() if torch.is_tensor(v) else v)
                for p, v in flatten_with_path(state)}
        scope = f"t{uuid.uuid4().hex[:8]}"
        ckpt = Checkpointer(str(tmp_path), scope=scope, device="cpu")
        ckpt.save_checkpoint(1, state, StorageType.DISK)
        assert ckpt.wait_latest_checkpoint(timeout=60)
        _, expect = first.train_step(state, batch)
        second, fresh = trainer()
        ckpt2 = Checkpointer(str(tmp_path), scope=scope, device="cpu")
        restored, step = ckpt2.load_checkpoint(fresh, trainer=second)
        assert step == 1
        for path, leaf in flatten_with_path(restored):
            if torch.is_tensor(leaf):
                assert torch.equal(leaf, want[path]), path
            else:
                assert leaf == want[path], path
        _, metrics = second.train_step(restored, batch)
        assert metrics["loss"].item() == expect["loss"].item()
    finally:
        if ckpt is not None:
            ckpt.engine.unlink_memory()
        for c in (ckpt2, ckpt):
            if c is not None:
                c.close()
        if dist.is_initialized():
            dist.destroy_process_group()
