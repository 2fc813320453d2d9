"""The port's Trainer with GPT-2 and ViT (dlrover_tpu_torch/trainer/train.py
with ``mesh=``) against the JAX Trainer on the same mesh: the tiny GPT
with its default LM loss on dp=4 x fsdp=2 (tests/test_models.py:144's
mesh) and on tp=2, and the tiny ViT with ``vit_loss_fn`` on
dp=2 x fsdp=2 x tp=2 (tests/test_models.py:179's), each from the JAX
model's jitted init (models/convert.py), the same global batch (GPT:
B=16, S=16 tokens; ViT: B=16 seeded normal images and labels), 4 steps of
create_optimizer (clip 1.0 in the chain, lr 1e-3 after one warm-up step
at 0), in fp32; GPT on dp=4 x fsdp=2 and ViT on dp=2 x fsdp=2 x tp=2
once more with bf16 compute and bf16 grads on the fp32 masters, so the
norms and biases that stay outside FSDP (their gradients averaged over
the data ranks by the trainer, then rounded to bf16) meet the FSDP-reduced
leaves in the dtype the card runs.  The JAX runs take the 8 virtual CPU
devices of tests/conftest.py; the port's ranks run on gloo, one spawn per
world size (8 and 2 ranks), in the background.

Also: every leaf (each param and its two moments) is split over the mesh
axes the rules give it in JAX (GPT's and ViT's norms and biases whole on
every rank, outside FSDP); ViT's ``create_state`` works on
dp=2 x cp=2 x tp=2 (tests/test_models.py:213) and its step raises
``NotImplementedError`` naming the ROADMAP item, as GPT's does on cp=2
and on ep=2.

Tolerances, as tests/test_torch_train_cp_ep.py states them for fp32:
losses within 1e-6 relative, grad norms within 2e-5, each leaf's mean
param difference within 1e-6 and its largest within DRIFT = 2 * (sum of
the lrs), params within lr / 10 but for at most 4 elements of the model.
In bf16, as tests/test_torch_train_mesh.py holds its bf16 Llama: losses
within 2e-3 relative [GPT 1.7e-5, ViT 3.6e-6], grad norms within 2e-2
[4.2e-3, 3.3e-3], params within DRIFT [5.0e-3, 4.6e-3] and each leaf's
mean difference within 2e-4 [4.6e-5, 1.4e-4], but for the k row of each
``attn_qkv.bias``: its gradient is zero in exact arithmetic (q . b_k is the
same for every key, and the softmax drops it), so Adam turns bf16
rounding into steps of ~lr either way, and its mean is held within
DRIFT / 2, the sum of the lrs [2.2e-3, 1.0e-3].  The reference spreads
there as much: the JAX Trainer on one device and on these meshes differs
in that row by a mean of 2.2e-3 (GPT) and 9.5e-4 (ViT).
"""

import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.models.gpt import GPT as JaxGPT  # noqa: E402
from dlrover_tpu.models.gpt import GPTConfig as JaxGPTConfig  # noqa: E402
from dlrover_tpu.models.vit import ViTConfig as JaxViTConfig  # noqa: E402
from dlrover_tpu.models.vit import (  # noqa: E402
    ViTForImageClassification as JaxViT,
)
from dlrover_tpu.parallel.mesh import MeshConfig as JaxMeshConfig  # noqa: E402
from dlrover_tpu.parallel.mesh import build_mesh as jax_build_mesh  # noqa: E402
from dlrover_tpu.trainer import optim as joptim  # noqa: E402
from dlrover_tpu.trainer.train import Trainer as JaxTrainer  # noqa: E402
from dlrover_tpu_torch.models.convert import (  # noqa: E402
    flax_gpt_to_state_dict,
    flax_vit_to_state_dict,
)
from dlrover_tpu_torch.models.gpt import ROADMAP_GPT_VIT_CP_EP, GPTConfig  # noqa: E402
from dlrover_tpu_torch.models.vit import ViTConfig  # noqa: E402
from dlrover_tpu_torch.parallel import process_group  # noqa: E402
from dlrover_tpu_torch.trainer import optim as toptim  # noqa: E402
from torch_gpt_vit_checks import worker  # noqa: E402

B, S, STEPS = 16, 16, 4
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=100)
LR = OPT["peak_lr"]
DRIFT = 2 * sum(toptim.cosine_schedule(**OPT)(t) for t in range(STEPS))
SPAWN_TIMEOUT_S = 240.0

# (name, mesh axes, family, ranks, bf16 compute and grads)
MESHES = [
    ("gpt_dp4_fsdp2", dict(dp=4, fsdp=2), "gpt", 8, False),
    ("gpt_tp2", dict(dp=1, tp=2), "gpt", 2, False),
    ("vit_dp2_fsdp2_tp2", dict(dp=2, fsdp=2, tp=2), "vit", 8, False),
    ("gpt_dp4_fsdp2_bf16", dict(dp=4, fsdp=2), "gpt", 8, True),
    ("vit_dp2_fsdp2_tp2_bf16", dict(dp=2, fsdp=2, tp=2), "vit", 8, True),
]
# (name, mesh axes, family): create_state works, the step is refused
REFUSALS = [
    ("vit on dp=2 x cp=2 x tp=2", dict(dp=2, cp=2, tp=2), "vit"),
    ("gpt on dp=4 x cp=2", dict(dp=4, cp=2), "gpt"),
    ("gpt on dp=4 x ep=2", dict(dp=4, ep=2), "gpt"),
]


def _batch(family):
    rng = np.random.default_rng(0)
    if family == "gpt":
        ids = rng.integers(0, 256, size=(B, S + 1))
        return {"input_ids": ids[:, :-1].astype(np.int32),
                "labels": ids[:, 1:].astype(np.int32)}
    return {"images": rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, B).astype(np.int32)}


def _jax_model(family, dtype=jnp.float32):
    if family == "gpt":
        return JaxGPT(JaxGPTConfig.tiny(dtype=dtype))
    return JaxViT(JaxViTConfig.tiny(dtype=dtype))


def _port_cfg(family):
    if family == "gpt":
        return GPTConfig.tiny(dtype=torch.float32)
    return ViTConfig.tiny(dtype=torch.float32)


def _convert(family, params):
    convert = (flax_gpt_to_state_dict if family == "gpt"
               else flax_vit_to_state_dict)
    return {k: v.numpy() for k, v in
            convert(params, _port_cfg(family)).items()}


def _inputs(family):
    return _batch(family)["input_ids" if family == "gpt" else "images"]


def _leaf_key(parts) -> str:
    """One name for a JAX leaf path or a port parameter name, the layer
    scopes dropped: ``attn_qkv.w``, ``ln_1.scale``, ``head.bias``."""
    parts = [p for p in parts
             if not re.fullmatch(r"layers|h|block|encoder|\d+", p)]
    if parts[-1] in ("kernel", "weight"):
        parts[-1] = "w"
    return ".".join(parts)


def _jax_axes(tree, mesh):
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


def _run_jax(axes, family, n_devices, bf16):
    dtype = jnp.bfloat16 if bf16 else jnp.float32
    model = _jax_model(family, dtype)
    mesh = jax_build_mesh(JaxMeshConfig(**axes),
                          devices=jax.devices()[:n_devices])
    loss_fn = None
    if family == "vit":
        def loss_fn(params, batch):
            return model.loss(model.apply({"params": params},
                                          batch["images"]), batch["labels"])
    trainer = JaxTrainer(model, joptim.create_optimizer(**OPT), mesh,
                         loss_fn=loss_fn,
                         grads_dtype=dtype if bf16 else None)
    batch = _batch(family)
    state = trainer.create_state(jax.random.PRNGKey(0), _inputs(family))
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
    model = _jax_model(family)
    return jax.tree.map(np.asarray, nn.meta.unbox(jax.jit(
        lambda rng: model.init(rng, _inputs(family)))(
            jax.random.PRNGKey(0))["params"]))


@pytest.fixture(scope="module")
def runs():
    """The port's meshes, one spawn of gloo ranks per world size, in the
    background from the JAX models' initial weights, while the JAX
    Trainer runs each mesh here."""
    inits = {f: _init(f) for f in ("gpt", "vit")}
    family_spec = {f: dict(family=f, preset="tiny", batch=_batch(f),
                           state_dict=_convert(f, inits[f]))
                   for f in inits}
    spec = dict(model=dict(dtype=torch.float32), optimizer=OPT,
                grads_dtype=None, return_params=True)
    worlds = sorted({m[3] for m in MESHES})
    with ThreadPoolExecutor(len(worlds)) as pool:
        spawns = {
            world: pool.submit(
                process_group.spawn, worker, world,
                (dict(spec, runs=[
                    dict(name=name, axes=axes, steps=STEPS,
                         spec=family_spec[family],
                         **(dict(model=dict(dtype=torch.bfloat16),
                                 grads_dtype=torch.bfloat16) if bf16
                            else {}))
                    for name, axes, family, n, bf16 in MESHES
                    if n == world],
                    refusals={} if world != 8 else {
                        name: dict(axes=axes, spec=family_spec[family])
                        for name, axes, family in REFUSALS}),),
                device="cpu", timeout_s=SPAWN_TIMEOUT_S)
            for world in worlds}
        jax_runs = {name: _run_jax(axes, family, n, bf16)
                    for name, axes, family, n, bf16 in MESHES}
        ranks = {world: f.result() for world, f in spawns.items()}
    port = {name: [r["runs"][name] for r in ranks[n]]
            for name, _, _, n, _ in MESHES}
    return dict(jax=jax_runs, port=port, inits=inits,
                refusals=[r["refusals"] for r in ranks[8]])


@pytest.mark.parametrize("name,family", [(m[0], m[2]) for m in MESHES])
def test_jax_starts_from_the_weights_the_port_loads(runs, name, family):
    for a, b in zip(jax.tree.leaves(runs["inits"][family]),
                    jax.tree.leaves(runs["jax"][name]["init"])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,family,bf16",
                         [(m[0], m[2], m[4]) for m in MESHES])
def test_matches_the_jax_trainer_on_the_same_mesh(runs, name, family, bf16):
    records = runs["port"][name]
    want = runs["jax"][name]
    for rec in records:  # every rank reports the global loss and norm
        np.testing.assert_allclose(rec["loss"], want["loss"],
                                   rtol=2e-3 if bf16 else 1e-6)
        np.testing.assert_allclose(rec["grad_norm"], want["grad_norm"],
                                   rtol=2e-2 if bf16 else 2e-5)
    assert records[0]["loss"][-1] < records[0]["loss"][0]
    got = records[0]["params"]
    final = _convert(family, want["final"])
    assert set(got) == set(final)
    beyond = 0
    for n in got:
        assert got[n].dtype == np.float32  # fp32 masters
        diff = np.abs(got[n] - final[n])
        assert diff.max() <= DRIFT, (n, diff.max())
        mean = diff.mean()
        if bf16 and n.endswith("attn_qkv.bias"):
            # the k row's gradient is zero but for rounding: q . b_k is the
            # same for every key, so the softmax drops it
            q, k, v = diff.reshape(3, -1)
            assert k.mean() <= DRIFT / 2, (n, k.mean())
            mean = np.concatenate([q, v]).mean()
        assert mean <= (2e-4 if bf16 else 1e-6), (n, mean)
        beyond += int((diff > LR / 10).sum())
    if not bf16:
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


@pytest.mark.parametrize("case", [r[0] for r in REFUSALS])
def test_cp_and_ep_make_a_state_and_refuse_the_step(runs, case):
    item = ROADMAP_GPT_VIT_CP_EP.split(" (")[0]
    for rank in runs["refusals"]:
        got = rank[case]
        assert got["state_step"] == 0
        kind, message = got["step"]
        assert kind == "NotImplementedError", got
        assert item in message, message
