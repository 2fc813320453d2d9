"""``Trainer.load_state`` of the port (dlrover_tpu_torch/trainer/train.py)
against the JAX Trainer's: the error-feedback residuals of a quantized dp
sync across a change of the dp degree.

The model is the reference tests' regression MLP (tests/test_grad_sync.py)
with a 6-wide hidden layer: its ``Dense_1`` bias (6,) and ``Dense_2``
kernel (6, 1) split over 2 replicas but not over 4, so a dp shrink makes
them shardable with no stored residual.  Both packages run
``grad_sync="int8_sharded"`` and the same sequence in a checkpoint
directory of their own:

- dp=2 saves step 1 with residual stacks ``S1`` (2, *leaf), seeded;
- dp=4 saves step 2 with residual stacks ``S2`` (4, *leaf), seeded;
- dp=2 restores with ``load_state``.

The port's ranks are gloo ranks on the CPU (tests/torch_ckpt_checks.py
``ef_worker``); the dp=4 world's trainer is on a mesh whose only axis is
dp, the dp=2 worlds' over a dp group (the Trainer's two paths to the
sync), and each saving world also restores at its own degree.  The dp=2
restore must skip the stale step 1 for step 2, and each new replica's
residual must equal the JAX Trainer's in fp32 (both sum the stored rows on
the host in numpy fp32 and divide by the new degree), their sum the stored
sum within 1e-6 relative (of the leaf's largest stored sum, for elements
near zero), and the newly shardable leaves zero.
"""

import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from dlrover_tpu_torch.parallel import collectives, process_group
from torch_ckpt_checks import MLP_DIMS, ef_worker

SPAWN_TIMEOUT_S = 120.0
SUM_RTOL = 1e-6


def _shapes():
    out = {}
    for i, (n_in, n_out) in enumerate(MLP_DIMS):
        out[f"Dense_{i}.kernel"] = (n_in, n_out)
        out[f"Dense_{i}.bias"] = (n_out,)
    return out


def _stacks(world: int, seed: int):
    """Seeded residual stacks ``(world, *leaf)`` of the leaves a dp world
    of ``world`` quantizes (its shardable leaves)."""
    rng = np.random.default_rng(seed)
    layout = collectives.GradLayout(_shapes(), world)
    return {n: rng.standard_normal((world,) + _shapes()[n]).astype(
        np.float32) for n in layout.sharded_paths()}


def _jax_side(jax, ckpt_dir, s1, s2):
    """The JAX Trainer's save at dp=2 (step 1) and dp=4 (step 2) and its
    ``load_state`` at dp=2: the step and the residual stacks, by the
    port's leaf names."""
    import flax.linen as nn
    import jax.numpy as jnp
    import optax

    from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu.trainer.flash_checkpoint import (
        Checkpointer,
        StorageType,
    )
    from dlrover_tpu.trainer.train import Trainer

    class MLP(nn.Module):
        @nn.compact
        def __call__(self, x):
            h = x
            for i, (_, n_out) in enumerate(MLP_DIMS):
                h = nn.Dense(n_out)(h)
                if i < len(MLP_DIMS) - 1:
                    h = nn.tanh(h)
            return h[..., 0]

    def trainer(dp):
        model = MLP()

        def loss_fn(params, batch):
            pred = model.apply({"params": params}, batch["x"])
            return jnp.mean((pred - batch["y"]) ** 2)

        mesh = build_mesh(MeshConfig(dp=dp), devices=jax.devices()[:dp])
        return Trainer(model, optax.adamw(1e-2), mesh, loss_fn=loss_fn,
                       grad_sync="int8_sharded")

    x = np.zeros((8, MLP_DIMS[0][0]), np.float32)
    rng = jax.random.PRNGKey(0)
    for dp, step, stacks in ((2, 1, s1), (4, 2, s2)):
        t = trainer(dp)
        state = t.create_state(rng, x)
        assert {k.replace("/", ".") for k in state.ef_residual} == set(stacks)
        state = state.replace(
            step=jnp.asarray(step, state.step.dtype),
            ef_residual={k: jax.device_put(stacks[k.replace("/", ".")],
                                           v.sharding)
                         for k, v in state.ef_residual.items()})
        ckpt = Checkpointer(ckpt_dir, scope=f"j{uuid.uuid4().hex[:8]}",
                            async_snapshot=False)
        ckpt.save_checkpoint(step, state, StorageType.DISK)
        assert ckpt.wait_latest_checkpoint(timeout=120)
        ckpt.engine.unlink_memory()
        ckpt.close()
    ckpt = Checkpointer(ckpt_dir, scope=f"j{uuid.uuid4().hex[:8]}")
    try:
        restored, step = trainer(2).load_state(ckpt, rng, x)
    finally:
        ckpt.engine.unlink_memory()
        ckpt.close()
    return step, {k.replace("/", "."): np.asarray(v, np.float32)
                  for k, v in restored.ef_residual.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax = pytest.importorskip("jax")
    s1, s2 = _stacks(2, seed=1), _stacks(4, seed=2)
    port_dir = str(tmp_path_factory.mktemp("port"))
    jax_dir = str(tmp_path_factory.mktemp("jax"))
    scope = f"e{uuid.uuid4().hex[:8]}"

    def port():
        return [process_group.spawn(
            ef_worker, world, (dict(spec, dir=port_dir, scope=scope + tag),),
            device="cpu", timeout_s=SPAWN_TIMEOUT_S)
            for world, tag, spec in (
                (2, "a", dict(stacks=s1, step=1)),
                (4, "b", dict(stacks=s2, step=2, on_mesh=True)),
                (2, "c", {}))]

    with ThreadPoolExecutor(1) as pool:
        background = pool.submit(port)
        jax_step, jax_ef = _jax_side(jax, jax_dir, s1, s2)
        saved2, saved4, resumed = background.result()
    return dict(s1=s1, s2=s2, saved2=saved2, saved4=saved4,
                resumed=resumed, jax_step=jax_step, jax_ef=jax_ef)


def test_same_degree_restore_is_exact(runs):
    """Each saving world restores its own step at its own degree: every
    rank's residual is its row of the stacks saved, bit for bit."""
    for ranks, stacks, step in ((runs["saved2"], runs["s1"], 1),
                                (runs["saved4"], runs["s2"], 2)):
        for rank, got in enumerate(ranks):
            assert got["step"] == step
            assert set(got["ef"]) == set(stacks)
            for n, stack in stacks.items():
                np.testing.assert_array_equal(got["ef"][n], stack[rank])


def test_newer_step_at_another_degree_wins(runs):
    """dp=2 restores the newer step 2 saved at dp=4, not the stale step 1
    that its own degree covers; so does the JAX Trainer."""
    assert runs["jax_step"] == 2
    assert [r["step"] for r in runs["resumed"]] == [2, 2]


def test_residuals_redistribute_as_the_reference_does(runs):
    """Each new replica carries ``sum(S2 rows) / 2``: equal in fp32 to the
    JAX Trainer's row, the sum over the replicas the stored sum (1e-6
    relative), and zero for the leaves dp=4 did not quantize."""
    resumed, s2, jax_ef = runs["resumed"], runs["s2"], runs["jax_ef"]
    assert set(jax_ef) == set(resumed[0]["ef"]) == set(_stacks(2, 0))
    for n, want in jax_ef.items():
        assert want.shape[0] == 2
        for rank, got in enumerate(resumed):
            assert got["ef"][n].dtype == np.float32
            np.testing.assert_array_equal(got["ef"][n], want[rank])
        total = sum(r["ef"][n].astype(np.float64) for r in resumed)
        if n in s2:
            stored = s2[n].astype(np.float64).sum(axis=0)
            np.testing.assert_allclose(total, stored, rtol=SUM_RTOL,
                                       atol=SUM_RTOL * np.abs(stored).max())
        else:
            assert not total.any(), n
