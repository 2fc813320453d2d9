"""The port's Trainer (dlrover_tpu_torch/trainer/train.py) against the JAX
Trainer of dlrover_tpu/trainer/train.py on a one-device mesh: loss and
grad-norm trajectories and the final params over 4 steps, from the same
initial weights and batch."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.models.llama import LlamaConfig as JaxLlamaConfig  # noqa: E402
from dlrover_tpu.models.llama import LlamaForCausalLM as JaxLlama  # noqa: E402
from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh  # noqa: E402
from dlrover_tpu.trainer import optim as joptim  # noqa: E402
from dlrover_tpu.trainer.train import Trainer as JaxTrainer  # noqa: E402
from dlrover_tpu_torch.models.convert import (  # noqa: E402
    flax_llama_to_state_dict,
)
from dlrover_tpu_torch.models.llama import (  # noqa: E402
    LlamaConfig,
    LlamaForCausalLM,
)
from dlrover_tpu_torch.trainer import optim as toptim  # noqa: E402
from dlrover_tpu_torch.trainer.train import (  # noqa: E402
    Trainer,
    cross_entropy_loss,
)

STEPS = 4
B, S = 4, 32
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=100)


def _batch():
    ids = np.random.default_rng(0).integers(0, 256, size=(B, S + 1))
    return {
        "input_ids": ids[:, :-1].astype(np.int32),
        "labels": ids[:, 1:].astype(np.int32),
    }


def _run_jax(dtype, grads_dtype, accum):
    cfg = JaxLlamaConfig.tiny(attention_impl="flash", dtype=dtype)
    mesh = build_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    trainer = JaxTrainer(
        JaxLlama(cfg),
        joptim.create_optimizer(moment_dtype=jnp.bfloat16, **OPT),
        mesh, grads_dtype=grads_dtype, grad_accum_steps=accum,
    )
    batch = _batch()
    state = trainer.create_state(jax.random.PRNGKey(0), batch["input_ids"])
    init = jax.tree.map(np.asarray, nn.meta.unbox(state.params))
    losses, norms = [], []
    for _ in range(STEPS):
        state, metrics = trainer.train_step(state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    final = jax.tree.map(np.asarray, nn.meta.unbox(state.params))
    return init, final, np.array(losses), np.array(norms)


def _run_torch(init, dtype, grads_dtype, accum):
    cfg = LlamaConfig.tiny(attention_impl="flash", dtype=dtype)
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(flax_llama_to_state_dict(init, cfg))
    trainer = Trainer(
        model, toptim.create_optimizer(moment_dtype=torch.bfloat16, **OPT),
        grads_dtype=grads_dtype, grad_accum_steps=accum, device="cpu",
    )
    state = trainer.create_state()
    batch = _batch()
    losses, norms = [], []
    for _ in range(STEPS):
        state, metrics = trainer.train_step(state, batch)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    assert state.step == STEPS
    return cfg, state, np.array(losses), np.array(norms)


# (name, JAX dtypes, torch dtypes, accum, loss rtol, grad-norm rtol,
#  param max-abs tol, param mean-abs tol).  Adam's first steps move every
#  param by ~lr whatever the gradient's size, so a near-zero gradient
#  element computed slightly differently can move its param the other
#  way: one param may drift at most 2 * (sum of the lrs) apart, the mean
#  is held to the algorithm.
#  fp32: the same fp32 math on both sides, summation order apart
#  (measured: loss 2e-7, grad norm 2e-6 relative; params 1.3e-5 max,
#  3.4e-8 mean).  bf16 compute with bf16 grads: activations round at
#  different points (the logits already sit ~0.05 apart,
#  test_torch_llama.py), and optax's grad norm is itself rounded to bf16
#  (0.6% spacing at ~10) where the port sums in fp32 (trainer/optim.py)
#  (measured: loss 3.2e-4, grad norm 6.1e-3 relative; params 3.0e-3 max,
#  3.7e-5 mean)
LR = OPT["peak_lr"]
DRIFT = 2 * sum(toptim.cosine_schedule(**OPT)(t) for t in range(STEPS))
CASES = [
    ("fp32", (jnp.float32, None), (torch.float32, None), 1,
     1e-5, 1e-4, LR / 10, 1e-6),
    ("fp32_accum2", (jnp.float32, None), (torch.float32, None), 2,
     1e-5, 1e-4, LR / 10, 1e-6),
    ("bf16_grads", (jnp.bfloat16, jnp.bfloat16),
     (torch.bfloat16, torch.bfloat16), 1, 2e-3, 2e-2, DRIFT, 1e-4),
    ("bf16_grads_accum2", (jnp.bfloat16, jnp.bfloat16),
     (torch.bfloat16, torch.bfloat16), 2, 2e-3, 2e-2, DRIFT, 1e-4),
]


@pytest.mark.parametrize(
    "name,jdt,tdt,accum,loss_rtol,norm_rtol,max_tol,mean_tol", CASES,
    ids=[c[0] for c in CASES],
)
def test_trajectory_matches_jax_trainer(name, jdt, tdt, accum, loss_rtol,
                                        norm_rtol, max_tol, mean_tol):
    init, final_j, losses_j, norms_j = _run_jax(*jdt, accum)
    cfg, state, losses_t, norms_t = _run_torch(init, *tdt, accum)
    np.testing.assert_allclose(losses_t, losses_j, rtol=loss_rtol)
    np.testing.assert_allclose(norms_t, norms_j, rtol=norm_rtol)
    assert losses_t[-1] < losses_t[0]  # it trains
    want = flax_llama_to_state_dict(final_j, cfg)
    for n, p in state.params.items():
        assert p.dtype == torch.float32  # fp32 masters
        diff = np.abs(p.numpy() - want[n].numpy())
        assert diff.max() <= max_tol, (n, diff.max())
        assert diff.mean() <= mean_tol, (n, diff.mean())


def test_bf16_grads_keep_fp32_masters():
    cfg = LlamaConfig.tiny()
    model = LlamaForCausalLM(cfg, device="cpu")
    trainer = Trainer(model, toptim.create_optimizer(**OPT),
                      grads_dtype=torch.bfloat16, device="cpu")
    state = trainer.create_state()
    batch = _batch()
    captured = {}
    original = trainer._grad_fn

    def spy(b):
        loss, grads = original(b)
        captured.update(grads)
        return loss, grads

    trainer._grad_fn = spy
    for _ in range(2):
        state, _ = trainer.train_step(state, batch)
    assert all(g.dtype == torch.bfloat16 for g in captured.values())
    for n, p in model.named_parameters():
        assert p.dtype == torch.bfloat16
        assert state.params[n].dtype == torch.float32
        # the compute copy is the master rounded to bf16, refreshed after
        # every update
        torch.testing.assert_close(p, state.params[n].to(torch.bfloat16),
                                   rtol=0, atol=0)


def test_cross_entropy_matches_jax():
    from dlrover_tpu.trainer.train import cross_entropy_loss as jax_xent

    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 8, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, size=(2, 8))
    mask = (rng.random((2, 8)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = float(jax_xent(jnp.asarray(logits), jnp.asarray(labels),
                              None if m is None else jnp.asarray(m)))
        got = cross_entropy_loss(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m)).item()
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_accumulation_needs_a_divisible_batch():
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    trainer = Trainer(model, toptim.create_optimizer(**OPT),
                      grad_accum_steps=3, device="cpu")
    state = trainer.create_state()
    with pytest.raises(ValueError, match="divisible"):
        trainer.train_step(state, _batch())


def test_other_grad_sync_modes_are_a_later_slice():
    """What the dp grad sync leaves to later slices raises: stochastic
    rounding and the hierarchical two-level sync.  The exact ring tiers are
    ported: the trainer resolves every ring request for its buckets with
    the reference's fallback chain, so a stand-in group of 4 ranks is
    enough (the tiny model's one 4 MB bucket is 26,704 wide, off the
    ring_pallas tiling rule, and there is no card for ring_rdma)."""
    from types import SimpleNamespace

    from dlrover_tpu_torch.parallel.collectives import GradSyncPolicy

    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    optimizer = toptim.create_optimizer(grad_clip_norm=None, **OPT)
    with pytest.raises(NotImplementedError, match="later slice"):
        Trainer(model, optimizer, device="cpu", grad_sync=GradSyncPolicy(
            mode="int8_sharded", rounding="stochastic"))
    with pytest.raises(NotImplementedError, match="later slice"):
        Trainer(model, optimizer, device="cpu", grad_sync=GradSyncPolicy(
            mode="int8_sharded", hierarchical=True))
    four = SimpleNamespace(world=4, rank=0)
    for transport in ("ring", "ring_pallas", "ring_pallas_q", "ring_rdma"):
        trainer = Trainer(model, optimizer, device="cpu", dp_group=four,
                          grad_sync=GradSyncPolicy(mode="exact_sharded",
                                                   transport=transport))
        summary = trainer.grad_sync_summary()
        assert summary["bucket_widths"] == [26704]
        assert summary["transport_resolved"] == ["ring"]
    # a quantized mode resolves ring_pallas_q to the fused ring: ported
    trainer = Trainer(model, optimizer, device="cpu", dp_group=four,
                      grad_sync=GradSyncPolicy(mode="int8_sharded",
                                               transport="ring_pallas_q"))
    assert trainer.grad_sync_summary()["transport_resolved"] == [
        "ring_pallas_q"]


def test_world_of_one_demotes_to_exact_and_keeps_the_clip():
    from dlrover_tpu_torch.parallel.collectives import GradSyncPolicy

    cfg = LlamaConfig.tiny(dtype=torch.float32)
    trainer = Trainer(LlamaForCausalLM(cfg, device="cpu"),
                      toptim.create_optimizer(grad_clip_norm=None, **OPT),
                      device="cpu", grad_sync=GradSyncPolicy(
                          mode="int8_sharded", clip_norm=0.5))
    assert trainer.grad_sync.mode == "exact"
    assert trainer.grad_sync.clip_norm == 0.5
    in_chain = Trainer(LlamaForCausalLM(cfg, device="cpu"),
                       toptim.create_optimizer(grad_clip_norm=0.5, **OPT),
                       device="cpu")
    state, want = trainer.create_state(), in_chain.create_state()
    assert state.ef_residual is None
    for _ in range(3):
        state, metrics = trainer.train_step(state, _batch())
        want, _ = in_chain.train_step(want, _batch())
    assert metrics["grad_norm"].item() > 0.5  # the clip was active
    # the same clip, computed as g * (c / n) against (g / n) * c
    for n, p in state.params.items():
        torch.testing.assert_close(p, want.params[n], rtol=0, atol=1e-4)


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model, toptim.create_optimizer(**OPT))
