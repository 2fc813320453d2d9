"""The port's data-parallel training step (dlrover_tpu_torch/trainer/
train.py with a dp group) on a tiny fp32 Llama, 4 gloo ranks in spawned
processes on the CPU, global batch 8 (2 rows per rank), 3 steps:

* exact_sharded against the port's own single-device step on the same
  global batch;
* exact_sharded, int8_sharded and exact_sharded over the ring_pallas tier
  against the JAX Trainer on a 4-device CPU mesh from the same weights
  (models/convert.py);
* every rank: the error-feedback invariant (contribution = dequant + new
  residual, exactly) and params bit-identical across ranks after every
  step; the other quantized modes and transports track exact_sharded.

Tolerances, set with margin over what was measured (in brackets).  The lr
is 0 at step 0 (warmup), so the params move twice.  exact_sharded against
the single-device step and against JAX differs only in fp32 summation
order (the cross-rank reduce, the norm over shards): losses within 1e-6
relative [0, 9e-8], params within 1e-4 = lr / 10 [1.0e-5, 3.2e-5] and
1e-7 on each leaf's mean [3e-9, 1.1e-8].  The ring_pallas run (buckets of
0.05 MB, so that some widths meet the tier's 1024 rule and some fall back
to the ring) holds the same tolerances against JAX (its per-layer leaves
land in other buckets, and so at other ring positions, than JAX's stacked
ones) and its losses within 1e-5 relative of the port's stock
exact_sharded, the reference's own tolerance between the ring and
psum_scatter (tests/test_grad_overlap.py).  A quantized run differs by its
quantization error, and the port quantizes per-layer [out, in] leaves
where JAX quantizes stacked [L, in, ...] ones, so their blocks differ.
Adam moves each param by about the lr per step whatever the gradient's
size, so a near-zero gradient element quantized differently can move its
param the other way: params within 1.1 * DRIFT, DRIFT = 2 * (sum of the
lrs) [int4: 3.8e-3 of 4.0e-3].  Losses and leaf means: int8 against JAX
within 1e-4 relative [8.4e-6] and 1e-4 [3.3e-5]; int8 runs against the
port's exact_sharded within 2e-4 [4.6e-5] and 1e-4 [3.0e-5]; int4 and
blockwise within 1e-2 [4.0e-3] and 1e-3 [3.3e-4].
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.models.llama import LlamaConfig as JaxLlamaConfig  # noqa: E402
from dlrover_tpu.models.llama import LlamaForCausalLM as JaxLlama  # noqa: E402
from dlrover_tpu.parallel import collectives as jcoll  # noqa: E402
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
from dlrover_tpu_torch.parallel import process_group  # noqa: E402
from dlrover_tpu_torch.trainer import optim as toptim  # noqa: E402
from dlrover_tpu_torch.trainer.train import Trainer  # noqa: E402
from torch_dp_checks import ef_checked_train_worker  # noqa: E402

WORLD, B, S, STEPS = 4, 8, 32, 3
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=100)
LR = OPT["peak_lr"]
CLIP = 1.0
SPAWN_TIMEOUT_S = 120.0
DRIFT = 2 * sum(toptim.cosine_schedule(**OPT)(t) for t in range(STEPS))

# (run name, GradSyncPolicy kwargs); every run starts from the same weights
RUNS = [
    ("exact_sharded", dict(mode="exact_sharded")),
    ("int8_sharded", dict(mode="int8_sharded")),
    ("int8_sharded/ring_pallas_q", dict(mode="int8_sharded",
                                        transport="ring_pallas_q")),
    ("int4_sharded/ring_pallas_q", dict(mode="int4_sharded",
                                        transport="ring_pallas_q")),
    ("blockwise_sharded/ring_pallas_q", dict(mode="blockwise_sharded",
                                             transport="ring_pallas_q")),
    ("int8", dict(mode="int8")),
    ("exact", dict(mode="exact")),
    ("exact_sharded/per_leaf", dict(mode="exact_sharded", bucket_mb=0.0)),
    ("exact_sharded/ring_pallas", dict(mode="exact_sharded", bucket_mb=0.05,
                                       transport="ring_pallas")),
    ("int8_sharded/per_leaf", dict(mode="int8_sharded", bucket_mb=0.0)),
]
QUANTIZED = [name for name, kw in RUNS if not kw["mode"].startswith("exact")]
# the runs held against the JAX Trainer with the same policy
JAX_RUNS = ["exact_sharded", "int8_sharded", "exact_sharded/ring_pallas"]


def _batch():
    ids = np.random.default_rng(0).integers(0, 256, size=(B, S + 1))
    return {"input_ids": ids[:, :-1].astype(np.int32),
            "labels": ids[:, 1:].astype(np.int32)}


def _run_jax(name):
    cfg = JaxLlamaConfig.tiny(dtype=jnp.float32)
    mesh = build_mesh(MeshConfig(dp=WORLD), devices=jax.devices()[:WORLD])
    policy = dict(dict(RUNS)[name])
    policy.setdefault("bucket_mb", 4.0)
    trainer = JaxTrainer(
        JaxLlama(cfg), joptim.create_optimizer(grad_clip_norm=None, **OPT),
        mesh, grad_sync=jcoll.GradSyncPolicy(clip_norm=CLIP, **policy))
    batch = _batch()
    state = trainer.create_state(jax.random.PRNGKey(0), batch["input_ids"])
    init = jax.tree.map(np.asarray, nn.meta.unbox(state.params))
    sharded = trainer.shard_batch(batch)
    losses = []
    for _ in range(STEPS):
        state, metrics = trainer.train_step(state, sharded)
        losses.append(float(metrics["loss"]))
    final = jax.tree.map(np.asarray, nn.meta.unbox(state.params))
    return init, final, np.array(losses)


@pytest.fixture(scope="module")
def runs():
    """The JAX trainer (each run of JAX_RUNS), then every port run in ONE
    spawn of 4 ranks, then the port's single-device step."""
    jax_runs = {name: _run_jax(name) for name in JAX_RUNS}
    init = jax_runs["exact_sharded"][0]
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    state_dict = {k: v.numpy() for k, v in
                  flax_llama_to_state_dict(init, cfg).items()}
    spec = dict(
        preset="tiny", model=dict(dtype=torch.float32),
        state_dict=state_dict, batch=_batch(),
        optimizer=dict(grad_clip_norm=None, **OPT), grads_dtype=None,
        runs=[dict(name=name, steps=STEPS,
                   policy=dict(clip_norm=CLIP, **kw)) for name, kw in RUNS],
        return_params=True)
    ranks = process_group.spawn(ef_checked_train_worker, WORLD, (spec,),
                                device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    # the port on one device, the whole global batch, the clip in the chain
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()})
    single = Trainer(model, toptim.create_optimizer(grad_clip_norm=CLIP,
                                                    **OPT), device="cpu")
    state = single.create_state()
    losses = []
    for _ in range(STEPS):
        state, metrics = single.train_step(state, _batch())
        losses.append(metrics["loss"].item())
    return dict(
        cfg=cfg, ranks=ranks,
        jax={name: run[1:] for name, run in jax_runs.items()},
        single=({n: p.numpy() for n, p in state.params.items()},
                np.array(losses)),
    )


def _port(runs, name):
    record = runs["ranks"][0]["runs"][name]
    return record["params"], np.array(record["loss"])


def _assert_params_close(got, want, max_tol, mean_tol):
    assert set(got) == set(want)
    for n in got:
        diff = np.abs(got[n] - want[n])
        assert diff.max() <= max_tol, (n, diff.max())
        assert diff.mean() <= mean_tol, (n, diff.mean())


def test_exact_sharded_matches_single_device_step(runs):
    params, losses = _port(runs, "exact_sharded")
    want_params, want_losses = runs["single"]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
    _assert_params_close(params, want_params, LR / 10, 1e-7)
    assert losses[-1] < losses[0]  # it trains


@pytest.mark.parametrize("mode", JAX_RUNS)
def test_matches_jax_trainer_on_a_4_device_mesh(runs, mode):
    params, losses = _port(runs, mode)
    jax_final, jax_losses = runs["jax"][mode]
    want = {k: v.numpy() for k, v in
            flax_llama_to_state_dict(jax_final, runs["cfg"]).items()}
    if mode.startswith("exact_sharded"):
        np.testing.assert_allclose(losses, jax_losses, rtol=1e-6)
        _assert_params_close(params, want, LR / 10, 1e-7)
    else:
        np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
        _assert_params_close(params, want, 1.1 * DRIFT, 1e-4)


@pytest.mark.parametrize("name", [n for n, _ in RUNS])
def test_every_rank_agrees_and_keeps_the_ef_invariant(runs, name):
    """Params bit-identical across ranks after every step (a checksum of
    their bits, gathered), the same bucket layout on every rank, and on
    every rank each bucket's contribution equals its dequant plus its new
    residual exactly."""
    records = [r["runs"][name] for r in runs["ranks"]]
    for rec in records:
        assert rec["params_agree"] == [True] * STEPS
        assert rec["loss"] == records[0]["loss"]
        assert np.isfinite(rec["loss"]).all()
    summaries = [rec["summary"] for rec in records]
    assert all(s == summaries[0] for s in summaries)
    bucketed = summaries[0].get("bucketed")
    if name in QUANTIZED and bucketed:
        assert [rec["ef_max_error"] for rec in records] == [0.0] * WORLD
    else:
        assert all(rec["ef_max_error"] is None for rec in records)


@pytest.mark.parametrize("name", QUANTIZED)
def test_quantized_modes_track_exact(runs, name):
    """The quantized runs stay within their quantization error of
    exact_sharded (module docstring): the int8 runs closer than int4 and
    the blockwise mix, whose base codes are int4."""
    exact_params, exact_losses = _port(runs, "exact_sharded")
    params, losses = _port(runs, name)
    int8 = name.startswith("int8")
    np.testing.assert_allclose(losses, exact_losses,
                               rtol=2e-4 if int8 else 1e-2)
    _assert_params_close(params, exact_params, 1.1 * DRIFT,
                         1e-4 if int8 else 1e-3)


def test_sync_summary_names_the_resolved_transports(runs):
    summaries = {name: runs["ranks"][0]["runs"][name]["summary"]
                 for name, _ in RUNS}
    assert summaries["exact_sharded"]["transport_resolved"] == [
        "psum_scatter"]
    assert summaries["int8_sharded"]["transport_resolved"] == ["all_to_all"]
    for name in ("int8_sharded/ring_pallas_q", "int4_sharded/ring_pallas_q",
                 "blockwise_sharded/ring_pallas_q"):
        assert summaries[name]["transport_resolved"] == ["ring_pallas_q"]
        assert summaries[name]["n_buckets"] >= 1
    assert not summaries["exact_sharded/per_leaf"]["bucketed"]
    # tiny buckets: some widths meet ring_pallas's 1024 rule, some ride
    # the ring
    assert summaries["exact_sharded/ring_pallas"]["transport_resolved"] == [
        "ring", "ring_pallas"]
    assert summaries["exact"] == {"mode": "exact", "bucketed": False,
                                  "transport": "auto"}


def test_exact_ring_tracks_stock_exact_sharded(runs):
    """The ring sums in its hop order, the stock reduce-scatter in gloo's:
    the same math to fp32 rounding."""
    params, losses = _port(runs, "exact_sharded/ring_pallas")
    want, want_losses = _port(runs, "exact_sharded")
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _assert_params_close(params, want, LR / 10, 1e-7)


def test_exact_all_reduce_matches_exact_sharded(runs):
    """Plain exact (all-reduce, replicated update) and the ZeRO-1 sharded
    update run the same math."""
    params, losses = _port(runs, "exact")
    want, want_losses = _port(runs, "exact_sharded")
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
    _assert_params_close(params, want, LR / 10, 1e-7)
