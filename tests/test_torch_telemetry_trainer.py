"""The port's ``Trainer`` writing the rank digest, held to the JAX Trainer.

* One process on the CPU: at ``DLROVER_TPU_DIGEST_EVERY=N`` the trainer
  writes ``RUNTIME_METRICS.rank<id>`` every N steps (atomically), with
  the step digest, ``gp_*``, ``mm_*`` / ``mms_*`` and ``js_*``; the memory
  account prices the fp32 masters and the moments exactly and puts the
  bf16 compute copy in ``other``; losses are bitwise equal with every
  hook on and with every hook off.
* 2 gloo ranks (int8_sharded, tiny fp32 Llama, 4 steps, every hook at
  cadence 1: digest, comm probe, bucket chains, memory and compile
  scopes) beside the JAX Trainer on a dp=2 CPU mesh of the same config
  and cadence: the digest files' key sets are equal (``fxl_dp``,
  ``fxb_dp``, ``mm_*``, ``mms_*``, ``gp_*``, ``js_*``, the step keys),
  the probe's latency and bandwidth and every bucket chain's time are
  finite and > 0, the two ranks' files merge by the port's rules as by
  the reference's, and losses are bitwise equal with the hooks on and
  off.
* The memory scope's state plan (``plan_from_state`` over
  ``Trainer.state_axes``, which needs no communication) against the
  reference's (``PartitionSpec``s of the JAX state) on dp=2 x fsdp=2 (4
  ranks) and on int8_sharded dp=2: per chip and repriced at dp=1, equal
  by subsystem, exactly.  The reference's optimizer state holds two 0-d
  int32 counts (adam's and the schedule's) as device arrays; the port
  keeps them as Python ints on the host, which hold no device bytes, so
  the reference's optimizer bytes are compared less those 8 bytes.
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.models.llama import LlamaConfig as JaxLlamaConfig  # noqa: E402
from dlrover_tpu.models.llama import LlamaForCausalLM as JaxLlama  # noqa: E402
from dlrover_tpu.observability import commscope as jcommscope  # noqa: E402
from dlrover_tpu.observability import jitscope as jjitscope  # noqa: E402
from dlrover_tpu.observability import memscope as jmemscope  # noqa: E402
from dlrover_tpu.parallel import collectives as jcoll  # noqa: E402
from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh  # noqa: E402
from dlrover_tpu.trainer import optim as joptim  # noqa: E402
from dlrover_tpu.trainer.train import Trainer as JaxTrainer  # noqa: E402
from dlrover_tpu_torch.models.llama import LlamaConfig  # noqa: E402
from dlrover_tpu_torch.models.llama import LlamaForCausalLM  # noqa: E402
from dlrover_tpu_torch.observability import (  # noqa: E402
    commscope,
    jitscope,
    memscope,
)
from dlrover_tpu_torch.parallel import process_group  # noqa: E402
from dlrover_tpu_torch.trainer import optim as toptim  # noqa: E402
from dlrover_tpu_torch.trainer.train import Trainer  # noqa: E402
from torch_telemetry_checks import telemetry_worker  # noqa: E402

B, S, STEPS = 4, 32, 4
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=100)
SPAWN_TIMEOUT_S = 120.0
INT8 = dict(mode="int8_sharded", clip_norm=1.0, bucket_mb=0.05)
HOOKS_ON = {"DLROVER_TPU_DIGEST_EVERY": "1",
            "DLROVER_TPU_COMM_PROBE_EVERY": "1",
            "DLROVER_TPU_COMM_BUCKET_PROBE": "1",
            "DLROVER_TPU_MEM_SCOPE": "1", "DLROVER_TPU_JITSCOPE": "1"}
HOOKS_OFF = {"DLROVER_TPU_DIGEST_EVERY": "0",
             "DLROVER_TPU_COMM_PROBE_EVERY": "0",
             "DLROVER_TPU_MEM_SCOPE": "0", "DLROVER_TPU_JITSCOPE": "0"}
# the reference's optax counts: two 0-d int32 device arrays
JAX_COUNT_BYTES = 8.0


def _batch():
    ids = np.random.default_rng(0).integers(0, 256, size=(B, S + 1))
    return {"input_ids": ids[:, :-1].astype(np.int32),
            "labels": ids[:, 1:].astype(np.int32)}


class _env:
    """Set env vars for a block, restoring them after."""

    def __init__(self, values):
        self.values = values

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _jax_trainer(axes, grad_sync=None):
    world = int(np.prod(list(axes.values())))
    mesh = build_mesh(MeshConfig(**axes), devices=jax.devices()[:world])
    kw = {"grad_sync": jcoll.GradSyncPolicy(**grad_sync)} if grad_sync else {}
    trainer = JaxTrainer(
        JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32)),
        joptim.create_optimizer(grad_clip_norm=None, **OPT), mesh, **kw)
    state = trainer.create_state(jax.random.PRNGKey(0),
                                 _batch()["input_ids"])
    return trainer, state, mesh


def _jax_per_chip(axes, grad_sync=None):
    """The reference's plan of its state, per chip and at dp=1, its
    optimizer bytes less the counts."""
    _, state, mesh = _jax_trainer(axes, grad_sync)
    counts = sum(float(leaf.nbytes) for leaf in
                 jax.tree_util.tree_leaves(state.opt_state)
                 if getattr(leaf, "ndim", 1) == 0)
    assert counts == JAX_COUNT_BYTES
    plan = jmemscope.plan_from_state(
        state, {str(a): int(s) for a, s in mesh.shape.items()})
    out = []
    for per_chip in (plan.per_chip(), plan.per_chip({"dp": 1})):
        per_chip = dict(per_chip)
        per_chip["optimizer"] -= counts
        out.append(per_chip)
    return out


def _jax_digest(tmp_path):
    """The JAX Trainer's rank-0 digest file on a dp=2 CPU mesh, int8_sharded,
    every hook at cadence 1, STEPS steps."""
    path = str(tmp_path / "jax" / "runtime_metrics.json")
    with _env(dict(HOOKS_ON, DLROVER_TPU_RUNTIME_METRICS_PATH=path,
                   DLROVER_TPU_PROCESS_ID="0")):
        jcommscope.reset_scope()
        jmemscope.reset_scope()
        jjitscope.reset_scope()
        trainer, state, _ = _jax_trainer({"dp": 2}, INT8)
        batch = trainer.shard_batch(_batch())
        for _ in range(STEPS):
            state, _ = trainer.train_step(state, batch)
    with open(path + ".rank0") as f:
        return json.load(f)


def _spec(runs):
    return dict(preset="tiny", model=dict(dtype=torch.float32),
                state_dict=None, seed=0, batch=_batch(),
                optimizer=dict(grad_clip_norm=None, **OPT),
                grads_dtype=None, steps=STEPS, runs=runs)


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    """2 gloo ranks: int8_sharded with every hook on, then off, from the
    same weights; and the JAX Trainer's digest of the same config."""
    tmp = tmp_path_factory.mktemp("telemetry")
    runs = [dict(name=name, policy=INT8, env=dict(
        env, DLROVER_TPU_RUNTIME_METRICS_PATH=str(
            tmp / name / "runtime_metrics.json")))
            for name, env in (("on", HOOKS_ON), ("off", HOOKS_OFF))]
    ranks = process_group.spawn(telemetry_worker, 2, (_spec(runs),),
                                device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    return ranks, _jax_digest(tmp)


def test_digest_key_set_matches_the_reference(dp2):
    ranks, jax_digest = dp2
    want = set(jax_digest)
    assert {"fxl_dp", "fxb_dp", "last_step", "gp_compute", "mms_params",
            "js_hits"} <= want
    for rank in ranks:
        digest = rank["on"]["digest"]
        assert set(digest) == want
        assert digest["last_step"] == STEPS - 1
        for key in ("fxl_dp", "fxb_dp"):
            assert np.isfinite(digest[key]) and digest[key] > 0, key
        assert digest["mm_used_b"] == sum(
            digest[memscope.DIGEST_SUB + s] for s in memscope.SUBSYSTEMS)
        assert "digest" not in rank["off"]


def test_losses_are_bitwise_equal_with_the_hooks_on_and_off(dp2):
    ranks, _ = dp2
    for rank in ranks:
        assert len(rank["on"]["loss"]) == STEPS
        assert rank["on"]["loss"] == rank["off"]["loss"]
        assert rank["on"]["telemetry_s"] > 0
    assert ranks[0]["on"]["loss"] == ranks[1]["on"]["loss"]


def test_bucket_chains_are_timed_on_every_probe(dp2):
    """Every digest step after the first step probes (cadence 1): each
    bucket's chain is timed once a probe, on every rank."""
    ranks, _ = dp2
    for rank in ranks:
        rows = rank["on"]["buckets"]
        buckets = sorted({int(r["width"]) for r in rows})
        assert len(buckets) > 1
        probes = STEPS - 1
        assert len(rows) % probes == 0
        for row in rows:
            assert np.isfinite(row["chain_ms"]) and row["chain_ms"] > 0
            assert row["gbps"] > 0 and row["wire_bytes"] > 0
            assert row["axis"] == "dp"
        assert rank["off"]["buckets"] == []


def test_rank_files_merge_as_the_reference_merges_them(dp2):
    ranks, _ = dp2
    files = [r["on"]["digest"] for r in ranks]
    port, ref = {}, {}
    for f in files:
        memscope.merge_digest(port, f)
        jitscope.merge_digest(port, f)
        commscope.merge_digest(port, f)
        jmemscope.merge_digest(ref, f)
        jjitscope.merge_digest(ref, f)
    for f in files:  # the reference's agent merges the fabric inline
        for key, value in f.items():
            if key.startswith(jcommscope.DIGEST_LAT):
                ref[key] = max(ref.get(key, 0.0), float(value))
            elif key.startswith(jcommscope.DIGEST_BW):
                ref[key] = min(ref.get(key, float(value)), float(value))
    assert port == ref
    assert port["fxl_dp"] == max(f["fxl_dp"] for f in files)
    assert port["fxb_dp"] == min(f["fxb_dp"] for f in files)
    assert port["mm_rss_b"] == sum(f["mm_rss_b"] for f in files)


def test_int8_sharded_plan_matches_the_reference(dp2):
    ranks, _ = dp2
    want, want_dp1 = _jax_per_chip({"dp": 2}, INT8)
    assert want["ef_residual"] > 0
    for rank in ranks:
        assert rank["on"]["per_chip"] == want
        assert rank["on"]["per_chip_dp1"] == want_dp1


def test_dp2_fsdp2_plan_matches_the_reference():
    want, want_dp1 = _jax_per_chip({"dp": 2, "fsdp": 2})
    runs = [dict(name="mesh", axes=dict(dp=2, fsdp=2), steps=0)]
    ranks = process_group.spawn(telemetry_worker, 4, (_spec(runs),),
                                device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    assert want["params"] < want_dp1["params"] * 2
    for rank in ranks:
        assert rank["mesh"]["per_chip"] == want
        assert rank["mesh"]["per_chip_dp1"] == want_dp1


# -- one process -------------------------------------------------------------


def _single(grads_dtype=torch.bfloat16):
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32),
                             device="cpu")
    trainer = Trainer(
        model, toptim.create_optimizer(moment_dtype=torch.bfloat16, **OPT),
        grads_dtype=grads_dtype, device="cpu")
    return trainer, trainer.create_state(), model.num_params()


def test_the_digest_file_every_n_steps(tmp_path, monkeypatch):
    base = str(tmp_path / "rm.json")
    monkeypatch.setenv("DLROVER_TPU_RUNTIME_METRICS_PATH", base)
    monkeypatch.setenv("DLROVER_TPU_DIGEST_EVERY", "2")
    monkeypatch.setenv("DLROVER_TPU_PROCESS_ID", "3")
    memscope.reset_scope()
    trainer, state, n = _single()
    seen = []
    for _ in range(6):
        state, _ = trainer.train_step(state, _batch())
        path = base + ".rank3"
        seen.append(json.load(open(path))["last_step"]
                    if os.path.exists(path) else None)
    # the first step is the reference's first dispatch: steps count from
    # the second, and the file moves every 2 of them
    assert seen == [None, None, 2.0, 2.0, 4.0, 4.0]
    assert os.listdir(tmp_path) == ["rm.json.rank3"]
    digest = json.load(open(base + ".rank3"))
    assert {k for k in digest if not k.startswith(("gp_", "js_", "mm"))} \
        == {"last_step", "step_p50_s", "step_max_s", "steps", "ts"}
    assert not any(k.startswith(("fxl_", "fxb_")) for k in digest)
    # the masters in fp32, the moments in bf16 (two of them), the bf16
    # compute copy the model holds in other
    assert digest["mms_params"] == 4.0 * n
    assert digest["mms_optimizer"] == 2 * 2.0 * n
    assert digest["mms_other"] >= 2.0 * n
    assert digest["mm_used_b"] == sum(
        digest[memscope.DIGEST_SUB + s] for s in memscope.SUBSYSTEMS)


def test_losses_bitwise_equal_with_every_hook_on_and_off(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_RUNTIME_METRICS_PATH",
                       str(tmp_path / "rm.json"))
    losses = {}
    for name, env in (("on", HOOKS_ON), ("off", HOOKS_OFF)):
        with _env(env):
            torch.manual_seed(0)
            trainer, state, _ = _single()
            out = []
            for _ in range(3):
                state, metrics = trainer.train_step(state, _batch())
                out.append(metrics["loss"].item())
            losses[name] = out
    assert losses["on"] == losses["off"]


def test_a_broken_hook_never_breaks_a_step(tmp_path, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_DIGEST_EVERY", "1")
    # a digest path that cannot be written, a sampler that raises
    (tmp_path / "file").write_text("")
    monkeypatch.setenv("DLROVER_TPU_RUNTIME_METRICS_PATH",
                       str(tmp_path / "file" / "rm.json"))
    memscope.reset_scope(stats_reader=lambda: 1 / 0)
    trainer, state, _ = _single(grads_dtype=None)
    for _ in range(3):
        state, metrics = trainer.train_step(state, _batch())
    assert np.isfinite(metrics["loss"].item())
    memscope.reset_scope()


def test_state_axes_on_one_device_and_the_engine_provider(tmp_path):
    from dlrover_tpu_torch.trainer.flash_checkpoint import Checkpointer

    trainer, state, _ = _single()
    assert trainer.state_axes(state) == {}
    assert trainer.mesh_axes() is None
    sc = memscope.reset_scope()
    sc.bind_device("cpu")
    ckpt = Checkpointer(str(tmp_path / "ckpt"), scope=f"tele{os.getpid()}",
                        device="cpu")
    try:
        names = [k for k in sc._host_providers if k.startswith("ckpt_shm:")]
        assert len(names) == 1
        assert sc.sample()["host"]["shm"][names[0]] == 0.0  # not mapped
        ckpt.save_checkpoint(1, state)  # a memory save
        assert sc.sample()["host"]["shm"][names[0]] > 0
    finally:
        ckpt.engine.unlink_memory()
        ckpt.close()
    assert not [k for k in sc._host_providers if k.startswith("ckpt_shm:")]
    memscope.reset_scope()


def test_bootstrap_installs_the_compile_hook(monkeypatch):
    from dlrover_tpu_torch.ops.cuda import _build
    from dlrover_tpu_torch.trainer import bootstrap

    monkeypatch.setattr(bootstrap, "_worker_ctx", None)
    bootstrap.init(platform="cpu")
    assert jitscope._installed
    assert jitscope._on_build in _build._listeners
