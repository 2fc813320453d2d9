"""The port's live reshard (dlrover_tpu_torch/parallel/reshard.py) held to
the JAX package's (dlrover_tpu/parallel/reshard.py).

* ``plan_reshard``: the refusals and the fit gate give the reference's
  verdicts on the cases of ``tests/test_reshard.py``;
* the agent-trainer handshake round-trips as the reference's does, and
  each package's poll reads the other's staging file;
* the non-power-of-two partial reads (dp4 -> dp3, dp3 -> dp5) over a
  sealed manifest the JAX package wrote: the port's engine reads the same
  slices and bytes as the reference's, whole shards under CRC
  verification, and refuses a corrupted shard;
* the live transitions: the JAX ``Trainer`` on 4 of the 8 virtual CPU
  devices trains two ``int8_sharded`` steps on a tiny Llama, and its
  state (params, Adam moments, error-feedback rows; converted to the
  port's leaves with ``models/convert.py``) starts the port's 4 gloo rank
  processes.  Both packages then run the reference smoke's transitions
  in order: the donor leg (dp4 -> dp2, survivors {0, 1}, the departed
  shards read off each package's own sealed manifest), the grow back to
  dp4, the planned shrink with every replica surviving, the grow again,
  and one step.  A transition only moves bytes and redistributes the
  residual totals with the same numpy sum, so the port's params, moments
  and residuals equal the reference's exactly after every transition,
  which is inside the int8_sharded tolerance tests/test_torch_train_dp.py
  states; the donor leg reads the reference's byte count; and the step
  after it tracks the reference's loss within that file's 1e-4 relative;
* the step cadence across a live grow (port only): a staged grow, which
  nothing starts joiners for, is refused at the step boundary with the
  world left as it was; after a grow whose survivors had stepped more
  than its joiners, the poll's all-reduce and the comm probe on every
  second step keep every rank in step, and a staged re-layout applies on
  all four at once;
* the port's reshard smoke on the CPU (``parallel/reshard_smoke.py``): the
  live result bit-exact against the port's own restart path
  (``Trainer.load_state``), the grow against the original state, the
  ledger's ``live_reshard`` > 0 and ``rendezvous_restart`` = 0.
"""

import contextlib
import os
import tempfile
from typing import Dict, Optional

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.master.ckpt_coordinator import (  # noqa: E402
    CkptCommitCoordinator,
)
from dlrover_tpu.models.llama import LlamaConfig as JaxLlamaConfig  # noqa: E402
from dlrover_tpu.models.llama import LlamaForCausalLM as JaxLlama  # noqa: E402
from dlrover_tpu.parallel import collectives as jcoll  # noqa: E402
from dlrover_tpu.parallel import reshard as jreshard  # noqa: E402
from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh  # noqa: E402
from dlrover_tpu.trainer import optim as joptim  # noqa: E402
from dlrover_tpu.trainer.flash_checkpoint import (  # noqa: E402
    distributed as jdist,
)
from dlrover_tpu.trainer.train import Trainer as JaxTrainer  # noqa: E402
from dlrover_tpu_torch.models.convert import (  # noqa: E402
    flax_llama_to_state_dict,
)
from dlrover_tpu_torch.models.llama import LlamaConfig  # noqa: E402
from dlrover_tpu_torch.parallel import process_group  # noqa: E402
from dlrover_tpu_torch.parallel import reshard  # noqa: E402
from dlrover_tpu_torch.parallel import reshard_smoke  # noqa: E402
from dlrover_tpu_torch.trainer.flash_checkpoint import (  # noqa: E402
    distributed as pdist,
)
from torch_reshard_checks import (  # noqa: E402
    assemble,
    cadence_worker,
    parity_worker,
)

WORLD, SHRUNK, STEPS = 4, 2, 2
OPT = dict(peak_lr=1e-2, warmup_steps=1, total_steps=100)
CLIP = 1.0
LOSS_RTOL = 1e-4  # int8 against JAX, tests/test_torch_train_dp.py
SPAWN_TIMEOUT_S = 180.0
LEGS = ("donor", "grow", "shrink", "grow_again")


@contextlib.contextmanager
def _env(**overrides: str):
    saved: Dict[str, Optional[str]] = {}
    for key, value in overrides.items():
        saved[key] = os.environ.get(key)
        os.environ[key] = value
    try:
        yield
    finally:
        for key, old in saved.items():
            if old is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = old


@pytest.fixture(autouse=True)
def _clean():
    for pkg in (jreshard, reshard):
        pkg.register_reshard_target(None)
    jdist.set_commit_client(None)
    pdist.set_commit_client(None)
    yield
    for pkg in (jreshard, reshard):
        pkg.register_reshard_target(None)
    jdist.set_commit_client(None)
    pdist.set_commit_client(None)


# -- plan_reshard -------------------------------------------------------------

# (old, new, survivors, env, the refusal's message or None)
PLANS = {
    "empty_target": ({"dp": 4}, {}, None, {}, "empty"),
    "non_positive_axis": ({"dp": 4}, {"dp": 0}, None, {}, "non-positive"),
    "no_survivors": ({"dp": 4}, {"dp": 2}, [], {}, "surviving"),
    "out_of_world": ({"dp": 4}, {"dp": 2}, [0, 7], {}, r"ranks \[7\]"),
    "default_survivors": ({"dp": 4}, {"dp": 3}, None,
                          {"DLROVER_TPU_RESHARD_FIT_GATE": "0"}, None),
    "gate_off": ({"dp": 4}, {"dp": 2}, [0, 1],
                 {"DLROVER_TPU_RESHARD_FIT_GATE": "0"}, None),
    "unknown_fit_passes": ({"dp": 4}, {"dp": 2}, None, {}, None),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_plan_gives_the_reference_verdict(case):
    old, new, survivors, env, refusal = PLANS[case]
    with _env(**env):
        if refusal is not None:
            with pytest.raises(jreshard.ReshardRefused, match=refusal):
                jreshard.plan_reshard(old, new, survivors=survivors)
            with pytest.raises(reshard.ReshardRefused, match=refusal):
                reshard.plan_reshard(old, new, survivors=survivors)
            return
        want = jreshard.plan_reshard(old, new, survivors=survivors)
        got = reshard.plan_reshard(old, new, survivors=survivors)
    assert got.to_dict().keys() == want.to_dict().keys()
    assert (got.old_axes, got.new_axes, got.survivors) == (
        want.old_axes, want.new_axes, want.survivors)
    assert bool(got.fit) == bool(want.fit)
    assert got.fit.get("fits") == want.fit.get("fits")


def test_measured_no_fit_is_refused(monkeypatch):
    """A measured verdict that the target does not fit refuses the plan in
    both packages; an unknown one passes."""
    verdict = {"fits": False, "reason": "projected 90 GB > budget 73 GB"}
    for pkg, memscope in (
            (jreshard, "dlrover_tpu.observability.memscope"),
            (reshard, "dlrover_tpu_torch.observability.memscope")):
        monkeypatch.setattr(f"{memscope}.fit_report", lambda plan: verdict)
        with pytest.raises(pkg.ReshardRefused, match="measured fit gate"):
            pkg.plan_reshard({"dp": 4}, {"dp": 2})


def test_plan_outside_the_dp_axis_is_refused_by_the_port():
    """The port re-lays the dp axis of a pure data-parallel mesh only."""
    with pytest.raises(reshard.ReshardRefused, match="dp axis"):
        reshard.mesh_for_axes({"dp": 2, "fsdp": 2})


# -- the handshake --------------------------------------------------------------


class _Holder:
    def __init__(self):
        self.staged = []

    def stage_live_reshard(self, axes, reason=""):
        self.staged.append((dict(axes), reason))


@pytest.mark.parametrize("pkg", [jreshard, reshard], ids=["jax", "port"])
def test_in_process_target_applies_directly(pkg, tmp_path):
    holder = _Holder()
    pkg.register_reshard_target(holder)
    with _env(DLROVER_TPU_RUNTIME_METRICS_PATH=str(tmp_path / "rt.json")):
        assert pkg.stage_reshard_request(
            {"dp": 2}, reason="brain scale plan") == "applied"
    assert holder.staged == [({"dp": 2}, "brain scale plan")]


@pytest.mark.parametrize("pkg", [jreshard, reshard], ids=["jax", "port"])
def test_staging_file_round_trips(pkg, tmp_path):
    with _env(DLROVER_TPU_RUNTIME_METRICS_PATH=str(tmp_path / "rt.json")):
        assert pkg.staged_seq() == 0
        assert pkg.stage_reshard_request({"dp": 3},
                                         reason="node left") == "staged"
        req = pkg.staged_request()
        assert req["axes"] == {"dp": 3} and req["seq"] == 1
        pkg.stage_reshard_request({"dp": 2})
        assert pkg.staged_seq() == 2


@pytest.mark.parametrize("writer,reader", [(jreshard, reshard),
                                           (reshard, jreshard)],
                         ids=["jax_to_port", "port_to_jax"])
def test_poll_baselines_then_applies_only_newer(writer, reader, tmp_path):
    """Each package's poll reads the other's staging file: a file older
    than the trainer only baselines it, a newer request is staged."""
    holder = _Holder()
    with _env(DLROVER_TPU_RUNTIME_METRICS_PATH=str(tmp_path / "rt.json")):
        writer.stage_reshard_request({"dp": 2}, reason="stale")
        seq = reader.poll_staged_reshard(holder, None)
        assert seq == 1 and holder.staged == []
        assert reader.poll_staged_reshard(holder, seq) == 1
        assert holder.staged == []
        writer.stage_reshard_request({"dp": 3}, reason="fresh")
        assert reader.poll_staged_reshard(holder, seq) == 2
    assert holder.staged == [({"dp": 3}, "fresh")]


def test_poll_applies_the_agreed_sequence(tmp_path):
    """Over a world the ranks apply the smallest sequence every rank has
    read, so a request one rank has not seen yet waits for it."""
    holder = _Holder()
    with _env(DLROVER_TPU_RUNTIME_METRICS_PATH=str(tmp_path / "rt.json")):
        seq = reshard.poll_staged_reshard(holder, None)
        reshard.stage_reshard_request({"dp": 2}, reason="new")
        assert reshard.poll_staged_reshard(holder, seq,
                                           agree=lambda s: 0) == 0
        assert holder.staged == []
        assert reshard.poll_staged_reshard(holder, 0,
                                           agree=lambda s: s) == 1
    assert holder.staged == [({"dp": 2}, "new")]


@pytest.mark.parametrize("pkg", [jreshard, reshard], ids=["jax", "port"])
def test_dead_target_is_not_kept_alive(pkg):
    holder = _Holder()
    pkg.register_reshard_target(holder)
    assert pkg.reshard_target() is holder
    del holder
    assert pkg.reshard_target() is None


# -- non-power-of-two partial reads over the reference's manifest --------------


def _row_sharded_dir(tmp_path, rows: int, cols: int, num_shards: int):
    """One (rows, cols) float32 leaf the JAX engine commits as
    ``num_shards`` even row blocks."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:num_shards]), ("x",))
    arr = jax.device_put(
        jnp.arange(rows * cols, dtype=jnp.float32).reshape(rows, cols),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("x")))
    ckpt_dir = str(tmp_path / "ckpt")
    engine = jdist.DistributedCheckpointEngine(
        ckpt_dir, process_id=0, num_processes=1,
        client=jdist.LocalCommitClient())
    assert engine.save(1, {"w": arr}, wait_seal=True, timeout=30)["sealed"]
    return ckpt_dir, np.asarray(arr)


# (rows, shards, the reader's row block, verify) per case of the reference
PARTIAL = {
    "dp4_to_dp3_straddles_two_shards": (12, 4, (4, 8), "off"),
    "dp4_to_dp3_first_rank": (12, 4, (0, 4), "off"),
    "dp4_to_dp3_last_rank": (12, 4, (8, 12), "off"),
    "dp3_to_dp5_interior": (15, 3, (6, 9), "off"),
    "dp3_to_dp5_straddling": (15, 3, (9, 12), "off"),
    "verifying_whole_shards": (12, 4, (4, 8), None),
}


@pytest.mark.parametrize("case", list(PARTIAL))
def test_partial_reads_match_the_reference_engine(case, tmp_path):
    rows, shards, (lo, hi), verify = PARTIAL[case]
    ckpt_dir, full = _row_sharded_dir(tmp_path, rows, 64, shards)
    env = {} if verify is None else {"DLROVER_TPU_VERIFY_CRC": verify}
    with _env(**env):
        want_stats = {"bytes_read": 0, "shards_fetched": 0}
        want = jdist.DistributedCheckpointEngine(
            ckpt_dir, process_id=0, num_processes=1).read_slice(
                "w", (slice(lo, hi), slice(0, 64)), stats=want_stats)
        got_stats = {"bytes_read": 0, "shards_fetched": 0}
        got = pdist.DistributedCheckpointEngine(ckpt_dir).read_slice(
            "w", (slice(lo, hi), slice(0, 64)), stats=got_stats)
    assert np.array_equal(got.numpy(), full[lo:hi])
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got_stats == want_stats


def test_dp4_to_dp3_every_rank_covered_once(tmp_path):
    ckpt_dir, full = _row_sharded_dir(tmp_path, 12, 64, 4)
    reader = pdist.DistributedCheckpointEngine(ckpt_dir)
    rebuilt, total = np.zeros_like(full), 0
    with _env(DLROVER_TPU_VERIFY_CRC="off"):
        for rank in range(3):
            stats = {"bytes_read": 0, "shards_fetched": 0}
            rebuilt[rank * 4:(rank + 1) * 4] = reader.read_slice(
                "w", (slice(rank * 4, (rank + 1) * 4), slice(0, 64)),
                stats=stats).numpy()
            assert stats["bytes_read"] == 4 * 64 * 4
            total += stats["bytes_read"]
    assert np.array_equal(rebuilt, full)
    assert total == full.nbytes


def test_corruption_under_resize_detected_by_crc(tmp_path):
    ckpt_dir, _ = _row_sharded_dir(tmp_path, 12, 64, 4)
    rec = jdist.read_manifest(ckpt_dir, 1)["leaves"][0]["shards"][1]
    with open(os.path.join(ckpt_dir, rec["file"]), "r+b") as f:
        f.seek(rec["offset"] + rec["nbytes"] // 2)
        f.write(b"\xff")
    with pytest.raises(OSError, match="checksum"):
        pdist.DistributedCheckpointEngine(ckpt_dir).read_slice(
            "w", (slice(4, 8), slice(0, 64)),
            stats={"bytes_read": 0, "shards_fetched": 0})


# -- the live transitions against the JAX Trainer ---------------------------------


def _batch():
    ids = np.random.default_rng(7).integers(0, 256, size=(8, 33))
    return {"input_ids": ids[:, :-1].astype(np.int32),
            "labels": ids[:, 1:].astype(np.int32)}


def _adam(opt_state):
    return opt_state[0][0]


def _host(state) -> Dict:
    """A JAX TrainState's leaves on the host: params and moments unboxed,
    the counts, the residual stacks by key."""
    def tree(t):
        return jax.tree.map(np.asarray, nn.meta.unbox(t))

    adam = _adam(state.opt_state)
    return {
        "params": tree(state.params), "mu": tree(adam.mu),
        "nu": tree(adam.nu), "adam_count": int(adam.count),
        "sched_count": int(state.opt_state[0][2].count),
        "step": int(state.step),
        "ef": {k: np.asarray(v) for k, v in state.ef_residual.items()},
    }


def _nested(flat: Dict[str, np.ndarray]) -> Dict:
    out: Dict = {}
    for key, value in flat.items():
        parts = key.replace("/.value", "").split("/")
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out


def _to_port(host: Dict, cfg) -> Dict:
    """The JAX state in the port's leaves: whole leaves by path, and each
    replica's residual row (``ef_rows``)."""
    def named(tree):
        return {n: t.numpy() for n, t in
                flax_llama_to_state_dict(tree, cfg).items()}

    whole = {f"params/{n}": v for n, v in named(host["params"]).items()}
    for mom in ("mu", "nu"):
        whole.update({f"opt_state/0/0/{mom}/{n}": v
                      for n, v in named(host[mom]).items()})
    whole.update({"opt_state/0/0/count": host["adam_count"],
                  "opt_state/0/2/count": host["sched_count"],
                  "step": host["step"]})
    world = next(iter(host["ef"].values())).shape[0]
    rows = [{f"ef_residual/{n}": v for n, v in named(_nested(
        {k: v[r] for k, v in host["ef"].items()})).items()}
        for r in range(world)]
    return {"whole": whole, "ef_rows": rows}


@pytest.fixture(scope="module")
def legs():
    """The JAX Trainer's transitions on 4 of the 8 virtual devices, and
    the port's on 4 gloo ranks from the same start."""
    cfg = JaxLlamaConfig.tiny(num_kv_heads=4, dtype=jnp.float32)
    cfg_t = LlamaConfig.tiny(num_kv_heads=4, dtype=torch.float32)
    batch = _batch()
    devices = jax.devices()[:WORLD]
    trainer = JaxTrainer(
        JaxLlama(cfg), joptim.create_optimizer(grad_clip_norm=None, **OPT),
        build_mesh(MeshConfig(dp=WORLD), devices=devices),
        grad_sync=jcoll.GradSyncPolicy(mode="int8_sharded", clip_norm=CLIP))
    state = trainer.create_state(jax.random.PRNGKey(0), batch["input_ids"])
    sharded = trainer.shard_batch(batch)
    for _ in range(STEPS):
        state, _ = trainer.train_step(state, sharded)
    start = _to_port(_host(state), cfg_t)
    with tempfile.TemporaryDirectory(prefix="reshard_parity_") as root:
        donor = jdist.DistributedCheckpointEngine(
            os.path.join(root, "jax_donor"), process_id=0, num_processes=1,
            client=jdist.LocalCommitClient(CkptCommitCoordinator()))
        assert donor.save(STEPS, state, wait_seal=True)["sealed"]
        jax_legs, jax_reports = {}, {}
        sample = batch["input_ids"]
        for leg, axes, survivors in (("donor", {"dp": SHRUNK}, (0, 1)),
                                     ("grow", {"dp": WORLD}, None),
                                     ("shrink", {"dp": SHRUNK}, None),
                                     ("grow_again", {"dp": WORLD}, None)):
            state, jax_reports[leg] = trainer.live_reshard(
                state, axes, sample_input=sample, survivors=survivors,
                donor=donor)
            jax_legs[leg] = _to_port(_host(state), cfg_t)
        state, metrics = trainer.train_step(state,
                                            trainer.shard_batch(batch))
        spec = dict(
            preset="tiny", model=dict(num_kv_heads=4, dtype=torch.float32),
            state_dict=None, batch=batch, root=root,
            optimizer=dict(grad_clip_norm=None, **OPT),
            policy=dict(mode="int8_sharded", clip_norm=CLIP),
            start=start["whole"], ef_rows=start["ef_rows"])
        ranks = process_group.spawn(parity_worker, WORLD, (spec,),
                                    device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    return dict(jax=jax_legs, jax_reports=jax_reports,
                jax_loss=float(metrics["loss"]), ranks=ranks,
                port={leg: assemble(ranks, leg) for leg in LEGS})


@pytest.mark.parametrize("leg", LEGS)
@pytest.mark.parametrize("part", ["params", "opt_state", "step"])
def test_transition_matches_the_reference(legs, leg, part):
    got, want = legs["port"][leg]["whole"], legs["jax"][leg]["whole"]
    names = sorted(p for p in want if p.startswith(part))
    assert names and names == sorted(p for p in got if p.startswith(part))
    for path in names:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


@pytest.mark.parametrize("leg", LEGS)
def test_residual_rows_match_the_reference(legs, leg):
    got, want = legs["port"][leg]["ef_rows"], legs["jax"][leg]["ef_rows"]
    assert len(got) == len(want)
    for rank, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for path in w:
            np.testing.assert_array_equal(g[path], w[path],
                                          err_msg=f"rank {rank} {path}")


def test_donor_leg_reads_the_reference_bytes(legs):
    """The departed moment blocks and residual rows are half the moments
    and half the rows in both layouts: the port reads as many bytes off
    its manifest as the reference reads off its own."""
    port = legs["ranks"][0]["legs"]["donor"]["report"]
    want = legs["jax_reports"]["donor"]["donor_bytes_read"]
    assert port["donor_bytes_read"] == want > 0
    for leg in ("grow", "shrink", "grow_again"):
        assert legs["ranks"][0]["legs"][leg]["report"][
            "donor_bytes_read"] == 0


def test_bucket_signature_is_rebuilt_per_degree(legs):
    """The grow gets back the dp4 layout's signature, the shrink the dp2
    one: the same on every rank of a world."""
    sigs = {leg: {r["legs"][leg]["report"]["bucket_signature"]
                  for r in legs["ranks"] if leg in r["legs"]}
            for leg in LEGS}
    assert all(len(s) == 1 for s in sigs.values()), sigs
    assert sigs["grow"] == sigs["grow_again"]
    assert sigs["donor"] == sigs["shrink"] != sigs["grow"]


def test_step_after_the_transitions_tracks_the_reference(legs):
    losses = [r["loss"] for r in legs["ranks"]]
    assert len(set(losses)) == 1
    np.testing.assert_allclose(losses[0], legs["jax_loss"], rtol=LOSS_RTOL)


# -- the port's own smoke: live against restart -----------------------------------


@pytest.fixture(scope="module")
def smoke():
    return reshard_smoke.run_smoke("cpu", timeout_s=SPAWN_TIMEOUT_S)


SMOKE_CHECKS = (
    "donor_sealed", "baseline_saved", "donor_partial_reads",
    "restart_restored", "donor_bit_exact", "refused_without_donor",
    "world_kept_after_refusal", "grow_params_bit_exact",
    "grow_moments_bit_exact", "grow_ef_totals_exact",
    "bucket_signature_stable", "shrink_bit_exact", "shrink_zero_donor_bytes",
    "next_loss_bitwise_restart", "post_reshard_step_finite",
    "ledger_live_reshard_priced", "ledger_zero_rendezvous",
)


@pytest.mark.parametrize("check", SMOKE_CHECKS)
def test_smoke_check_passes_on_every_rank_that_runs_it(smoke, check):
    ran = {k: v for k, v in smoke["checks"].items()
           if k.split(".", 1)[1] == check}
    assert ran and all(ran.values()), ran


def test_smoke_prices_the_live_path(smoke):
    assert smoke["ok"]
    assert smoke["live_reshard_s"] > 0 and smoke["ledger_live_reshard_s"] > 0
    assert smoke["loss_live_next"] == smoke["loss_restart_next"]
    assert 0 < smoke["donor_bytes_read"]



# -- the step cadence across a live grow (port only) ----------------------------

CADENCE_STEPS = 5


@pytest.fixture(scope="module")
def cadence(tmp_path_factory):
    spec = dict(
        preset="tiny", model=dict(num_kv_heads=4, dtype=torch.float32),
        state_dict=None, batch=_batch(),
        optimizer=dict(grad_clip_norm=None, **OPT),
        policy=dict(mode="int8_sharded", clip_norm=CLIP),
        steps=CADENCE_STEPS)
    root = tmp_path_factory.mktemp("cadence")
    with _env(DLROVER_TPU_DIGEST_EVERY="2",
              DLROVER_TPU_COMM_PROBE_EVERY="2",
              DLROVER_TPU_RUNTIME_METRICS_PATH=str(root / "rt.json")):
        return process_group.spawn(cadence_worker, WORLD, (spec,),
                                   device="cpu", timeout_s=SPAWN_TIMEOUT_S)


def test_staged_grow_is_refused_with_the_world_kept(cadence):
    """Nothing starts a staged grow's joiners: the step boundary refuses
    it before the world changes, and the two ranks train on."""
    seen = [r["grow_refused"] for r in cadence if "grow_refused" in r]
    assert len(seen) == SHRUNK
    for r in seen:
        assert r["world"] == SHRUNK and r["generation_kept"]
        assert r["axes"]["dp"] == SHRUNK and r["step"] == 7
        assert r["watermark"] == 1


def test_cadence_collectives_stay_in_step_after_a_grow(cadence):
    """Survivors that stepped 7 times and joiners that stepped none poll
    and probe at the same steps after the grow, and apply the staged
    re-layout together: every rank finishes with the same losses."""
    assert sorted(r["rank"] for r in cadence) == list(range(WORLD))
    tails = {tuple(r["losses"][-CADENCE_STEPS:]) for r in cadence}
    assert len(tails) == 1 and all(np.isfinite(list(tails)[0]))
    for r in cadence:
        assert r["joined_at_step"] == 7
        assert r["world"] == WORLD and r["axes"]["dp"] == WORLD
        assert r["step"] == 7 + CADENCE_STEPS
        assert r["relayout_applied"] == 2
