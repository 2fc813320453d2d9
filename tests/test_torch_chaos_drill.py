"""The port's chaos drill against the JAX package's, on the CPU.

Each of the fourteen ported scenarios is ``ok`` with its states on the
CPU, and at seeds 0 and 13 its normalized fault trace, its check names,
its fault count and its incident's phase and chaos point equal the
reference drill's (``data_starved`` included: the sharding client against
the master's shard telemetry, its ledger and its incident; and
``live_reshard``: 4 rank processes shrink dp4 -> dp2 in place against a
restart path of new rank processes).  The waiting scenario
(``fabric_reroute``) raises ``NotImplementedError``
naming its ROADMAP item, an unknown name raises ``KeyError``, the
engine is disarmed after every scenario, and the CLI runs (and refuses
to run without a card unless asked for the CPU).

``cache_cold`` and ``peer_restore`` build a kernel source; here a
stand-in compiler plays nvcc (it sleeps 0.2 s and writes its ``-o``
file).  ``slow_link`` times a probe and ``peer_restore`` compares MTTRs:
the port runs them on :class:`ModelClock`, whose seconds are the sleeps
the drill models and the DELAY faults the plan fired, so a loaded machine
cannot flip them.  The reference drill's own checks of those two read the
wall clock, so only their deterministic outputs are compared."""

import json
import os
import stat
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dlrover_tpu import chaos as jchaos
from dlrover_tpu.diagnosis import chaos_drill as jdrill
from dlrover_tpu_torch import chaos
from dlrover_tpu_torch.diagnosis import chaos_drill as drill
from dlrover_tpu_torch.ops.cuda import _build

ROOT = Path(__file__).resolve().parents[1]
PORTED = list(drill.PORTED)
SEEDS = (0, 13)
REPLAYED = ("torn_shm", "node_flap", "kv_timeout", "heartbeat_loss",
            "slow_link", "hbm_leak", "cache_cold", "peer_restore",
            "data_starved")
#: the reference drill's scenarios whose checks compare wall-clock times
REF_WALL_CLOCK = ("slow_link", "peer_restore", "live_reshard")


class ModelClock:
    """``now()``: the seconds ``sleep`` was asked for, plus the
    ``delay_s`` of every DELAY fault the armed plan has fired."""

    def __init__(self, plan):
        self._t = 0.0
        self._delays = {f.point: f.delay_s for f in plan.faults
                        if f.kind == chaos.DELAY}

    def sleep(self, seconds):
        self._t += seconds

    def now(self):
        return self._t + sum(self._delays.get(r["point"], 0.0)
                             for r in chaos.trace()
                             if r["kind"] == chaos.DELAY)


def fake_compiler(path):
    """A stand-in ``nvcc``: sleeps 0.2 s and writes its ``-o`` file."""
    path.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "time.sleep(0.2)\n"
        "with open(sys.argv[sys.argv.index('-o') + 1], 'w') as f:\n"
        "    f.write('kernel library')\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def run_port(name, seed):
    return drill.run_scenario(
        name, seed, device="cpu",
        clock=ModelClock(chaos.scenario_plan(name, seed)))


def _unlink_segments(scopes):
    """Unlink the segments of ``scopes`` (the reference drill's
    ``peer_restore`` closes its segments before it unlinks them, which
    leaves them in /dev/shm)."""
    from dlrover_tpu_torch.common.multi_process import SharedMemoryBuffer
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import shm_name

    for scope in scopes:
        for pid in range(16):
            segment = SharedMemoryBuffer(shm_name(pid, scope))
            if segment.attach():
                segment.unlink()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every ported scenario at both seeds in both packages (and the
    engine's state after each run of the port's)."""
    out = {}
    compiler = fake_compiler(tmp_path_factory.mktemp("bin") / "nvcc")
    ref_scopes = []
    ref_scope = jdrill._scope
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_build, "nvcc", lambda: compiler)
        mp.setattr(jdrill, "_scope",
                   lambda: ref_scopes.append(ref_scope()) or ref_scopes[-1])
        try:
            for seed in SEEDS:
                for name in PORTED:
                    port = run_port(name, seed)
                    armed_after = chaos.is_active()
                    ref = jdrill.run_scenario(name, seed)
                    out[(name, seed)] = (port, ref, armed_after)
        finally:
            _unlink_segments(ref_scopes)
    chaos.clear()
    jchaos.clear()
    return out


def test_the_eight_scenarios_are_ported():
    assert PORTED == sorted([
        "master_restart", "torn_shm", "storage_stall", "storage_crc",
        "node_flap", "live_reshard", "kv_timeout", "heartbeat_loss",
        "torn_commit", "slow_link", "hbm_leak", "cache_cold",
        "peer_restore", "data_starved"])
    assert drill.INCIDENT_EXPECTATIONS == jdrill.INCIDENT_EXPECTATIONS
    assert set(PORTED) | set(drill.WAITING) == set(jdrill._SCENARIO_BODIES)


@pytest.mark.parametrize("name", PORTED)
def test_scenario_ok_on_the_cpu(runs, name):
    port, _, armed_after = runs[(name, 0)]
    assert port["ok"], (port.get("error"), port["checks"])
    assert port["faults_fired"] >= 1
    assert not armed_after  # the plan is disarmed after every scenario
    phase, point = drill.INCIDENT_EXPECTATIONS[name]
    assert port["incident"]["phase"] == phase
    assert port["incident"]["chaos"]["point"] == point


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", PORTED)
def test_scenario_matches_the_reference_drill(runs, name, seed):
    port, ref, _ = runs[(name, seed)]
    assert port["ok"], (port.get("error"), port["checks"])
    assert ref["ok"] or name in REF_WALL_CLOCK
    assert (drill.normalized_trace(port["trace"])
            == jdrill.normalized_trace(ref["trace"]))
    assert list(port["checks"]) == list(ref["checks"])
    assert port["faults_fired"] == ref["faults_fired"]
    for key in ("kind", "phase"):
        assert port["incident"][key] == ref["incident"][key]
    assert port["incident"]["chaos"] == ref["incident"]["chaos"]


@pytest.mark.parametrize("name", REPLAYED)
def test_replay_at_seed_13_gives_the_same_normalized_trace(
        runs, name, tmp_path, monkeypatch):
    first = drill.normalized_trace(runs[(name, 13)][0]["trace"])
    compiler = fake_compiler(tmp_path / "nvcc")
    monkeypatch.setattr(_build, "nvcc", lambda: compiler)
    again = run_port(name, 13)
    assert again["ok"]
    assert drill.normalized_trace(again["trace"]) == first


@pytest.mark.parametrize("name", sorted(drill.WAITING))
def test_waiting_scenarios_name_their_item(name):
    item = drill.WAITING[name]
    with pytest.raises(NotImplementedError, match=item):
        drill.run_scenario(name, 0, device="cpu")
    assert not chaos.is_active()
    want = {"fabric_reroute": "6d"}[name]
    assert want in item
    assert sorted(drill.WAITING) == ["fabric_reroute"]


def test_unknown_scenario_raises_key_error():
    with pytest.raises(KeyError, match="unknown chaos scenario"):
        drill.run_scenario("meltdown", 0, device="cpu")


def test_run_drill_runs_the_eight(monkeypatch):
    out = drill.run_drill(scenarios=["kv_timeout", "node_flap"], seed=0,
                          device="cpu")
    assert out["ok"] and out["passed"] == 2 and out["failed"] == 0
    assert not chaos.is_active()


def _cli(args, env_extra=None, timeout=180):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "dlrover_tpu_torch.diagnosis.chaos_drill",
         *args],
        cwd=str(ROOT), env=env, capture_output=True, text=True,
        timeout=timeout)


def test_cli_runs_a_scenario_on_the_cpu():
    proc = _cli(["--device", "cpu", "torn_shm"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("CHAOS_DRILL ")]
    assert len(lines) == 1
    result = json.loads(lines[0][len("CHAOS_DRILL "):])
    assert result["ok"] and result["device"] == "cpu"
    assert result["replay_deterministic"] is True
    assert result["scenarios"]["torn_shm"]["faults_fired"] == 1


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the refusal is for a machine without a card")
def test_cli_without_device_raises_without_a_card():
    proc = _cli(["torn_shm"], timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert "CHAOS_DRILL" not in proc.stdout
