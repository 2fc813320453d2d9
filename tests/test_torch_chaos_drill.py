"""The port's chaos drill against the JAX package's, on the CPU.

Each of the eight ported scenarios is ``ok`` with its states on the CPU,
and at seeds 0 and 13 its normalized fault trace, its check names, its
fault count and its incident's phase and chaos point equal the reference
drill's.  The seven waiting scenarios raise ``NotImplementedError``
naming their ROADMAP item, an unknown name raises ``KeyError``, the
engine is disarmed after every scenario, and the CLI runs (and refuses
to run without a card unless asked for the CPU)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dlrover_tpu import chaos as jchaos
from dlrover_tpu.diagnosis import chaos_drill as jdrill
from dlrover_tpu_torch import chaos
from dlrover_tpu_torch.diagnosis import chaos_drill as drill

ROOT = Path(__file__).resolve().parents[1]
PORTED = list(drill.PORTED)
SEEDS = (0, 13)
REPLAYED = ("torn_shm", "node_flap", "kv_timeout", "heartbeat_loss")


@pytest.fixture(scope="module")
def runs():
    """Every ported scenario at both seeds in both packages (and the
    engine's state after each run of the port's)."""
    out = {}
    for seed in SEEDS:
        for name in PORTED:
            port = drill.run_scenario(name, seed, device="cpu")
            armed_after = chaos.is_active()
            ref = jdrill.run_scenario(name, seed)
            out[(name, seed)] = (port, ref, armed_after)
    chaos.clear()
    jchaos.clear()
    return out


def test_the_eight_scenarios_are_ported():
    assert PORTED == sorted([
        "master_restart", "torn_shm", "storage_stall", "storage_crc",
        "node_flap", "kv_timeout", "heartbeat_loss", "torn_commit"])
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
    assert ref["ok"] and port["ok"]
    assert (drill.normalized_trace(port["trace"])
            == jdrill.normalized_trace(ref["trace"]))
    assert list(port["checks"]) == list(ref["checks"])
    assert port["faults_fired"] == ref["faults_fired"]
    for key in ("kind", "phase"):
        assert port["incident"][key] == ref["incident"][key]
    assert port["incident"]["chaos"] == ref["incident"]["chaos"]


@pytest.mark.parametrize("name", REPLAYED)
def test_replay_at_seed_13_gives_the_same_normalized_trace(runs, name):
    first = drill.normalized_trace(runs[(name, 13)][0]["trace"])
    again = drill.run_scenario(name, 13, device="cpu")
    assert again["ok"]
    assert drill.normalized_trace(again["trace"]) == first


@pytest.mark.parametrize("name", sorted(drill.WAITING))
def test_waiting_scenarios_name_their_item(name):
    item = drill.WAITING[name]
    with pytest.raises(NotImplementedError, match=item):
        drill.run_scenario(name, 0, device="cpu")
    assert not chaos.is_active()
    want = {"live_reshard": "6c", "fabric_reroute": "6d"}.get(
        name, "item 11, the rest")
    assert want in item


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
