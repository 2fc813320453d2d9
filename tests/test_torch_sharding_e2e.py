"""The port's flagship example on leased shards, end to end on the CPU.

``python -m dlrover_tpu_torch.trainer.elastic_run --standalone
--platform=cpu --nproc_per_node=2 -m
dlrover_tpu_torch.examples.train_llama7b <dir>`` at the ``tiny`` preset:
process 0 leases the 6 shards of 2 global batches from the launcher's
master and process 1 replays its stream, both train the 12 steps, and
every shard is consumed once.  The final checkpoint carries the shard
position; a second launch on the same directory restores it (``restored
data-shard position``), finds the dataset done and trains no more."""

import os
import re
import subprocess
import sys
import uuid

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT_S = 240.0
SHARD_LINE = re.compile(r"^shard=(\S+) \[(\d+), (\d+)\)$", re.M)
STEP_LINE = re.compile(r"^step=(\d+) loss=(\S+)$", re.M)
STEPS, GLOBAL_BATCH, SHARD_BATCHES = 12, 8, 2


def _launch(ckpt_dir):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("DLROVER_TPU_MASTER_ADDR", None)
    env["DLROVER_TPU_JOB_NAME"] = f"l7b{uuid.uuid4().hex[:8]}"
    env["DLROVER_TPU_PRESET"] = "tiny"
    env["DLROVER_TPU_MASTER_SERVICE_TYPE"] = "http"
    proc = subprocess.run(
        [sys.executable, "-m", "dlrover_tpu_torch.trainer.elastic_run",
         "--standalone", "--platform=cpu", "--nproc_per_node=2", "-m",
         "dlrover_tpu_torch.examples.train_llama7b", str(ckpt_dir)],
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=RUN_TIMEOUT_S)
    return proc.returncode, proc.stdout + proc.stderr


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    ckpt_dir = tmp_path_factory.mktemp("llama7b")
    return _launch(ckpt_dir), _launch(ckpt_dir)


def test_first_launch_consumes_every_shard_once(launches):
    (rc, out), _ = launches
    assert rc == 0, out[-4000:]
    assert out.count("starting fresh") == 2
    shards = SHARD_LINE.findall(out)
    # both processes see the leader's stream
    ranges = sorted((int(a), int(b)) for _, a, b in shards)
    span = GLOBAL_BATCH * SHARD_BATCHES
    want = [(s, s + span) for s in range(0, STEPS * GLOBAL_BATCH, span)]
    assert ranges == sorted(want * 2), out[-6000:]
    assert len({name for name, _, _ in shards}) == len(want)
    steps = sorted(int(s) for s, _ in STEP_LINE.findall(out))
    assert steps == sorted(list(range(1, STEPS + 1)) * 2), out[-6000:]
    assert out.count(f"done at step {STEPS}") == 2


def test_relaunch_restores_the_shard_position(launches):
    _, (rc, out) = launches
    assert rc == 0, out[-4000:]
    assert "restored data-shard position" in out
    assert out.count(f"resumed from step {STEPS}") == 2
    # the dataset was done at the snapshot: nothing is leased or trained
    assert not SHARD_LINE.findall(out)
    assert not STEP_LINE.findall(out)
