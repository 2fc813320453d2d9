"""The port's standalone launcher end to end on the CPU: ``python -m
dlrover_tpu_torch.trainer.elastic_run --standalone`` spawns its local
master, runs its elastic agent and starts real worker processes.

The runs start together when the first test asks for one (a module
fixture) and each test waits for its own, so the file takes about as
long as its slowest run.  Each run has a timeout of its own, after which
its whole process group is killed.

- 2 worker processes over gloo train the port's tiny Llama
  (``examples/train_llama_ckpt.py``); both print the same losses, and
  the first equals the loss of the port's ``Trainer`` run in this process
  on the same seed and global batch bitwise.  The later ones are held to
  that run within ``DP_LOSS_RTOL``: the two ranks' gradients are summed
  over gloo in another order than one process sums them, and AdamW's
  first updates (about lr times the gradient's sign) carry that rounding
  into the loss (3.1e-4 relative by step 4 here).
- The reference's ``tests/scripts/flaky_worker.py`` fails once and is
  restarted in place.
- A hard crash at step 7 of 12 (``os._exit(17)``): the agent restarts the
  worker, which resumes from the shm snapshot of step 6; every step of
  both workers has the uninterrupted run's loss, bitwise.  The tiny
  state is under ``DLROVER_TPU_ASYNC_MIN_BYTES``, so its async save
  takes the engine's blocking memory save, the one the ``llama2_1b``
  preset calls on the card: its log line for step 6 is checked.
- ``bench.recovery_drill(platform="cpu")`` returns ``recovery_s``.
- With no ``--platform`` on this card-less machine the worker raises
  (no CPU fallback) and the launcher exits non-zero after its restarts.
"""

import os
import re
import signal
import subprocess
import sys
import threading
import uuid

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT_S = 240.0
DP_STEPS = 4
CRASH_AT, CRASH_TOTAL = 7, 12
# the dp=2 losses after the first against one process's (the gradient
# sum's order, through AdamW's first updates)
DP_LOSS_RTOL = 1e-3
STEP_LINE = re.compile(r"^step=(\d+) loss=(\S+)$", re.M)
EXAMPLE = "dlrover_tpu_torch.examples.train_llama_ckpt"


class _Run:
    """One launcher process and its output, read by a thread."""

    def __init__(self, args, env_extra=None, env_drop=()):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env.pop("DLROVER_TPU_MASTER_ADDR", None)
        env["DLROVER_TPU_JOB_NAME"] = f"e2e{uuid.uuid4().hex[:8]}"
        env.update(env_extra or {})
        for name in env_drop:
            env.pop(name, None)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "dlrover_tpu_torch.trainer.elastic_run",
             *args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=REPO, start_new_session=True)
        self._out = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self._out.append(line)

    def result(self, timeout=RUN_TIMEOUT_S):
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
            rc = None
        self._reader.join(timeout=30)
        return rc, "".join(self._out)


class _Drill:
    def __init__(self):
        from dlrover_tpu_torch.trainer.flash_checkpoint import bench

        self.value = None
        self._thread = threading.Thread(
            target=lambda: setattr(self, "value", bench.recovery_drill(
                timeout=RUN_TIMEOUT_S, platform="cpu")), daemon=True)
        self._thread.start()

    def result(self):
        self._thread.join(RUN_TIMEOUT_S + 30)
        return self.value


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cpu = ["--standalone", "--platform=cpu"]
    started = {
        "dp2": _Run(
            cpu + ["--nproc_per_node=2", "-m", EXAMPLE,
                   str(tmp_path_factory.mktemp("dp2")), "tiny"],
            {"DLROVER_TPU_TOTAL_STEPS": str(DP_STEPS)}),
        "flaky": _Run(
            ["--standalone", "--nproc_per_node=1", "--max-restarts=2",
             "tests/scripts/flaky_worker.py",
             str(tmp_path_factory.mktemp("flaky") / "marker")]),
        "crash": _Run(
            cpu + ["--nproc_per_node=1", "--max-restarts=2", "-m", EXAMPLE,
                   str(tmp_path_factory.mktemp("crash")), "tiny"],
            {"DLROVER_TPU_CRASH_AT_STEP": str(CRASH_AT),
             "DLROVER_TPU_TOTAL_STEPS": str(CRASH_TOTAL)}),
        # conftest.py sets DLROVER_TPU_PLATFORM=cpu for the tests: drop it
        # so the worker takes the default, the card
        "no_card": _Run(
            ["--standalone", "--nproc_per_node=1", "--max-restarts=1", "-m",
             EXAMPLE, str(tmp_path_factory.mktemp("no_card")), "tiny"],
            env_drop=("DLROVER_TPU_PLATFORM",)),
        "drill": _Drill(),
    }
    yield started
    for run in started.values():
        if isinstance(run, _Run) and run.proc.poll() is None:
            os.killpg(run.proc.pid, signal.SIGKILL)
            run.proc.wait()


def _reference_losses(steps):
    """The example's tiny preset trained by the port's Trainer in this
    process: one device, the whole global batch."""
    from dlrover_tpu_torch.examples.train_llama_ckpt import _subject
    from dlrover_tpu_torch.trainer.train import Trainer

    model, optimizer, kwargs, batch = _subject("tiny", "cpu")
    trainer = Trainer(model, optimizer, device="cpu", **kwargs)
    state = trainer.create_state()
    losses = []
    for _ in range(steps):
        state, metrics = trainer.train_step(state, batch)
        losses.append(metrics["loss"].item())
    return losses


def _steps(output):
    return [(int(step), float(loss))
            for step, loss in STEP_LINE.findall(output)]


def test_two_workers_train_alike(runs):
    rc, out = runs["dp2"].result()
    assert rc == 0, out[-3000:]
    assert out.count("starting fresh") == 2
    assert out.count(f"done at step {DP_STEPS}, loss=") == 2
    steps = _steps(out)
    by_step = {}
    for step, loss in steps:
        by_step.setdefault(step, []).append(loss)
    assert sorted(by_step) == list(range(1, DP_STEPS + 1))
    want = _reference_losses(DP_STEPS)
    for step, losses in sorted(by_step.items()):
        assert len(losses) == 2 and losses[0] == losses[1], (step, losses)
        np.testing.assert_allclose(losses[0], want[step - 1],
                                   rtol=DP_LOSS_RTOL)
    assert by_step[1][0] == want[0]


def test_flaky_worker_restarted_in_place(runs):
    rc, out = runs["flaky"].result()
    assert rc == 0, out[-3000:]
    assert "flaky worker: crashing on purpose" in out
    assert "restarting workers in place" in out
    assert "flaky worker: ok after restart" in out


def test_crash_resumes_from_shm(runs):
    rc, out = runs["crash"].result()
    assert rc == 0, out[-3000:]
    assert f"simulating crash at step {CRASH_AT}" in out
    assert f"resumed from step {CRASH_AT - 1}" in out
    assert f"done at step {CRASH_TOTAL}, loss=" in out
    assert "save-on-failure: persisting shm step 6" in out
    assert f"flash-ckpt memory snapshot step={CRASH_AT - 1} blocked" in out
    crash = out.index(f"simulating crash at step {CRASH_AT}")
    first, resumed = _steps(out[:crash]), _steps(out[crash:])
    assert [s for s, _ in first] == list(range(1, CRASH_AT + 1))
    assert [s for s, _ in resumed] == list(range(CRASH_AT, CRASH_TOTAL + 1))
    want = _reference_losses(CRASH_TOTAL)
    assert [loss for _, loss in first] == want[:CRASH_AT]
    assert [loss for _, loss in resumed] == want[CRASH_AT - 1:]


def test_recovery_drill_on_the_cpu(runs):
    result = runs["drill"].result()
    assert result is not None and "recovery_error" not in result, result
    assert result["recovery_resumed_step"] == CRASH_AT
    assert 0 < result["recovery_s"] < RUN_TIMEOUT_S


def test_no_card_no_fallback(runs):
    rc, out = runs["no_card"].result()
    assert rc not in (0, None), out[-3000:]
    assert "no CUDA device is available" in out
    assert "starting fresh" not in out and not _steps(out)
