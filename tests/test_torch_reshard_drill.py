"""The port's reshard drill (``trainer/flash_checkpoint/reshard_drill.py``)
and its bench entry, on the CPU, held to the reference drill's contract
(``dlrover_tpu/trainer/flash_checkpoint/reshard_drill.py``): 8 rank
processes save on dp1/fsdp2/tp2/cp2 and restore on dp2/fsdp4 from storage
past a torn shm snapshot with the loss carried across (1e-4 relative, the
reference's), and the grad-sync leg carries the int8_sharded state from
dp4 to dp2 by restart (new rank processes, ``Trainer.load_state``) and
live (``Trainer.live_reshard``), bit for bit the same state, the
error-feedback total kept.  ``bench.reshard_drill_subprocess`` lifts the
drill's line into the bench's columns as the reference's does.
"""

import json

import numpy as np
import pytest

SPAWN_TIMEOUT_S = 180.0

#: the reference drill's result keys (reshard_drill.run_reshard_drill)
DRILL_KEYS = ("save_s", "restore_reshard_s", "loss_before", "loss_after",
              "post_reshard_step_loss", "mesh_a", "mesh_b",
              "torn_shm_fallback", "timing_source", "grad_sync_reshard",
              "live_reshard_s", "reshard_speedup_vs_restart")


@pytest.fixture(scope="module")
def drill():
    from dlrover_tpu_torch.trainer.flash_checkpoint import reshard_drill

    return reshard_drill.run_reshard_drill("cpu", timeout_s=SPAWN_TIMEOUT_S)


def test_drill_restores_across_meshes_and_carries_the_loss(drill):
    """8 ranks save on dp1/fsdp2/tp2/cp2 and restore on dp2/fsdp4 from
    storage past a torn shm snapshot; the restored state's loss is the
    saved one's (the reference drill's 1e-4)."""
    assert set(DRILL_KEYS) <= set(drill)
    assert (drill["mesh_a"], drill["mesh_b"]) == ("dp1/fsdp2/tp2/cp2",
                                                  "dp2/fsdp4")
    assert drill["torn_shm_fallback"]
    assert abs(drill["loss_after"] - drill["loss_before"]) <= 1e-4 * max(
        1.0, abs(drill["loss_before"]))
    assert np.isfinite(drill["post_reshard_step_loss"])
    assert drill["restore_reshard_s"] > 0


def test_drill_grad_sync_leg_live_equals_restart(drill):
    gs = drill["grad_sync_reshard"]
    assert "error" not in gs, gs
    assert gs["live_bit_exact_vs_restart"] and gs["ef_total_preserved"]
    assert (gs["dp_from"], gs["dp_to"]) == (4, 2)
    assert gs["live_reshard_s"] > 0 and gs["restore_s"] > 0
    assert drill["live_reshard_s"] == gs["live_reshard_s"]


def test_bench_reads_the_drill_line(monkeypatch):
    """``bench.reshard_drill_subprocess`` lifts the drill's line into the
    bench's columns, as the reference's does."""
    import subprocess
    import types

    from dlrover_tpu_torch.trainer.flash_checkpoint import bench

    line = "RESHARD_DRILL " + json.dumps({
        "restore_reshard_s": 0.5, "mesh_a": "dp1/fsdp2/tp2/cp2",
        "mesh_b": "dp2/fsdp4", "live_reshard_s": 0.1,
        "reshard_speedup_vs_restart": 5.0})
    seen = {}

    def run(cmd, **kwargs):
        seen["cmd"] = cmd
        return types.SimpleNamespace(stdout=line + "\n", stderr="",
                                     returncode=0)

    monkeypatch.setattr(subprocess, "run", run)
    assert bench.reshard_drill_subprocess(device="cpu") == {
        "restore_reshard_s": 0.5,
        "reshard_meshes": "dp1/fsdp2/tp2/cp2 -> dp2/fsdp4",
        "live_reshard_s": 0.1, "reshard_speedup_vs_restart": 5.0}
    assert seen["cmd"][-3:] == [
        "dlrover_tpu_torch.trainer.flash_checkpoint.reshard_drill",
        "--device", "cpu"]
