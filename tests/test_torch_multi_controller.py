"""The port's multi-controller drill
(dlrover_tpu_torch/trainer/flash_checkpoint/multi_controller_drill.py) at
its tiny size on the CPU: 2 processes train the tiny Llama on fsdp=2 over
a gloo world, save every rank's shards at SAVE_STEP, rank 1 is SIGKILLed
mid-training and the survivor reaped, and one process restores both shard
sets from storage.  The checks are the reference's
(tests/test_multi_controller.py, whose 2x4 -> 1x8 form is 2x1 -> 1x1 here:
one device a process)."""

from dlrover_tpu_torch.trainer.flash_checkpoint.multi_controller_drill import (
    SAVE_STEP,
    run_multi_controller_drill,
)


def test_two_controllers_kill_one_restore_on_one():
    result = run_multi_controller_drill(nprocs=2, device="cpu",
                                        timeout=240.0)
    assert result["topology"] == "2x1 -> 1x1"
    assert result["save_step"] == SAVE_STEP
    # the killed rank died by the drill's signal
    assert result["killed_rank_rc"] == -9
    drift = abs(result["restore_eval_loss"] - result["train_eval_loss"])
    assert drift <= 1e-4 * max(1.0, abs(result["train_eval_loss"]))
    assert result["post_restore_loss"] > 0
    assert result["restore_s"] < 60
