"""Constants the port's flash checkpoint reads.

The two classes of ``dlrover_tpu/common/constants.py`` that this slice
needs, copied: the checkpoint directory's file names and the node env
names that scope a job's shm and sockets.
"""


class NodeEnv:
    """Env vars injected into agents / workers."""

    MASTER_ADDR = "DLROVER_TPU_MASTER_ADDR"
    JOB_NAME = "DLROVER_TPU_JOB_NAME"
    PROCESS_ID = "DLROVER_TPU_PROCESS_ID"
    NUM_PROCESSES = "DLROVER_TPU_NUM_PROCESSES"


class CheckpointConstant:
    CKPT_NAME_PREFIX = "checkpoint-"
    TRACKER_FILE = "latest_checkpointed_iteration.txt"
    DONE_DIR = ".done"
    SAVE_EVENT_PREFIX = "save_step_"
    MODEL_STATES_NAME = "model_states"
    OPTIM_STATES_NAME = "optim_states"
