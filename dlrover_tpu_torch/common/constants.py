"""Constants the port reads.

The two classes of ``dlrover_tpu/common/constants.py`` that the port
needs, copied: the checkpoint directory's file names, and the node env
names that scope a job's shm and sockets and that the worker bootstrap
reads (``trainer/bootstrap.py``).
"""


class NodeEnv:
    """Env vars injected into agents / workers."""

    MASTER_ADDR = "DLROVER_TPU_MASTER_ADDR"
    NODE_RANK = "DLROVER_TPU_NODE_RANK"
    NODE_NUM = "DLROVER_TPU_NODE_NUM"
    JOB_NAME = "DLROVER_TPU_JOB_NAME"
    # the rendezvous of the worker processes (torch.distributed here)
    COORDINATOR_ADDR = "DLROVER_TPU_COORDINATOR_ADDR"
    PROCESS_ID = "DLROVER_TPU_PROCESS_ID"
    NUM_PROCESSES = "DLROVER_TPU_NUM_PROCESSES"


class CheckpointConstant:
    CKPT_NAME_PREFIX = "checkpoint-"
    TRACKER_FILE = "latest_checkpointed_iteration.txt"
    DONE_DIR = ".done"
    SAVE_EVENT_PREFIX = "save_step_"
    MODEL_STATES_NAME = "model_states"
    OPTIM_STATES_NAME = "optim_states"
