"""Constants the port reads.

The classes of ``dlrover_tpu/common/constants.py`` that the port needs,
copied: the checkpoint directory's file names, the node env names that
scope a job's shm and sockets and that the worker bootstrap reads
(``trainer/bootstrap.py``), and the runtime digest's path.  The path that
lies under ``/tmp`` in the reference lies under the process's temp
directory here, as in ``envs.py``.
"""

import os
import tempfile


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


class ConfigPath:
    """The file path exchanged between agent and workers: each rank's
    runtime digest (``RUNTIME_METRICS``.rank<id>, ``trainer/train.py``)."""

    ENV_RUNTIME_METRICS = "DLROVER_TPU_RUNTIME_METRICS_PATH"
    RUNTIME_METRICS = os.path.join(tempfile.gettempdir(), "dlrover_tpu",
                                   "runtime_metrics.json")


class CheckpointConstant:
    CKPT_NAME_PREFIX = "checkpoint-"
    TRACKER_FILE = "latest_checkpointed_iteration.txt"
    DONE_DIR = ".done"
    SAVE_EVENT_PREFIX = "save_step_"
    MODEL_STATES_NAME = "model_states"
    OPTIM_STATES_NAME = "optim_states"
