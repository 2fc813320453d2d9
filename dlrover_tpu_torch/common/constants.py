"""Shared constants and enums.

The classes of ``dlrover_tpu/common/constants.py`` that the port reads,
copied: the node and job state names, the exit-reason taxonomy,
rendezvous names, the env names injected into agents and workers, the
checkpoint directory's file names and the IPC paths.  The paths that
lie under ``/tmp`` in the reference lie under the process's temp
directory here, as in ``envs.py``.
"""

import os
import tempfile

_TMP = os.path.join(tempfile.gettempdir(), "dlrover_tpu")


class CommunicationType:
    GRPC = "grpc"
    HTTP = "http"


class NodeType:
    MASTER = "master"
    WORKER = "worker"
    # TF-PS-era roles kept for API parity; TPU jobs are worker-only.
    PS = "ps"
    CHIEF = "chief"
    EVALUATOR = "evaluator"


class NodeStatus:
    """Lifecycle states of a node (host / TPU-VM worker).

    Mirrors the status flow FSM of the reference
    (``dlrover/python/master/node/status_flow.py:164``).
    """

    INITIAL = "Initial"
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    DELETED = "Deleted"
    UNKNOWN = "Unknown"
    BREAKDOWN = "Breakdown"  # hardware fault detected by node-check

    @classmethod
    def end_states(cls):
        return {cls.SUCCEEDED, cls.FAILED, cls.DELETED}


class NodeEventType:
    ADDED = "ADDED"
    MODIFIED = "MODIFIED"
    DELETED = "DELETED"
    ERROR = "ERROR"
    # Self-reported node health events
    NODE_CHECK_SUCCEEDED = "NODE_CHECK_SUCCEEDED"
    NODE_CHECK_FAILED = "NODE_CHECK_FAILED"


class NodeExitReason:
    """Classified exit reasons driving relaunch policy.

    Mirrors the taxonomy in the reference ``common/constants.py`` /
    ``dist_job_manager.py:96`` (``is_positive_exit``): FATAL errors are not
    relaunched, hardware/preemption errors always are, OOM triggers a
    resource bump.
    """

    SUCCEEDED = "Succeeded"
    KILLED = "Deleted"  # externally deleted (e.g. preemption by scheduler)
    OOM = "OOMKilled"
    FATAL_ERROR = "Error"
    HARDWARE_ERROR = "HardwareError"  # TPU chip / host fault
    PREEMPTED = "Preempted"
    RELAUNCHED = "Relaunched"
    UNKNOWN_ERROR = "UnknownError"
    NO_HEARTBEAT = "NoHeartBeat"

    @classmethod
    def always_relaunch(cls):
        return {cls.KILLED, cls.PREEMPTED, cls.HARDWARE_ERROR, cls.NO_HEARTBEAT}


class JobStage:
    """Job lifecycle stage kept by the master's JobContext."""

    INIT = "INIT"
    PRE_CHECK = "PRE_CHECK"
    RENDEZVOUS = "RENDEZVOUS"
    RUNNING = "RUNNING"
    SUSPENDED = "SUSPENDED"
    FAILOVER = "FAILOVER"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"


class JobExitReason:
    SUCCEEDED = "Completed"
    CODE_ERROR = "CodeError"
    WORKER_OOM = "WorkerOOM"
    WORKER_ERROR = "WorkerError"
    RDZV_TIMEOUT = "RendezvousTimeout"
    PENDING_TIMEOUT = "PendingTimeout"
    NO_HEARTBEAT = "NoHeartBeat"
    HANG_ERROR = "HangError"
    UNKNOWN_ERROR = "UnknownError"


class RendezvousName:
    TRAINING = "elastic-training"
    NETWORK_CHECK = "network-check"


class NetworkFailureReason:
    NO_INIT = "#init-failed"
    NODE_FAILURE = "#node-failure"
    WAITING_NODE = "#waiting-node"
    STRAGGLER = "#straggler"


class TrainingExceptionLevel:
    RDZV_ERROR = "rdzv_error"
    PROCESS_ERROR = "process_error"
    NODE_ERROR = "node_error"
    WARNING = "warning"
    INFO = "info"
    ERROR = "error"
    # deterministic failure (crash-signature table): the whole job must
    # fail fast — remaining workers would re-rendezvous into the same
    # crash.  The servicer routes this to JobManager.request_abort.
    JOB_ABORT = "job_abort"


class NodeEnv:
    """Env vars injected into agents / workers."""

    MASTER_ADDR = "DLROVER_TPU_MASTER_ADDR"
    MASTER_SERVICE_TYPE = "DLROVER_TPU_MASTER_SERVICE_TYPE"
    NODE_ID = "DLROVER_TPU_NODE_ID"
    NODE_RANK = "DLROVER_TPU_NODE_RANK"
    NODE_TYPE = "DLROVER_TPU_NODE_TYPE"
    NODE_NUM = "DLROVER_TPU_NODE_NUM"
    JOB_NAME = "DLROVER_TPU_JOB_NAME"
    # the rendezvous of the worker processes (torch.distributed here)
    COORDINATOR_ADDR = "DLROVER_TPU_COORDINATOR_ADDR"
    PROCESS_ID = "DLROVER_TPU_PROCESS_ID"
    NUM_PROCESSES = "DLROVER_TPU_NUM_PROCESSES"


class ConfigPath:
    """Well-known file paths exchanged between agent and workers: the
    auto-parallelism config and each rank's runtime digest
    (``RUNTIME_METRICS``.rank<id>, ``trainer/train.py``)."""

    ENV_PARAL_CONFIG = "DLROVER_TPU_PARAL_CONFIG_PATH"
    PARAL_CONFIG = os.path.join(_TMP, "auto_paral_config.json")
    ENV_RUNTIME_METRICS = "DLROVER_TPU_RUNTIME_METRICS_PATH"
    RUNTIME_METRICS = os.path.join(_TMP, "runtime_metrics.json")


class CheckpointConstant:
    CKPT_NAME_PREFIX = "checkpoint-"
    TRACKER_FILE = "latest_checkpointed_iteration.txt"
    DONE_DIR = ".done"
    SAVE_EVENT_PREFIX = "save_step_"
    MODEL_STATES_NAME = "model_states"
    OPTIM_STATES_NAME = "optim_states"


class TrainingLoopStatus:
    START = 1
    END = 2
    PENDING = 3


class PreCheckStatus:
    CHECKING = "checking"
    PASS = "pass"
    FAIL = "fail"


GRPC_MAX_MESSAGE_LENGTH = 512 * 1024 * 1024  # collective of large shard metas

# the ROADMAP item of what the port's launcher and master refuse: the
# distributed master (k8s, ray, tpu_vm) and the launcher's network check
ROADMAP_LAUNCHER_REST = "ROADMAP queue 1 item 11, the rest"
