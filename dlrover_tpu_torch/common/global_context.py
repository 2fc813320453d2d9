"""Process-wide configuration singleton.

Copy of ``dlrover_tpu/common/global_context.py``, its imports the port's.

The JAX package's counterpart of DLRover's ``dlrover/python/common/global_context.py``
(``Context`` + ``DefaultValues``): a single place for tunables that master,
agent and trainer consult, overridable from env vars.
"""

import threading

from dlrover_tpu_torch.common import envs


class DefaultValues:
    SERVICE_TYPE = "grpc"
    MASTER_PORT = 0  # 0 = pick a free port
    RDZV_TIMEOUT_SECS = 600
    NODE_CHECK_TIMEOUT_SECS = 300
    HANG_DOWNTIME_SECS = 300  # no step progress for this long => hang
    HANG_DETECTION = 1  # 0=off, 1=step-watermark, 2=timer-metrics
    SECONDS_TO_WAIT_PENDING_POD = 900
    SECONDS_HUGE_TRAINING_THRESHOLD = 1800
    STEP_SAMPLE_COUNT = 20
    RELAUNCH_ON_WORKER_FAILURE = 3
    HEARTBEAT_INTERVAL_SECS = 15
    HEARTBEAT_TIMEOUT_SECS = 180
    WORKER_MONITOR_INTERVAL_SECS = 5
    REPORTER_INTERVAL_SECS = 30
    SECONDS_TO_AUTOSCALE_WORKER = 90
    STRAGGLER_RATIO = 1.6  # elapsed > avg*ratio => straggler
    SAVE_MEM_RATIO_THRESHOLD = 0.4
    MAX_METRIC_RECORDS = 600
    PRE_CHECK_ENABLED = 1
    EXIT_BARRIER_TIMEOUT_SECS = 300
    # TPU slices are all-or-nothing: scale plans move in units of
    # ``node_unit`` hosts (reference: rdzv node_unit, rdzv_manager.py:159-181)
    NODE_UNIT = 1


class Context:
    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        self.master_service_type = envs.get_str(
            "DLROVER_TPU_MASTER_SERVICE_TYPE",
            default=DefaultValues.SERVICE_TYPE,
        )
        self.master_port = envs.get_int(
            "DLROVER_TPU_MASTER_PORT", default=DefaultValues.MASTER_PORT
        )
        self.rdzv_timeout_secs = DefaultValues.RDZV_TIMEOUT_SECS
        self.node_check_timeout_secs = DefaultValues.NODE_CHECK_TIMEOUT_SECS
        self.hang_downtime_secs = envs.get_int(
            "DLROVER_TPU_HANG_DOWNTIME",
            default=DefaultValues.HANG_DOWNTIME_SECS,
        )
        self.hang_detection = envs.get_int(
            "DLROVER_TPU_HANG_DETECTION", default=DefaultValues.HANG_DETECTION
        )
        self.seconds_to_wait_pending_pod = (
            DefaultValues.SECONDS_TO_WAIT_PENDING_POD
        )
        self.relaunch_on_worker_failure = DefaultValues.RELAUNCH_ON_WORKER_FAILURE
        self.relaunch_always = envs.get_bool("DLROVER_TPU_RELAUNCH_ALWAYS")
        self.heartbeat_interval_secs = DefaultValues.HEARTBEAT_INTERVAL_SECS
        self.heartbeat_timeout_secs = envs.get_int(
            "DLROVER_TPU_HEARTBEAT_TIMEOUT",
            default=DefaultValues.HEARTBEAT_TIMEOUT_SECS,
        )
        self.worker_monitor_interval_secs = (
            DefaultValues.WORKER_MONITOR_INTERVAL_SECS
        )
        self.reporter_interval_secs = DefaultValues.REPORTER_INTERVAL_SECS
        self.straggler_ratio = envs.get_float(
            "DLROVER_TPU_STRAGGLER_RATIO",
            default=DefaultValues.STRAGGLER_RATIO,
        )
        # opt-in: relaunch nodes the DEVICE evidence marks as stragglers
        # (duty cycle below the job median for consecutive windows);
        # default off — the diagnosis emits loud events either way
        self.exclude_straggler = envs.get_bool(
            "DLROVER_TPU_EXCLUDE_STRAGGLER"
        )
        self.step_sample_count = DefaultValues.STEP_SAMPLE_COUNT
        self.max_metric_records = DefaultValues.MAX_METRIC_RECORDS
        self.pre_check_enabled = envs.get_bool(
            "DLROVER_TPU_PRE_CHECK",
            default=bool(DefaultValues.PRE_CHECK_ENABLED),
        )
        self.exit_barrier_timeout_secs = DefaultValues.EXIT_BARRIER_TIMEOUT_SECS
        self.node_unit = envs.get_int(
            "DLROVER_TPU_NODE_UNIT", default=DefaultValues.NODE_UNIT
        )
        self.auto_scale_enabled = envs.get_bool("DLROVER_TPU_AUTO_SCALE")
        self.brain_addr = envs.get_str("DLROVER_TPU_BRAIN_ADDR")
        self.reporter = "local"

    @classmethod
    def singleton_instance(cls) -> "Context":
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = Context()
        return cls._instance

    @classmethod
    def reset(cls):
        """Testing hook: drop the singleton so env overrides re-apply."""
        with cls._lock:
            cls._instance = None
