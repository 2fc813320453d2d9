"""The ``DLROVER_TPU_*`` environment knobs that the port reads.

A copy of the knobs of ``dlrover_tpu/common/envs.py`` that the port's
paths read (the grad sync, the flash checkpoint and its distributed
persist, the node env they are scoped by, the worker bootstrap and the
mesh, the rank's runtime digest: tracing, metrics, the flight
recorder, the goodput ledger and the memory, comm and compile scopes,
the job runtime: the launcher, the local master, its admission
control, the agent's transport and its retry budget, fault injection
and the incident engine, the master's time-series store, the sentinels,
the persistent compile cache, the sharding client and datascope, the
live reshard): the
same names,
defaults and parsing, and the reference's per-call ``default=``
override for the sites whose default is computed.  A knob is added with
the port of the code that reads it.  Values are read from
``os.environ`` at call time; a malformed value logs a warning and falls
back to the default, and an unknown name raises ``KeyError``.  The
directories that default under ``/tmp`` in the reference default under
the process's temp directory here (``tempfile.gettempdir()``, which
honours ``TMPDIR``).
"""

import logging
import os
import tempfile

logger = logging.getLogger(__name__)

_TMP = os.path.join(tempfile.gettempdir(), "dlrover_tpu")

DEFAULTS = {
    # MB of fp32 gradient per grad-sync bucket; 0 = per-leaf collectives.
    # GradSyncPolicy(bucket_mb=...) overrides per trainer
    "DLROVER_TPU_GRAD_BUCKET_MB": 4.0,
    # reduce-scatter transport: auto | all_to_all | ring | ring_pallas |
    # ring_rdma | ring_pallas_q; each tier falls back when its
    # preconditions fail
    "DLROVER_TPU_GRAD_TRANSPORT": "auto",
    # blockwise mode: fraction of blocks per chunk that ship an int8
    # refinement over the int4 base
    "DLROVER_TPU_GRAD_HI_FRAC": 0.125,
    # the one-kernel RDMA ring for transport=ring_rdma
    "DLROVER_TPU_GRAD_RING_RDMA": False,
    # -- flash checkpoint: staging (snapshot.py) --
    # allowed step-inflation factor while the stager copies to the host
    "DLROVER_TPU_STAGE_FACTOR": 1.5,
    # manual duty cycle (sleep = pace x transfer time); 0 = adaptive
    "DLROVER_TPU_STAGE_PACE": 0.0,
    # fixed streaming chunk size; 0 = the adaptive pacer's
    "DLROVER_TPU_STREAM_CHUNK_BYTES": 0,
    # -- flash checkpoint: engine --
    # stream D2H chunks straight into shm (0: extract to host, then pack)
    "DLROVER_TPU_STREAM_STAGING": True,
    # states at or below this take the synchronous save path
    "DLROVER_TPU_ASYNC_MIN_BYTES": 128 << 20,
    # '' exact; 'bf16' snapshots fp32 leaves as bf16 (not bit-exact)
    "DLROVER_TPU_SNAPSHOT_DTYPE": "",
    # how long an async save waits for the device-copy slot before it
    # saves synchronously
    "DLROVER_CKPT_SLOT_WAIT_S": 120.0,
    # buffer-lock bound (must outlast an in-flight stream)
    "DLROVER_TPU_CKPT_LOCK_TIMEOUT_S": 600.0,
    # CRC32 check on restore: eager, lazy or off
    "DLROVER_TPU_VERIFY_CRC": "lazy",
    # -- flash checkpoint: replicas and peer restore (replica.py,
    # peer_restore.py) --
    # bytes a rotation round of the replica exchange moves per process
    "DLROVER_TPU_REPLICA_CHUNK_BYTES": 64 << 20,
    # a lost rank's snapshot is refilled from its peers' shm first
    # (ladder: peer shm -> sealed-manifest ranged reads -> storage)
    "DLROVER_TPU_PEER_RESTORE": False,
    # the peer serve endpoint's port (0 = ephemeral) and the interface it
    # listens on ('' = the advertised host: it serves the whole state
    # unauthenticated)
    "DLROVER_TPU_PEER_SERVE_PORT": 0,
    "DLROVER_TPU_PEER_BIND_HOST": "",
    # per-request timeout of a peer fetch, and bytes per ranged request
    "DLROVER_TPU_PEER_FETCH_TIMEOUT_S": 30.0,
    "DLROVER_TPU_PEER_FETCH_CHUNK_BYTES": 64 << 20,
    # the recovery's MTTR budget, reported as budget_s / over_budget; the
    # MTTR sentinel opens an incident past it (0 = the sentinel is off)
    "DLROVER_TPU_MTTR_BUDGET_S": 60.0,
    # a recovery (and a booting worker under peer restore) first pulls
    # the kernel build cache's libraries it lacks from a peer
    "DLROVER_TPU_PEER_CACHE_PREWARM": True,
    # the persistent compile cache: the kernel build directory ('' = the
    # build/kernels directory of the checkout, 'off' = recorded as off)
    "DLROVER_TPU_COMPILE_CACHE": "",
    # -- flash checkpoint: distributed persist (distributed.py) --
    # storage saves write owned shards and commit in two phases
    "DLROVER_TPU_DIST_PERSIST": False,
    # reuse unchanged shards of the last committed manifest
    "DLROVER_TPU_DIST_DIFF": True,
    # sealed manifests the coordinator keeps (older ones and their
    # unreferenced shard files are collected)
    "DLROVER_TPU_DIST_MANIFEST_KEEP": 4,
    # how long a save waits for its step to seal, and the poll interval
    "DLROVER_TPU_DIST_COMMIT_TIMEOUT_S": 600.0,
    "DLROVER_TPU_DIST_SEAL_POLL_S": 0.2,
    # -- flash checkpoint: saver (agent/ckpt_saver.py) --
    "DLROVER_TPU_PERSIST_LOCK_WAIT_S": 900.0,
    "DLROVER_TPU_PERSIST_WRITERS": 4,
    "DLROVER_TPU_PERSIST_CHUNK_BYTES": 64 << 20,
    # -- node env (common/constants.NodeEnv) and process plumbing --
    "DLROVER_TPU_JOB_NAME": "",
    "DLROVER_TPU_MASTER_ADDR": "",
    "DLROVER_TPU_NODE_RANK": 0,
    "DLROVER_TPU_NODE_NUM": 1,
    # the rendezvous the agent publishes (host:port), this worker's
    # process id and the world of processes
    "DLROVER_TPU_COORDINATOR_ADDR": "",
    "DLROVER_TPU_PROCESS_ID": 0,
    "DLROVER_TPU_NUM_PROCESSES": 1,
    # -- worker bootstrap (trainer/bootstrap.py) and mesh --
    # platform the worker computes on: '' = the card, 'cpu' = the CPU
    "DLROVER_TPU_PLATFORM": "",
    "DLROVER_TPU_LOCAL_RANK": 0,
    "DLROVER_TPU_RESTART_COUNT": 0,
    "DLROVER_TPU_RDZV_ROUND": 0,
    # pod slices (DCN domains) of a two-level mesh; 0/1 = flat
    "DLROVER_TPU_SLICE_COUNT": 0,
    # unix sockets of the shared lock, queue and dict
    "DLROVER_TPU_SOCKET_DIR": os.path.join(_TMP, "sockets"),
    "DLROVER_TPU_LOG_LEVEL": "INFO",
    # training-event JSONL path; '' = a per-pid file under the temp dir
    "DLROVER_TPU_EVENT_FILE": "",
    # Prometheus text endpoint of the card's runtime metrics
    # (common/metric.py); '' = memory-only sampling
    "DLROVER_TPU_DEVICE_METRICS_URL": "",
    # -- the rank's runtime digest (trainer/train.py, observability/) --
    # the per-rank digest file the agent folds into its heartbeat, and
    # how often the trainer writes it (0: never)
    "DLROVER_TPU_RUNTIME_METRICS_PATH": os.path.join(
        _TMP, "runtime_metrics.json"),
    "DLROVER_TPU_DIGEST_EVERY": 20,
    # tracing: the switch, a nonzero id seed, a JSONL file for the span
    # records ('' = the training-event file), head sampling of new roots,
    # events kept per span
    "DLROVER_TPU_TRACE": True,
    "DLROVER_TPU_TRACE_SEED": 0,
    "DLROVER_TPU_TRACE_FILE": "",
    "DLROVER_TPU_TRACE_SAMPLE": 1.0,
    "DLROVER_TPU_TRACE_MAX_EVENTS": 256,
    # metrics: live label combinations per process (the rest dropped)
    "DLROVER_TPU_METRICS_MAX_SERIES": 4096,
    # flight recorder: the switch and its rings' capacities
    "DLROVER_TPU_RECORDER": True,
    "DLROVER_TPU_RECORDER_SPANS": 1024,
    "DLROVER_TPU_RECORDER_EVENTS": 1024,
    "DLROVER_TPU_RECORDER_STEPS": 512,
    "DLROVER_TPU_RECORDER_LOG_LINES": 200,
    # goodput ledger: the switch, the slot in seconds, live slots kept
    "DLROVER_TPU_GOODPUT_LEDGER": True,
    "DLROVER_TPU_GOODPUT_RES_S": 1.0,
    "DLROVER_TPU_GOODPUT_WINDOW": 7200,
    # comm scope: probe every N steps (0: never), the latency probe's and
    # the bandwidth probe's bytes, timed repetitions, the bucket chains on
    # the same cadence, the fabric model's EWMA factor
    "DLROVER_TPU_COMM_PROBE_EVERY": 200,
    "DLROVER_TPU_COMM_PROBE_LAT_BYTES": 64,
    "DLROVER_TPU_COMM_PROBE_BW_BYTES": 1048576,
    "DLROVER_TPU_COMM_PROBE_REPS": 4,
    "DLROVER_TPU_COMM_EWMA_ALPHA": 0.5,
    "DLROVER_TPU_COMM_BUCKET_PROBE": True,
    # memory scope: the switch, a bytes limit for the CPU (0 = unknown),
    # and the margin fit_report keeps below the measured limit
    "DLROVER_TPU_MEM_SCOPE": True,
    "DLROVER_TPU_MEM_CPU_LIMIT_B": 0.0,
    "DLROVER_TPU_MEM_FIT_MARGIN": 0.08,
    # -- live reshard (parallel/reshard.py) --
    # refuse a plan the memory scope's measured fit report says does not
    # fit; the sealed distributed-checkpoint dir that donates the shards
    # no survivor holds ('' = survivors only)
    "DLROVER_TPU_RESHARD_FIT_GATE": True,
    "DLROVER_TPU_RESHARD_DONOR_DIR": "",
    # compile scope: the switch, events kept, the dispatch-stall bound
    # (0 = no stall detection)
    "DLROVER_TPU_JITSCOPE": True,
    "DLROVER_TPU_JITSCOPE_EVENTS": 256,
    "DLROVER_TPU_JITSCOPE_STALL_MS": 500.0,
    # -- the master's time-series store (master/timeseries.py) and the
    # sentinels (observability/sentinel.py) --
    # points kept per series per resolution ring (1 s, 10 s, 5 min)
    "DLROVER_TPU_TS_POINTS": 600,
    # the EWMA+MAD detector: smoothing, breach width in deviations, the
    # warm-up, and the breaches in a row that fire
    "DLROVER_TPU_SENTINEL_ALPHA": 0.25,
    "DLROVER_TPU_SENTINEL_MAD_K": 4.0,
    "DLROVER_TPU_SENTINEL_MIN_SAMPLES": 8,
    "DLROVER_TPU_SENTINEL_CONSECUTIVE": 2,
    # the least probe-latency move (us) a slow-link breach must clear
    "DLROVER_TPU_COMM_SLOWLINK_MIN_LAT_US": 50.0,
    # the memory sentinel: headroom floor (fraction of the limit), the
    # least in-use slope (B/s) that is a leak, its EWMA smoothing
    "DLROVER_TPU_MEM_HEADROOM_FLOOR": 0.05,
    "DLROVER_TPU_MEM_LEAK_SLOPE_B_S": 1048576.0,
    "DLROVER_TPU_MEM_EWMA_ALPHA": 0.5,
    # the compile sentinel: the least compile seconds per window a storm
    # must clear, and the hit ratio under which a warm cache is cold
    "DLROVER_TPU_COMPILE_STORM_MIN_S": 5.0,
    "DLROVER_TPU_CACHE_COLD_RATIO": 0.5,
    # the data sentinels' floors: the starved share, the lease p99 (ms)
    "DLROVER_TPU_DATA_STARVED_SHARE": 0.10,
    "DLROVER_TPU_DATA_P99_MIN_MS": 50.0,
    # synthetic bytes the chaos point mem.pressure adds to the sampled
    # in-use figure per fired fault (cumulative: an injected leak)
    "DLROVER_TPU_MEM_CHAOS_INFLATE_B": 268435456.0,
    # -- fault injection (chaos/): arming from the env (tests and drills
    # only; the switch stays off by default), an inline JSON plan or a
    # path to one, the seed override, the JSONL file fired faults append to
    "DLROVER_TPU_CHAOS": False,
    "DLROVER_TPU_CHAOS_SPEC": "",
    "DLROVER_TPU_CHAOS_SEED": 0,
    "DLROVER_TPU_CHAOS_TRACE_FILE": "",
    # -- the incident engine (observability/incidents.py): the root of
    # the per-incident directories, the per-kind dedup window, how long a
    # finalize waits for agent dumps, the incidents kept on disk --
    "DLROVER_TPU_INCIDENT_DIR": os.path.join(_TMP, "incidents"),
    "DLROVER_TPU_INCIDENT_COOLDOWN_S": 300.0,
    "DLROVER_TPU_INCIDENT_GRACE_S": 60.0,
    "DLROVER_TPU_INCIDENT_MAX": 16,
    # the memory forecast horizon (s): a memory incident counts an earlier
    # hbm_leak/mem_pressure incident as its forecast within twice this
    "DLROVER_TPU_MEM_FORECAST_S": 600.0,
    # -- the job runtime: launcher, master, agent (trainer/elastic_run.py,
    # master/, agent/elastic_agent.py, agent/master_client.py) --
    # master transport (grpc or http) and listen port (0: a free one)
    "DLROVER_TPU_MASTER_SERVICE_TYPE": "grpc",
    "DLROVER_TPU_MASTER_PORT": 0,
    # the gRPC master's thread pool; 0 = MAX_WAITERS + MAX_INFLIGHT +
    # headroom, so blocked long-polls never starve ordinary RPCs
    "DLROVER_TPU_MASTER_GRPC_WORKERS": 0,
    # stable node id (falls back to NODE_RANK), role, pod-slice index
    "DLROVER_TPU_NODE_ID": 0,
    "DLROVER_TPU_NODE_TYPE": "worker",
    "DLROVER_TPU_SLICE_ID": 0,
    # scale plans move in units of this many hosts
    "DLROVER_TPU_NODE_UNIT": 1,
    # where the agent drops the auto-parallelism config for workers
    "DLROVER_TPU_PARAL_CONFIG_PATH": os.path.join(
        _TMP, "auto_paral_config.json"),
    # the pre-training network/node check; master-side pre-checks
    "DLROVER_TPU_NETWORK_CHECK": False,
    "DLROVER_TPU_PRE_CHECK": True,
    # hang detection: mode (0 off, 1 step watermark, 2 timer metrics)
    # and the downtime (s) that makes a hang verdict
    "DLROVER_TPU_HANG_DETECTION": 1,
    "DLROVER_TPU_HANG_DOWNTIME": 300,
    # agent heartbeat silence that marks a node NO_HEARTBEAT (s)
    "DLROVER_TPU_HEARTBEAT_TIMEOUT": 180,
    # stragglers: elapsed > avg x ratio; the digest step-time screen;
    # relaunch what the device evidence marks (opt-in)
    "DLROVER_TPU_STRAGGLER_RATIO": 1.6,
    "DLROVER_TPU_STRAGGLER_STEP_RATIO": 1.5,
    "DLROVER_TPU_EXCLUDE_STRAGGLER": False,
    # step-report gap the perf monitor counts as downtime (s)
    "DLROVER_TPU_STALL_THRESHOLD": 15.0,
    # a saver busy on one persist longer than this is stalled (s)
    "DLROVER_TPU_CKPT_STALL_S": 600.0,
    # sustained admission refusals/s that make an overload storm
    "DLROVER_TPU_OVERLOAD_STORM_RATE": 50.0,
    # relaunch workers on any exit reason; the master's auto-scaler;
    # the brain's address ('' = local heuristics)
    "DLROVER_TPU_RELAUNCH_ALWAYS": False,
    "DLROVER_TPU_AUTO_SCALE": False,
    "DLROVER_TPU_BRAIN_ADDR": "",
    # long-poll waits block server-side, in chunks of at most MAX_S
    "DLROVER_TPU_LONGPOLL": True,
    "DLROVER_TPU_LONGPOLL_MAX_S": 30.0,
    # admission control: the work pool, the wait pool (0 = unlimited),
    # the queueing bound and the retry-after hint
    "DLROVER_TPU_SERVICER_MAX_INFLIGHT": 256,
    "DLROVER_TPU_SERVICER_MAX_WAITERS": 4096,
    "DLROVER_TPU_SERVICER_QUEUE_TIMEOUT_S": 0.5,
    "DLROVER_TPU_SERVICER_RETRY_AFTER_S": 0.25,
    # the agent->master transport's retry budget, the circuit breaker
    # (0 = off), jitter
    "DLROVER_TPU_RPC_RETRY_ATTEMPTS": 8,
    "DLROVER_TPU_RPC_RETRY_BASE_S": 0.5,
    "DLROVER_TPU_RPC_RETRY_MAX_S": 8.0,
    "DLROVER_TPU_RPC_RETRY_DEADLINE_S": 60.0,
    "DLROVER_TPU_RETRY_CB_THRESHOLD": 0,
    "DLROVER_TPU_RETRY_CB_COOLDOWN_S": 30.0,
    "DLROVER_TPU_RETRY_JITTER": True,
    # -- the elastic data path (agent/sharding.py, observability/
    # datascope.py) --
    # shard leases per TaskBatchRequest envelope (>1 prefetches on the
    # client), and the long-poll chunk while no shard is dispatchable
    "DLROVER_TPU_SHARD_LEASE_BATCH": 1,
    "DLROVER_TPU_SHARD_WAIT_S": 10.0,
    # datascope: the switch (off: every hook a no-op), the least seconds
    # between shard-telemetry flushes into the store, the per-dataset
    # sample window, and the blocking fetch wait under which nothing is
    # charged to input_starved
    "DLROVER_TPU_DATASCOPE": True,
    "DLROVER_TPU_DATA_FLUSH_S": 1.0,
    "DLROVER_TPU_DATA_WINDOW": 512,
    "DLROVER_TPU_DATA_STARVED_MIN_S": 0.05,
}

_MISSING = object()
_TRUE_WORDS = ("1", "true", "yes", "on")
_FALSE_WORDS = ("0", "false", "no", "off", "")


def _complain(name: str, value: str, type_: str, fallback) -> None:
    logger.warning("env %s=%r is not a valid %s; using %r", name, value,
                   type_, fallback)


def _fallback(name: str, default):
    registered = DEFAULTS[name]  # an unknown name raises KeyError
    return registered if default is _MISSING else default


def get_str(name: str, default=_MISSING) -> str:
    fallback = _fallback(name, default)
    value = os.environ.get(name)
    return fallback if value is None else value


def get_int(name: str, default=_MISSING) -> int:
    fallback = _fallback(name, default)
    value = os.environ.get(name)
    if value is None:
        return fallback
    try:
        # int(float(...)) accepts "1e8"-style byte sizes
        return int(float(value))
    except ValueError:
        _complain(name, value, "int", fallback)
        return fallback


def get_float(name: str, default=_MISSING) -> float:
    fallback = _fallback(name, default)
    value = os.environ.get(name)
    if value is None:
        return fallback
    try:
        return float(value)
    except ValueError:
        _complain(name, value, "float", fallback)
        return fallback


def get_bool(name: str, default=_MISSING) -> bool:
    fallback = _fallback(name, default)
    value = os.environ.get(name)
    if value is None:
        return bool(fallback)
    word = value.strip().lower()
    if word in _TRUE_WORDS:
        return True
    if word in _FALSE_WORDS:
        return False
    _complain(name, value, "bool", fallback)
    return fallback
