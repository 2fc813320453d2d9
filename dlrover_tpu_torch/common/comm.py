"""Control-plane message dataclasses + envelope.

Copy of ``dlrover_tpu/common/comm.py``, its imports the port's.

The JAX package's counterpart of DLRover's ``dlrover/python/common/comm.py:105-552``.
The master exposes exactly two RPCs — ``report`` (fire-and-ack) and ``get``
(request-response) — demuxed by the concrete message class carried in the
envelope, so adding a control-plane feature never changes the service
definition.  Unlike the reference we serialize with JSON (see serialize.py),
and comm worlds describe TPU slice topology (hosts x chips, ICI domain)
rather than NCCL process groups.
"""

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List

from dlrover_tpu_torch.common.serialize import (
    JsonSerializable,
    deserialize_message,
    register_message,
    serialize_message,
)


@register_message
@dataclass
class Message(JsonSerializable):
    """Wire envelope: who sent it + one serialized payload message.

    ``trace_ctx`` carries the caller's W3C-style traceparent
    (``observability/trace.py``) so the servicer can open a server span
    parented to the calling attempt; empty = untraced caller (older
    senders deserialize fine — the field defaults).
    """

    node_type: str = ""
    node_id: int = -1
    data: bytes = b""
    trace_ctx: str = ""

    def pack(self, payload: Any) -> "Message":
        self.data = serialize_message(payload)
        return self

    def unpack(self) -> Any:
        return deserialize_message(self.data)


#: ``BaseResponse.reason`` value marking an admission-control rejection;
#: clients turn it into :class:`dlrover_tpu.common.retry.OverloadedError`
#: so the retry policy honors ``retry_after_s`` instead of hammering.
OVERLOADED = "overloaded"


@register_message
@dataclass
class BaseResponse(JsonSerializable):
    success: bool = True
    reason: str = ""
    # server backpressure hint: when ``reason == OVERLOADED``, wait this
    # many seconds before retrying (0 = no hint; older peers deserialize
    # fine — the field defaults)
    retry_after_s: float = 0.0


# --------------------------------------------------------------------------
# Data sharding (reference: TaskRequest/Task/ShardCheckpointRequest)
# --------------------------------------------------------------------------


@register_message
@dataclass
class Shard(JsonSerializable):
    name: str = ""
    start: int = -1
    end: int = -1
    record_indices: List[int] = field(default_factory=list)


@register_message
@dataclass
class Task(JsonSerializable):
    task_id: int = -1
    task_type: str = ""  # TRAINING / EVALUATION / WAIT / NONE
    shard: Shard = field(default_factory=Shard)

    @property
    def exists(self) -> bool:
        return self.task_id >= 0


@register_message
@dataclass
class TaskRequest(JsonSerializable):
    dataset_name: str = ""


@register_message
@dataclass
class TaskResult(JsonSerializable):
    dataset_name: str = ""
    task_id: int = -1
    err_message: str = ""


@register_message
@dataclass
class TaskBatchRequest(JsonSerializable):
    """Batched shard lease: up to ``count`` tasks in one envelope.
    ``wait_timeout > 0`` long-polls server-side until at least one task
    is dispatchable (or the dataset finishes) instead of returning a
    WAIT task for the client to sleep-poll on."""

    dataset_name: str = ""
    count: int = 1
    wait_timeout: float = 0.0


@register_message
@dataclass
class TaskBatch(JsonSerializable):
    tasks: List[Task] = field(default_factory=list)
    # True once every shard of the dataset is dispatched AND completed:
    # an empty batch + finished means stop; empty + not finished means
    # re-poll (tasks are in flight on other workers)
    finished: bool = False


@register_message
@dataclass
class TaskResults(JsonSerializable):
    """Batched completion report: ack several task ids in one envelope
    (the completion-side pair of :class:`TaskBatchRequest`)."""

    dataset_name: str = ""
    task_ids: List[int] = field(default_factory=list)
    err_message: str = ""


@register_message
@dataclass
class DatasetShardParams(JsonSerializable):
    batch_size: int = 0
    num_epochs: int = 0
    dataset_size: int = 0
    shuffle: bool = False
    num_minibatches_per_shard: int = 0
    dataset_name: str = ""
    task_type: str = ""
    storage_type: str = ""  # table / text
    splitter: str = ""  # batch / streaming


@register_message
@dataclass
class ShardCheckpointRequest(JsonSerializable):
    dataset_name: str = ""


@register_message
@dataclass
class ShardCheckpoint(JsonSerializable):
    content: str = ""  # JSON dump of splitter + todo/doing state


@register_message
@dataclass
class DatasetEpochRequest(JsonSerializable):
    dataset_name: str = ""


@register_message
@dataclass
class DatasetEpoch(JsonSerializable):
    epoch: int = 0


# --------------------------------------------------------------------------
# Rendezvous (reference: JoinRendezvousRequest, comm world queries)
# --------------------------------------------------------------------------


@register_message
@dataclass
class NodeMeta(JsonSerializable):
    """Per-host metadata gathered at rendezvous join time."""

    node_id: int = -1
    node_rank: int = -1
    process_unit: int = 1  # local device (chip) count
    addr: str = ""
    slice_id: int = 0  # TPU pod-slice index (DCN domain)
    topology_label: str = ""  # e.g. GKE topology key for rank sorting


@register_message
@dataclass
class JoinRendezvousRequest(JsonSerializable):
    node_id: int = -1
    node_rank: int = -1
    local_world_size: int = 1
    node_ip: str = ""
    rdzv_name: str = ""
    slice_id: int = 0
    node_unit: int = 1
    topology_label: str = ""


@register_message
@dataclass
class JoinRendezvousResponse(JsonSerializable):
    round: int = 0


@register_message
@dataclass
class CommWorldRequest(JsonSerializable):
    rdzv_name: str = ""
    node_id: int = -1


@register_message
@dataclass
class RdzvWaitRequest(JsonSerializable):
    """Long-poll variant of :class:`CommWorldRequest`: the server blocks
    (bounded by ``timeout``, clamped to ``DLROVER_TPU_LONGPOLL_MAX_S``)
    until a world including ``node_id`` is published, waking exactly
    when the manager's time-based completion rule can fire instead of
    the client probing once a second.  Reply is a :class:`CommWorld`;
    an empty world means the bounded wait expired."""

    rdzv_name: str = ""
    node_id: int = -1
    timeout: float = 30.0


@register_message
@dataclass
class CommWorld(JsonSerializable):
    """The agreed world: node_rank -> NodeMeta (reference:
    rdzv_manager.get_comm_world ``rdzv_manager.py:448``).

    The ``jax.distributed`` coordinator address is NOT part of the world:
    the rank-0 agent binds a free port after the round completes and
    publishes it through the master KV store (see
    ``ElasticAgent._setup_coordinator``).
    """

    rdzv_name: str = ""
    round: int = 0
    group: int = 0
    world: Dict[int, NodeMeta] = field(default_factory=dict)


@register_message
@dataclass
class WaitingNodeNumRequest(JsonSerializable):
    node_id: int = -1
    local_world_size: int = 1
    rdzv_name: str = ""


@register_message
@dataclass
class WaitingNodeNum(JsonSerializable):
    waiting_num: int = 0


# --------------------------------------------------------------------------
# Network / node check
# --------------------------------------------------------------------------


@register_message
@dataclass
class NetworkReadyRequest(JsonSerializable):
    pass


@register_message
@dataclass
class NetworkCheckResultRequest(JsonSerializable):
    node_id: int = -1
    normal: bool = True
    elapsed_time: float = 0.0
    err_message: str = ""


@register_message
@dataclass
class NetworkStatus(JsonSerializable):
    nodes_ready: bool = False
    reason: str = ""


@register_message
@dataclass
class StragglerExistRequest(JsonSerializable):
    pass


@register_message
@dataclass
class NetworkCheckStatus(JsonSerializable):
    fault_nodes: List[int] = field(default_factory=list)
    straggler_nodes: List[int] = field(default_factory=list)
    reason: str = ""


# --------------------------------------------------------------------------
# KV store (backs jax.distributed coordination & user barriers)
# --------------------------------------------------------------------------


@register_message
@dataclass
class KeyValuePair(JsonSerializable):
    key: str = ""
    value: bytes = b""


@register_message
@dataclass
class KeyValuePairs(JsonSerializable):
    kvs: Dict[str, bytes] = field(default_factory=dict)


@register_message
@dataclass
class KVStoreGetRequest(JsonSerializable):
    key: str = ""


@register_message
@dataclass
class KVStoreMultiGetRequest(JsonSerializable):
    keys: List[str] = field(default_factory=list)


@register_message
@dataclass
class KVStoreAddRequest(JsonSerializable):
    key: str = ""
    amount: int = 0


@register_message
@dataclass
class KVStoreAddResponse(JsonSerializable):
    value: int = 0


@register_message
@dataclass
class KVStoreDeleteRequest(JsonSerializable):
    key: str = ""


@register_message
@dataclass
class KVStoreWaitRequest(JsonSerializable):
    """Server-side long-poll: block on the store's Condition until the
    key exists (``min_value=0``) or until its integer value reaches
    ``min_value`` (counter barriers), bounded by ``timeout`` — the
    long-poll primitive replacing client sleep-poll loops.  The server
    clamps ``timeout`` to ``DLROVER_TPU_LONGPOLL_MAX_S``; an empty
    value in the reply means the bounded wait expired (re-issue until
    the caller's own deadline)."""

    key: str = ""
    timeout: float = 30.0
    min_value: int = 0


@register_message
@dataclass
class KVStorePutIndexedRequest(JsonSerializable):
    """Atomic publish: the server assigns the next per-key sequence
    number and stores ``seq|value`` in one critical section (backs
    RoleChannel's latest-wins slot)."""

    key: str = ""
    value: bytes = b""


# --------------------------------------------------------------------------
# Node lifecycle / heartbeat / diagnosis
# --------------------------------------------------------------------------


@register_message
@dataclass
class HeartBeat(JsonSerializable):
    """``digest`` piggybacks this node's compact health summary on the
    heartbeat it already sends: per-rank step-time digest
    (``last_step``/``step_p50_s``/``step_max_s`` from the flight
    recorder's step ring) and checkpoint-saver busy time
    (``ckpt_busy_s``).  One data source feeds the master's laggard-set
    logic, the step-time straggler diagnostician, and the
    checkpoint-stall diagnostician; older peers deserialize fine — the
    field defaults."""

    node_id: int = -1
    timestamp: float = 0.0
    digest: Dict[str, float] = field(default_factory=dict)


@register_message
@dataclass
class HeartbeatResponse(JsonSerializable):
    """Piggybacks diagnosis actions back to the agent (reference:
    master_client.report_heart_beat ``master_client.py:238``)."""

    diagnosis_actions: List[Any] = field(default_factory=list)


@register_message
@dataclass
class NodeEventRequest(JsonSerializable):
    node_id: int = -1
    node_type: str = ""
    event_type: str = ""
    reason: str = ""
    message: str = ""


@register_message
@dataclass
class NodeFailureRequest(JsonSerializable):
    node_id: int = -1
    error_data: str = ""
    level: str = ""
    restart_count: int = 0


@register_message
@dataclass
class ResourceStats(JsonSerializable):
    cpu_percent: float = 0.0
    memory_mb: int = 0
    tpu_stats: List[Dict[str, float]] = field(default_factory=list)
    # this node's local step watermark (-1 = unknown): feeds the master's
    # per-node laggard screen; only rank 0 reports the job-level GlobalStep
    step: int = -1


@register_message
@dataclass
class GlobalStep(JsonSerializable):
    timestamp: float = 0.0
    step: int = 0
    elapsed_time_per_step: float = 0.0


@register_message
@dataclass
class ModelInfo(JsonSerializable):
    num_params: int = 0
    num_layers: int = 0
    hidden_size: int = 0
    seq_len: int = 0
    flops_per_step: float = 0.0
    batch_size_per_device: int = 0


@register_message
@dataclass
class ParallelConfigRequest(JsonSerializable):
    pass


@register_message
@dataclass
class DataLoaderConfig(JsonSerializable):
    dataloader_name: str = ""
    batch_size: int = 0
    num_workers: int = 0
    prefetch_count: int = 0
    version: int = 0


@register_message
@dataclass
class OptimizerConfig(JsonSerializable):
    learning_rate: float = 0.0
    micro_batch_size: int = 0
    grad_accum_steps: int = 1
    version: int = 0


@register_message
@dataclass
class ParallelConfig(JsonSerializable):
    """Mesh shape suggestion exchanged master<->worker (replaces the
    reference's dataloader/optimizer-only tuning with TPU mesh tuning)."""

    dataloader: DataLoaderConfig = field(default_factory=DataLoaderConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    mesh_axes: Dict[str, int] = field(default_factory=dict)  # dp/fsdp/tp/cp/ep
    restart: bool = False


@register_message
@dataclass
class DiagnosisReportData(JsonSerializable):
    data_type: str = ""
    data_content: str = ""
    node_id: int = -1
    node_type: str = ""
    node_rank: int = -1


@register_message
@dataclass
class HangDetectionReport(JsonSerializable):
    node_id: int = -1
    hung: bool = False
    last_active_ts: float = 0.0
    detail: str = ""


@register_message
@dataclass
class IncidentDumpReport(JsonSerializable):
    """An agent's flight-recorder snapshot answering a broadcast
    ``flight_dump`` action: ``payload`` is the JSON snapshot
    (``observability/flight_recorder.py``), collected into the
    incident's directory by the master's IncidentManager."""

    incident_id: str = ""
    node_id: int = -1
    payload: str = ""


@register_message
@dataclass
class BrainActionAck(JsonSerializable):
    """An agent acknowledging processed Brain v2 actions (the ids from
    each action's ``extra["brain"]["id"]`` envelope).  The servicer
    routes acks to the attached fleet arbiter's
    :class:`~dlrover_tpu.brain.actions.ActionTracker` — the other half
    of the never-silently-dropped delivery contract."""

    job: str = ""
    node_id: int = -1
    action_ids: List[str] = field(default_factory=list)


# --------------------------------------------------------------------------
# Pre-check / job status / sync
# --------------------------------------------------------------------------


@register_message
@dataclass
class PreCheckRequest(JsonSerializable):
    node_id: int = -1


@register_message
@dataclass
class PreCheckResponse(JsonSerializable):
    status: str = ""  # PreCheckStatus


@register_message
@dataclass
class TrainingStatusRequest(JsonSerializable):
    pass


@register_message
@dataclass
class TrainingStatus(JsonSerializable):
    status: int = 3  # TrainingLoopStatus


@register_message
@dataclass
class SyncJoin(JsonSerializable):
    sync_name: str = ""
    node_id: int = -1
    node_rank: int = -1


@register_message
@dataclass
class SyncFinish(JsonSerializable):
    sync_name: str = ""


@register_message
@dataclass
class SyncBarrierRequest(JsonSerializable):  # graftlint: disable=GL902 (deliberate dual demux: notify=True routes to report, polls route to get; is_report_message special-cases it so it must stay OUT of REPORT_MESSAGE_TYPES)
    barrier_name: str = ""
    notify: bool = False


@register_message
@dataclass
class ElasticRunConfigRequest(JsonSerializable):
    pass


@register_message
@dataclass
class ElasticRunConfig(JsonSerializable):
    configs: Dict[str, str] = field(default_factory=dict)


@register_message
@dataclass
class SucceededRequest(JsonSerializable):
    node_id: int = -1
    node_type: str = ""


@register_message
@dataclass
class NodeCountRequest(JsonSerializable):
    pass


@register_message
@dataclass
class NodeCount(JsonSerializable):
    count: int = 0


@register_message
@dataclass
class ScaleRequest(JsonSerializable):
    """User- or controller-initiated scale request (node group -> target
    count)."""

    node_type: str = "worker"
    count: int = 0


@register_message
@dataclass
class CheckpointReadyRequest(JsonSerializable):
    """UCP-style gate: block rendezvous until checkpoint conversion done
    (reference UcpRdzvManager ``rdzv_manager.py:583``)."""

    node_id: int = -1
    ready: bool = True


# --------------------------------------------------------------------------
# Distributed checkpoint commit (two-phase, master-coordinated)
# --------------------------------------------------------------------------


@register_message
@dataclass
class CkptManifestReport(JsonSerializable):
    """Phase-1 of the distributed checkpoint commit: one host's manifest
    of the owned shards it persisted for ``step`` (per-shard
    file/offset/nbytes/CRC records as JSON).  The master's
    ``CkptCommitCoordinator`` seals the step once the manifest union
    covers the global pytree."""

    ckpt_dir: str = ""
    step: int = -1
    process_id: int = -1
    num_processes: int = 1
    manifest: str = ""  # JSON (distributed.HostShardWriter.persist)


@register_message
@dataclass
class CkptCommitStatusRequest(JsonSerializable):
    """Seal-status query for one (ckpt_dir, step); ``step=-1`` asks only
    for the directory's committed watermark."""

    ckpt_dir: str = ""
    step: int = -1


@register_message
@dataclass
class CkptCommitStatus(JsonSerializable):
    step: int = -1
    sealed: bool = False
    committed_step: int = -1
    reported: int = 0
    expected: int = 0
    reason: str = ""


# --------------------------------------------------------------------------
# Peer-replicated restore (checkpoint-free fast recovery)
# --------------------------------------------------------------------------


@register_message
@dataclass
class PeerSnapshotAnnounce(JsonSerializable):
    """One host advertising a committed shm snapshot it can serve: the
    master's ``PeerRestoreBroker`` records (scope, process, step, addr)
    so a replacement host can be pointed at a surviving donor instead of
    walking storage."""

    scope: str = ""
    process_id: int = -1
    num_processes: int = 1
    step: int = -1
    addr: str = ""  # host:port of the agent-side peer serve endpoint


@register_message
@dataclass
class PeerAssignmentRequest(JsonSerializable):
    """A recovering host asking the broker who serves its lost shards.
    ``group`` is the requester's replica group (process ids holding
    byte-identical shards, from ``plan_dist_shards``); empty means "any
    announced peer of this scope"."""

    scope: str = ""
    process_id: int = -1
    step: int = -1  # -1 = latest announced
    group: List[int] = field(default_factory=list)


@register_message
@dataclass
class PeerAssignment(JsonSerializable):
    """Broker verdict: ordered donor candidates (fastest first) for the
    requested scope/step.  ``donors`` maps process id -> serve addr."""

    step: int = -1
    donors: Dict[str, str] = field(default_factory=dict)


@register_message
@dataclass
class RecoveryReport(JsonSerializable):
    """One finished recovery, priced: which ladder rung restored the
    state, wall-clock MTTR, and the peer-read bandwidth.  Feeds the
    master time-series store (``job.recovery.*``), the ``/recovery``
    dashboard endpoint, and the MTTR-budget sentinel."""

    scope: str = ""
    process_id: int = -1
    step: int = -1
    rung: str = ""  # peer_shm | manifest | storage | fresh
    mttr_s: float = 0.0
    peer_read_gbps: float = 0.0
    bytes_peer: int = 0
    bytes_manifest: int = 0
    storage_reads: int = 0
    torn_retries: int = 0
    demoted_peers: List[int] = field(default_factory=list)
    cache_prewarmed: int = 0
    budget_s: float = 0.0
    over_budget: bool = False


# --------------------------------------------------------------------------
# Generic request coalescing
# --------------------------------------------------------------------------


@register_message
@dataclass
class BatchRequest(JsonSerializable):
    """Several control-plane requests in one envelope: each item is one
    serialized message (``serialize_message`` bytes), dispatched through
    the get or report demux by its class.  Sub-requests are independent:
    one failing yields a failed :class:`BaseResponse` in its slot, the
    rest still execute.  Admission control charges the envelope once,
    not per item — batching is how a chatty client gets cheap under an
    overloaded master."""

    items: List[bytes] = field(default_factory=list)


@register_message
@dataclass
class BatchResponse(JsonSerializable):
    """Positional replies: ``items[i]`` is the serialized response to
    ``BatchRequest.items[i]``."""

    items: List[bytes] = field(default_factory=list)


#: request classes served by the ``report`` demux (everything else goes
#: through ``get``).  One registry shared by the servicer's batch
#: dispatch and the client's batch fallback, so the two ends can never
#: disagree about which half of the demux a sub-request belongs to.
#: ``SyncBarrierRequest`` is the one dual-demux type: ``notify=True``
#: reports, otherwise it queries.
REPORT_MESSAGE_TYPES = (
    DatasetShardParams,
    TaskResult,
    TaskResults,
    ShardCheckpoint,
    KeyValuePair,
    KeyValuePairs,
    NetworkCheckResultRequest,
    GlobalStep,
    ModelInfo,
    ResourceStats,
    NodeEventRequest,
    NodeFailureRequest,
    DiagnosisReportData,
    HangDetectionReport,
    IncidentDumpReport,
    BrainActionAck,
    CkptManifestReport,
    PeerSnapshotAnnounce,
    RecoveryReport,
    SyncJoin,
    SyncFinish,
    SucceededRequest,
    ParallelConfig,
    CheckpointReadyRequest,
    ScaleRequest,
)


def is_report_message(msg: Any) -> bool:
    """True when ``msg`` dispatches through the report demux."""
    if isinstance(msg, SyncBarrierRequest):
        return bool(msg.notify)
    return isinstance(msg, REPORT_MESSAGE_TYPES)


def message_to_dict(msg: Any) -> Dict[str, Any]:
    if dataclasses.is_dataclass(msg) and not isinstance(msg, type):
        return dataclasses.asdict(msg)
    raise TypeError(f"not a dataclass message: {type(msg)}")
