"""Master RPC servicer: two methods, demuxed by message class.

Copy of ``dlrover_tpu/master/servicer.py``, the counterpart of DLRover's
``dlrover/python/master/servicer.py`` (``get:152``, ``report:438``,
``create_master_service:1074``): every control-plane interaction is either
a ``get`` (request→typed response) or a ``report`` (fire→ack), dispatched
on the dataclass type inside the envelope.  New features add a dataclass +
handler, never a service method.

An agent's flight dump (``IncidentDumpReport``) lands in its incident
through the attached incident engine (the local master attaches one).  A
heartbeat digest feeds the metric context and the time-series store
(``self.timeseries``, ``master/timeseries.py``); a ``RecoveryReport``
feeds the peer broker and the store.  The task manager's shard leases,
completions and backlog feed ``datascope``'s ``ShardTelemetry``
(``self.shard_telemetry``), which flushes into the store and backs the
``/metrics`` data gauges.  What differs from the copy (ROADMAP item 11,
the rest): the brain ack answers as the reference's servicer does with no
brain attached.
"""

import time
from typing import Any, Dict, Optional

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import (
    JobStage,
    NodeStatus,
    NodeType,
    PreCheckStatus,
    TrainingLoopStatus,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.node import Node, NodeEvent
from dlrover_tpu_torch.common.coalesce import WaitHub
from dlrover_tpu_torch.observability import metrics as obs_metrics
from dlrover_tpu_torch.observability import trace
from dlrover_tpu_torch.master.admission import AdmissionController
from dlrover_tpu_torch.master.job_context import get_job_context
from dlrover_tpu_torch.master.kv_store import KVStoreService
from dlrover_tpu_torch.master.perf_monitor import PerfMonitor
from dlrover_tpu_torch.master.rdzv_manager import RendezvousManager
from dlrover_tpu_torch.master.sync_service import SyncService
from dlrover_tpu_torch.master.task_manager import TaskManager


class MasterServicer:
    """Wires the master components behind the report/get demux."""

    def __init__(
        self,
        task_manager: Optional[TaskManager] = None,
        rdzv_managers: Optional[Dict[str, RendezvousManager]] = None,
        perf_monitor: Optional[PerfMonitor] = None,
        kv_store: Optional[KVStoreService] = None,
        sync_service: Optional[SyncService] = None,
        job_manager: Any = None,
        diagnosis_manager: Any = None,
        elastic_run_config: Optional[Dict[str, str]] = None,
        incident_manager: Any = None,
        ckpt_coordinator: Any = None,
    ):
        self._task_manager = task_manager or TaskManager()
        self._rdzv_managers = rdzv_managers or {}
        self._perf_monitor = perf_monitor or PerfMonitor()
        self._kv_store = kv_store or KVStoreService()
        self._sync_service = sync_service or SyncService()
        self._job_manager = job_manager
        self._diagnosis_manager = diagnosis_manager
        self._incident_manager = incident_manager
        self._brain: Any = None
        self._elastic_run_config = elastic_run_config or {}
        self._job_context = get_job_context()
        from dlrover_tpu_torch.master.metric_context import JobMetricContext
        from dlrover_tpu_torch.master.timeseries import TimeSeriesStore

        self.metric_context = JobMetricContext()
        # the goodput/step-time history the dashboard, the /metrics pull
        # gauges and the regression sentinels read
        self.timeseries = TimeSeriesStore()
        self.timeseries.register_pull_gauges()
        # datascope: shard-lifecycle telemetry observed from the
        # dispatcher's seat, flushed into the time-series store (the
        # /data endpoint, pull gauges and data sentinels read it)
        from dlrover_tpu_torch.observability import datascope

        self.shard_telemetry = datascope.ShardTelemetry(self.timeseries)
        if datascope.enabled():
            self._task_manager.set_telemetry(self.shard_telemetry)
            self.timeseries.register_data_gauges(self.shard_telemetry)
        self._start_training_time = 0.0
        self._pre_check_status = PreCheckStatus.PASS
        self._admission = AdmissionController()
        self._wait_hub = WaitHub()
        if ckpt_coordinator is None:
            from dlrover_tpu_torch.master.ckpt_coordinator import (
                CkptCommitCoordinator,
            )

            ckpt_coordinator = CkptCommitCoordinator()
        self._ckpt_coordinator = ckpt_coordinator
        from dlrover_tpu_torch.master.ckpt_coordinator import PeerRestoreBroker

        # peer-restore directory: who can serve which shm snapshot step
        # (announce/assign routes below; the /recovery dashboard and the
        # MTTR sentinel read its snapshot/recoveries)
        self._peer_broker = PeerRestoreBroker()

    @property
    def kv_store(self) -> KVStoreService:
        return self._kv_store

    @property
    def ckpt_coordinator(self) -> Any:
        """The distributed-checkpoint commit coordinator (phase-1
        manifests + seal status route here; the dashboard reads its
        snapshot)."""
        return self._ckpt_coordinator

    @property
    def peer_broker(self) -> Any:
        """The peer-restore broker (snapshot announcements, donor
        assignment, recovery reports; the ``/recovery`` dashboard and
        the MTTR sentinel read it)."""
        return self._peer_broker

    @property
    def task_manager(self) -> TaskManager:
        return self._task_manager

    def set_pre_check_status(self, status: str):
        self._pre_check_status = status

    def set_incident_manager(self, incident_manager: Any):
        """Attach the incident engine so agent flight dumps
        (``IncidentDumpReport``) land in their incident directory."""
        self._incident_manager = incident_manager

    def set_brain(self, brain: Any):
        """Attach a Brain v2 endpoint (an in-process fleet arbiter, or a
        forwarding shim for a remote brain) so agent ``BrainActionAck``
        reports reach its action tracker.  The port has no brain yet
        (ROADMAP item 11, the rest)."""
        self._brain = brain

    # ------------------------------------------------------------------
    # get: request -> typed response
    # ------------------------------------------------------------------

    _LONGPOLL_MARKERS = (
        b'"__cls__":"KVStoreWaitRequest"',
        b'"__cls__":"RdzvWaitRequest"',
        b'"__cls__":"TaskBatchRequest"',
    )

    @classmethod
    def _is_longpoll(cls, request: Any) -> bool:
        """Long-polls block (cheaply) for up to the long-poll chunk, so
        they are admitted from the larger ``wait`` pool.  A BatchRequest
        is classified by sniffing its raw items for a long-poll class
        marker (cheap substring check; deserializing every item twice
        just to admit it would defeat the point of batching)."""
        if isinstance(request, (comm.KVStoreWaitRequest,
                                comm.RdzvWaitRequest)):
            return True
        if isinstance(request, comm.TaskBatchRequest):
            return request.wait_timeout > 0
        if isinstance(request, comm.BatchRequest):
            return any(
                marker in raw
                for raw in request.items
                for marker in cls._LONGPOLL_MARKERS
            )
        return False

    def _overload_reply(
        self, method: str, wait: bool, node_type: str, node_id: int
    ) -> comm.Message:
        """The shed path: no span, no dispatch — one cheap typed refusal
        carrying the backpressure hint."""
        hint = self._admission.retry_after_s(wait=wait)
        obs_metrics.observe_rpc(
            method, False, 0.0, code="overload", record_duration=False
        )
        reply = comm.Message(node_type=node_type, node_id=node_id)
        reply.pack(comm.BaseResponse(
            success=False, reason=comm.OVERLOADED, retry_after_s=hint
        ))
        return reply

    def get(self, envelope: comm.Message) -> comm.Message:
        request = envelope.unpack()
        node_type, node_id = envelope.node_type, envelope.node_id
        method = type(request).__name__
        is_wait = self._is_longpoll(request)
        pool = self._admission.admit(method, wait=is_wait)
        if pool is None:
            return self._overload_reply(method, is_wait, node_type, node_id)
        response: Any = comm.BaseResponse()
        ok, t0 = True, time.monotonic()
        try:
            # the server span parents to the caller's attempt span via
            # the envelope's traceparent — the cross-process link the
            # merged timeline draws its flow arrows from
            with trace.server_span(
                f"master.get/{method}",
                getattr(envelope, "trace_ctx", ""),
                attrs={"node_id": node_id, "node_type": node_type},
            ):
                try:
                    response = self._get_dispatch(
                        request, node_type, node_id
                    )
                except Exception as e:  # noqa: BLE001 - RPC must not crash
                    logger.exception("get(%s) failed", method)
                    response = comm.BaseResponse(
                        success=False, reason=str(e)
                    )
                    ok = False
        finally:
            pool.release()
        # a long-poll's blocked time is intentional, not service time:
        # keep it out of the duration histogram (the dedicated
        # longpoll_wait_seconds sink records it) or an idle fleet's
        # 30s waits would read as the master being seconds-slow
        obs_metrics.observe_rpc(
            method, ok, time.monotonic() - t0, record_duration=not is_wait
        )
        reply = comm.Message(node_type=node_type, node_id=node_id)
        reply.pack(response)
        return reply

    def _get_dispatch(self, request: Any, node_type: str, node_id: int) -> Any:
        if isinstance(request, comm.TaskRequest):
            return self._get_task(node_id, request)
        if isinstance(request, comm.JoinRendezvousRequest):
            return self._join_rendezvous(request)
        if isinstance(request, comm.CommWorldRequest):
            return self._get_comm_world(request)
        if isinstance(request, comm.WaitingNodeNumRequest):
            return self._num_nodes_waiting(request)
        if isinstance(request, comm.NetworkReadyRequest):
            return self._check_network_ready()
        if isinstance(request, comm.StragglerExistRequest):
            return self._get_straggler()
        if isinstance(request, comm.KVStoreGetRequest):
            return comm.KeyValuePair(
                key=request.key, value=self._kv_store.get(request.key)
            )
        if isinstance(request, comm.KVStoreWaitRequest):
            return self._kv_wait(request)
        if isinstance(request, comm.RdzvWaitRequest):
            return self._rdzv_wait(request)
        if isinstance(request, comm.TaskBatchRequest):
            return self._task_batch(node_id, request)
        if isinstance(request, comm.BatchRequest):
            return self._dispatch_batch(request, node_type, node_id)
        if isinstance(request, comm.KVStoreMultiGetRequest):
            return comm.KeyValuePairs(
                kvs=self._kv_store.multi_get(request.keys)
            )
        if isinstance(request, comm.KVStoreAddRequest):
            return comm.KVStoreAddResponse(
                value=self._kv_store.add(request.key, request.amount)
            )
        if isinstance(request, comm.KVStorePutIndexedRequest):
            return comm.KVStoreAddResponse(
                value=self._kv_store.put_indexed(
                    request.key, request.value
                )
            )
        if isinstance(request, comm.KVStoreDeleteRequest):
            return comm.KVStoreAddResponse(
                value=int(self._kv_store.delete(request.key))
            )
        if isinstance(request, comm.HeartBeat):
            return self._report_heartbeat(node_id, request)
        if isinstance(request, comm.PreCheckRequest):
            return comm.PreCheckResponse(status=self._pre_check_status)
        if isinstance(request, comm.TrainingStatusRequest):
            return self._get_training_status()
        if isinstance(request, comm.ShardCheckpointRequest):
            content = self._task_manager.get_dataset_checkpoint(
                request.dataset_name
            )
            return comm.ShardCheckpoint(content=content)
        if isinstance(request, comm.DatasetEpochRequest):
            return comm.DatasetEpoch(
                epoch=self._task_manager.get_dataset_epoch(request.dataset_name)
            )
        if isinstance(request, comm.ElasticRunConfigRequest):
            return comm.ElasticRunConfig(configs=dict(self._elastic_run_config))
        if isinstance(request, comm.NodeCountRequest):
            return comm.NodeCount(
                count=len(self._job_context.alive_node_ids(NodeType.WORKER))
            )
        if isinstance(request, comm.CkptCommitStatusRequest):
            status = self._ckpt_coordinator.status(
                request.ckpt_dir, request.step
            )
            return comm.CkptCommitStatus(
                step=status["step"],
                sealed=status["sealed"],
                committed_step=status["committed_step"],
                reported=status["reported"],
                expected=status["expected"],
                reason=status["reason"],
            )
        if isinstance(request, comm.PeerAssignmentRequest):
            verdict = self._peer_broker.assign(
                request.scope,
                request.process_id if request.process_id >= 0 else node_id,
                step=request.step,
                group=request.group,
            )
            return comm.PeerAssignment(
                step=verdict["step"], donors=verdict["donors"]
            )
        if isinstance(request, comm.SyncBarrierRequest):
            ready = self._sync_service.barrier_ready(request.barrier_name)
            return comm.BaseResponse(success=ready)
        if isinstance(request, comm.ParallelConfigRequest):
            node = self._job_context.job_node(node_type, node_id)
            if node is not None and node.paral_config is not None:
                return node.paral_config
            return comm.ParallelConfig()
        raise ValueError(f"unknown get request: {type(request).__name__}")

    def _get_task(self, node_id: int, request: comm.TaskRequest) -> comm.Task:
        task = self._task_manager.get_dataset_task(node_id, request.dataset_name)
        return self._task_to_wire(task)

    @staticmethod
    def _task_to_wire(task: Any) -> comm.Task:
        if task is None:
            return comm.Task()
        return comm.Task(
            task_id=task.task_id,
            task_type=task.task_type,
            shard=comm.Shard(
                name=task.shard.name,
                start=task.shard.start,
                end=task.shard.end,
                record_indices=list(task.shard.record_indices),
            ),
        )

    # -- long-poll / batch handlers ------------------------------------

    @staticmethod
    def _clamp_longpoll(timeout: float) -> float:
        """Server-side ceiling on any blocking wait: a client asking for
        minutes gets chunked, so a dead client can pin a wait slot for
        at most DLROVER_TPU_LONGPOLL_MAX_S."""
        from dlrover_tpu_torch.common import envs

        return max(
            0.0, min(float(timeout), envs.get_float(
                "DLROVER_TPU_LONGPOLL_MAX_S"
            ))
        )

    def _kv_wait(self, request: comm.KVStoreWaitRequest) -> comm.KeyValuePair:
        timeout = self._clamp_longpoll(request.timeout)
        t0 = time.monotonic()
        # identical waits coalesce: one leader blocks on the store's
        # Condition per (key, threshold); followers park on an Event
        value = self._wait_hub.wait(
            ("kv", request.key, request.min_value),
            lambda: self._kv_store.wait(
                request.key, timeout, request.min_value
            ),
            timeout,
        )
        obs_metrics.observe_longpoll(
            "kv", time.monotonic() - t0, bool(value)
        )
        return comm.KeyValuePair(key=request.key, value=value)

    def _rdzv_wait(self, request: comm.RdzvWaitRequest) -> comm.CommWorld:
        manager = self._rdzv_managers.get(request.rdzv_name)
        if manager is None:
            raise ValueError(f"no rendezvous manager {request.rdzv_name}")
        timeout = self._clamp_longpoll(request.timeout)
        t0 = time.monotonic()
        round_, group, world = manager.wait_comm_world(
            request.node_id, timeout
        )
        obs_metrics.observe_longpoll(
            "rdzv", time.monotonic() - t0, bool(world)
        )
        return comm.CommWorld(
            rdzv_name=request.rdzv_name,
            round=round_,
            group=group,
            world=world,
        )

    def _task_batch(
        self, node_id: int, request: comm.TaskBatchRequest
    ) -> comm.TaskBatch:
        timeout = self._clamp_longpoll(request.wait_timeout)
        if timeout > 0:
            t0 = time.monotonic()
            tasks, finished = self._task_manager.wait_dataset_tasks(
                node_id, request.dataset_name, request.count, timeout
            )
            obs_metrics.observe_longpoll(
                "task", time.monotonic() - t0, bool(tasks) or finished
            )
        else:
            tasks, finished = self._task_manager.lease_dataset_tasks(
                node_id, request.dataset_name, request.count
            )
        return comm.TaskBatch(
            tasks=[self._task_to_wire(t) for t in tasks],
            finished=finished,
        )

    def _dispatch_batch(
        self, request: comm.BatchRequest, node_type: str, node_id: int
    ) -> comm.BatchResponse:
        """Run each sub-request through its demux half.  Failures are
        positional, not fatal: one bad item yields a failed BaseResponse
        in its slot and the rest still execute."""
        from dlrover_tpu_torch.common.serialize import (
            deserialize_message,
            serialize_message,
        )

        from dlrover_tpu_torch.common import envs

        # the client transport timeout is sized for ONE long-poll chunk,
        # so the envelope's CUMULATIVE blocking time shares one budget:
        # two slow waits back-to-back would outlive the client's deadline
        # and the retried envelope would re-execute non-idempotent
        # siblings (a barrier's add double-counted)
        budget_deadline = time.monotonic() + envs.get_float(
            "DLROVER_TPU_LONGPOLL_MAX_S"
        )
        items = []
        for raw in request.items:
            try:
                sub = deserialize_message(raw)
                if isinstance(sub, comm.BatchRequest):
                    raise ValueError("nested BatchRequest not allowed")
                remaining = max(0.0, budget_deadline - time.monotonic())
                if isinstance(
                    sub, (comm.KVStoreWaitRequest, comm.RdzvWaitRequest)
                ):
                    sub.timeout = min(float(sub.timeout), remaining)
                elif isinstance(sub, comm.TaskBatchRequest):
                    sub.wait_timeout = min(
                        float(sub.wait_timeout), remaining
                    )
                if comm.is_report_message(sub):
                    ok = self._report_dispatch(sub, node_type, node_id)
                    resp: Any = comm.BaseResponse(success=bool(ok))
                else:
                    resp = self._get_dispatch(sub, node_type, node_id)
            except Exception as e:  # noqa: BLE001 - positional failure
                resp = comm.BaseResponse(success=False, reason=str(e))
            items.append(serialize_message(resp))
        return comm.BatchResponse(items=items)

    def _join_rendezvous(
        self, request: comm.JoinRendezvousRequest
    ) -> comm.JoinRendezvousResponse:
        manager = self._rdzv_managers.get(request.rdzv_name)
        if manager is None:
            raise ValueError(f"no rendezvous manager {request.rdzv_name}")
        round_ = manager.join_rendezvous(
            request.node_id,
            request.node_rank,
            request.local_world_size,
            node_ip=request.node_ip,
            slice_id=request.slice_id,
            topology_label=request.topology_label,
            node_unit=request.node_unit,
        )
        if self._job_context.get_job_stage() == JobStage.INIT:
            self._job_context.update_job_stage(JobStage.RENDEZVOUS)
        return comm.JoinRendezvousResponse(round=round_)

    def _get_comm_world(self, request: comm.CommWorldRequest) -> comm.CommWorld:
        manager = self._rdzv_managers.get(request.rdzv_name)
        if manager is None:
            raise ValueError(f"no rendezvous manager {request.rdzv_name}")
        round_, group, world = manager.get_comm_world(request.node_id)
        return comm.CommWorld(
            rdzv_name=request.rdzv_name,
            round=round_,
            group=group,
            world=world,
        )

    def _num_nodes_waiting(
        self, request: comm.WaitingNodeNumRequest
    ) -> comm.WaitingNodeNum:
        manager = self._rdzv_managers.get(request.rdzv_name)
        waiting = manager.num_nodes_waiting() if manager else 0
        return comm.WaitingNodeNum(waiting_num=waiting)

    def _check_network_ready(self) -> comm.NetworkStatus:
        from dlrover_tpu_torch.common.constants import RendezvousName

        manager = self._rdzv_managers.get(RendezvousName.NETWORK_CHECK)
        if manager is None:
            return comm.NetworkStatus(nodes_ready=True)
        success = manager.network_check_success()
        fault, reason = manager.check_fault_node()
        return comm.NetworkStatus(nodes_ready=success, reason=reason)

    def _get_straggler(self) -> comm.NetworkCheckStatus:
        from dlrover_tpu_torch.common.constants import RendezvousName

        manager = self._rdzv_managers.get(RendezvousName.NETWORK_CHECK)
        if manager is None:
            return comm.NetworkCheckStatus()
        fault, reason = manager.check_fault_node()
        stragglers, _ = manager.get_straggler()
        return comm.NetworkCheckStatus(
            fault_nodes=fault, straggler_nodes=stragglers, reason=reason
        )

    def _report_heartbeat(
        self, node_id: int, request: comm.HeartBeat
    ) -> comm.HeartbeatResponse:
        node = self._job_context.job_node(NodeType.WORKER, node_id)
        if node is not None:
            node.heartbeat_time = request.timestamp or time.time()
        if request.digest:
            # the per-rank step-time/ckpt-busy digest: one feed for the
            # laggard screens and the straggler/ckpt-stall diagnosticians
            self.metric_context.record_step_digest(node_id, request.digest)
            # the same digest carries the cumulative goodput-ledger
            # account (gp_* keys): differentiate into the time series
            # the sentinels read
            try:
                self.timeseries.record_digest(node_id, request.digest)
            except Exception as e:  # noqa: BLE001 - history is best-
                logger.warning("timeseries digest feed failed: %s", e)
                # effort; the heartbeat must still be answered
        actions = self._job_context.next_actions(node_id)
        return comm.HeartbeatResponse(diagnosis_actions=actions)

    def _get_training_status(self) -> comm.TrainingStatus:
        if self._start_training_time > 0:
            return comm.TrainingStatus(status=TrainingLoopStatus.START)
        return comm.TrainingStatus(status=TrainingLoopStatus.PENDING)

    # ------------------------------------------------------------------
    # report: fire -> ack
    # ------------------------------------------------------------------

    def report(self, envelope: comm.Message) -> comm.Message:
        request = envelope.unpack()
        node_type, node_id = envelope.node_type, envelope.node_id
        method = type(request).__name__
        pool = self._admission.admit(method, wait=False)
        if pool is None:
            return self._overload_reply(method, False, node_type, node_id)
        success, reason = False, ""
        t0 = time.monotonic()
        try:
            with trace.server_span(
                f"master.report/{method}",
                getattr(envelope, "trace_ctx", ""),
                attrs={"node_id": node_id, "node_type": node_type},
            ):
                try:
                    success = self._report_dispatch(
                        request, node_type, node_id
                    )
                except Exception as e:  # noqa: BLE001
                    logger.exception("report(%s) failed", method)
                    reason = str(e)
        finally:
            pool.release()
        obs_metrics.observe_rpc(method, not reason, time.monotonic() - t0)
        reply = comm.Message(node_type=node_type, node_id=node_id)
        reply.pack(comm.BaseResponse(success=success, reason=reason))
        return reply

    def _report_dispatch(
        self, request: Any, node_type: str, node_id: int
    ) -> bool:
        if isinstance(request, comm.DatasetShardParams):
            self._task_manager.new_dataset(
                batch_size=request.batch_size,
                dataset_size=request.dataset_size,
                dataset_name=request.dataset_name,
                num_epochs=request.num_epochs,
                shuffle=request.shuffle,
                num_minibatches_per_shard=request.num_minibatches_per_shard,
                task_type=request.task_type or "training",
                storage_type=request.storage_type,
                splitter=request.splitter or "batch",
            )
            return True
        if isinstance(request, comm.TaskResult):
            success = not request.err_message
            self._task_manager.report_dataset_task(
                request.dataset_name, request.task_id, success
            )
            return True
        if isinstance(request, comm.TaskResults):
            success = not request.err_message
            for task_id in request.task_ids:
                self._task_manager.report_dataset_task(
                    request.dataset_name, task_id, success
                )
            return True
        if isinstance(request, comm.ShardCheckpoint):
            return self._task_manager.restore_dataset_from_checkpoint(
                request.content
            )
        if isinstance(request, comm.KeyValuePair):
            self._kv_store.set(request.key, request.value)
            return True
        if isinstance(request, comm.KeyValuePairs):
            self._kv_store.multi_set(request.kvs)
            return True
        if isinstance(request, comm.NetworkCheckResultRequest):
            return self._report_network_check(request)
        if isinstance(request, comm.GlobalStep):
            self._start_training_time = self._start_training_time or time.time()
            self._perf_monitor.collect_global_step(
                request.step, request.timestamp
            )
            # NOT recorded into the per-node laggard series: rank 0's
            # per-step cadence vs the other nodes' 15s piggyback cadence
            # would flag every healthy node as lagging; the laggard
            # series is fed only by the uniform-cadence sources
            # (ResourceStats piggyback + daemon scrape)
            if self._job_context.get_job_stage() in (
                JobStage.INIT, JobStage.RENDEZVOUS
            ):
                self._job_context.update_job_stage(JobStage.RUNNING)
            return True
        if isinstance(request, comm.ModelInfo):
            if self._job_manager is not None and hasattr(
                self._job_manager, "collect_model_info"
            ):
                self._job_manager.collect_model_info(request)
            return True
        if isinstance(request, comm.ResourceStats):
            node = self._job_context.job_node(node_type or NodeType.WORKER, node_id)
            if node is not None:
                node.used_resource.cpu = request.cpu_percent
                node.used_resource.memory = request.memory_mb
            # chip samples go ONLY to the device series (the taxonomy
            # window every device-level screen reads); duplicating them
            # into the resource deque would double the dominant payload
            # across nodes x window
            self.metric_context.record_resource(
                node_id, request.cpu_percent, request.memory_mb,
            )
            if request.tpu_stats:
                self.metric_context.record_device(
                    node_id, request.tpu_stats
                )
            if request.step >= 0:
                # per-node watermark for the laggard screen (the rank-0
                # GlobalStep report only covers node 0)
                self.metric_context.record_step(node_id, request.step)
            return True
        if isinstance(request, comm.NodeEventRequest):
            return self._report_node_event(request)
        if isinstance(request, comm.NodeFailureRequest):
            if self._diagnosis_manager is not None and hasattr(
                self._diagnosis_manager, "report_failure"
            ):
                self._diagnosis_manager.report_failure(request)
            from dlrover_tpu_torch.common.constants import (
                TrainingExceptionLevel,
            )

            if (
                request.level == TrainingExceptionLevel.JOB_ABORT
                and self._job_manager is not None
                and hasattr(self._job_manager, "request_abort")
            ):
                # deterministic failure: fail the whole job now — the
                # surviving workers would re-rendezvous into the same
                # crash (node-level relaunch paths can't see this)
                self._job_manager.request_abort(
                    f"node {request.node_id}: {request.error_data}"
                )
            return True
        if isinstance(request, comm.DiagnosisReportData):
            if self._diagnosis_manager is not None and hasattr(
                self._diagnosis_manager, "collect_diagnosis_data"
            ):
                self._diagnosis_manager.collect_diagnosis_data(request)
            return True
        if isinstance(request, comm.IncidentDumpReport):
            if self._incident_manager is None:
                # a master without the engine must not fail the agent:
                # the dump is evidence, not state
                logger.debug(
                    "incident dump from node %s dropped (no incident "
                    "manager attached)", node_id,
                )
                return True
            return self._incident_manager.add_dump(
                request.incident_id,
                request.node_id if request.node_id >= 0 else node_id,
                request.payload,
            )
        if isinstance(request, comm.BrainActionAck):
            if self._brain is None:
                # a master without a brain attached must not fail the
                # agent: the ack is telemetry about an action somebody
                # else issued
                logger.debug(
                    "brain ack from node %s dropped (no brain "
                    "attached): %s", node_id, request.action_ids,
                )
                return True
            job = request.job or self._job_context.job_name
            acker = (
                request.node_id if request.node_id >= 0 else node_id
            )
            self._brain.on_ack(job, acker, list(request.action_ids))
            return True
        if isinstance(request, comm.CkptManifestReport):
            return self._ckpt_coordinator.report_manifest(
                request.ckpt_dir,
                request.step,
                request.process_id if request.process_id >= 0 else node_id,
                request.num_processes,
                request.manifest,
            )
        if isinstance(request, comm.PeerSnapshotAnnounce):
            return self._peer_broker.announce(
                request.scope,
                request.process_id if request.process_id >= 0 else node_id,
                request.num_processes,
                request.step,
                request.addr,
            )
        if isinstance(request, comm.RecoveryReport):
            report = comm.message_to_dict(request)
            ok = self._peer_broker.record_recovery(report)
            try:
                self.timeseries.record_recovery(report)
            except Exception as e:  # noqa: BLE001 - telemetry only
                logger.warning("timeseries recovery feed failed: %s", e)
            return ok
        if isinstance(request, comm.HangDetectionReport):
            self.metric_context.record_hang(
                request.node_id, request.hung, request.detail
            )
            if self._diagnosis_manager is not None and hasattr(
                self._diagnosis_manager, "report_hang"
            ):
                self._diagnosis_manager.report_hang(request)
            return True
        if isinstance(request, comm.SyncJoin):
            expected = len(self._job_context.alive_node_ids(NodeType.WORKER))
            self._sync_service.join_sync(
                request.sync_name, request.node_id, max(1, expected)
            )
            return True
        if isinstance(request, comm.SyncFinish):
            self._sync_service.finish_sync(request.sync_name)
            return True
        if isinstance(request, comm.SyncBarrierRequest):
            if request.notify:
                self._sync_service.notify_barrier(request.barrier_name)
            return True
        if isinstance(request, comm.SucceededRequest):
            return self._report_succeeded(request)
        if isinstance(request, comm.ParallelConfig):
            node = self._job_context.job_node(node_type, node_id)
            if node is not None:
                node.paral_config = request
                node.paral_config_origin = "worker"
            return True
        if isinstance(request, comm.CheckpointReadyRequest):
            from dlrover_tpu_torch.common.constants import RendezvousName

            manager = self._rdzv_managers.get(RendezvousName.TRAINING)
            if manager is not None:
                if request.ready:
                    manager.unblock_rendezvous(request.node_id)
                else:
                    manager.block_rendezvous(
                        f"checkpoint conversion on node {request.node_id}",
                        node_id=request.node_id,
                    )
            return True
        if isinstance(request, comm.ScaleRequest):
            if self._job_manager is not None and hasattr(
                self._job_manager, "handle_scale_request"
            ):
                self._job_manager.handle_scale_request(request)
            return True
        raise ValueError(f"unknown report request: {type(request).__name__}")

    def _report_network_check(
        self, request: comm.NetworkCheckResultRequest
    ) -> bool:
        from dlrover_tpu_torch.common.constants import RendezvousName

        manager = self._rdzv_managers.get(RendezvousName.NETWORK_CHECK)
        if manager is None:
            return False
        manager.report_network_check_result(
            request.node_id, request.normal, request.elapsed_time
        )
        return True

    def _report_node_event(self, request: comm.NodeEventRequest) -> bool:
        node = self._job_context.job_node(
            request.node_type or NodeType.WORKER, request.node_id
        )
        if node is None:
            node = Node(
                request.node_type or NodeType.WORKER, request.node_id
            )
            self._job_context.update_job_node(node)
        if self._job_manager is not None and hasattr(
            self._job_manager, "process_reported_node_event"
        ):
            self._job_manager.process_reported_node_event(
                NodeEvent(request.event_type, node), request.reason
            )
        return True

    def _report_succeeded(self, request: comm.SucceededRequest) -> bool:
        node = self._job_context.job_node(
            request.node_type or NodeType.WORKER, request.node_id
        )
        if node is not None:
            node.reported_status = "succeeded"
            # the agent reporting success IS the node's workload finishing
            node.update_status(NodeStatus.SUCCEEDED)
            if self._job_manager is not None and hasattr(
                self._job_manager, "notify_node_succeeded"
            ):
                self._job_manager.notify_node_succeeded(node)
        return True
