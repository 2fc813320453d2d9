"""Single-host job master (no cluster scheduler).

Copy of ``dlrover_tpu/master/local_master.py``, the counterpart of
DLRover's ``dlrover/python/master/local_master.py:127``: the master that
``tpurun --standalone`` auto-spawns.  Composes the same components as the
distributed master minus platform scalers/watchers: the agent on this host
rendezvouses through it, workers fetch data shards and publish kv-store
entries, heartbeats feed hang detection.

What differs from the copy (ROADMAP item 11, the rest): the perf-regression
sentinels and the incident engine are not built, so a hang the
diagnostician fires broadcasts its restart with no coordinated evidence.
"""

import threading
import time

from dlrover_tpu_torch.common.constants import (
    JobExitReason,
    JobStage,
    NodeEventType,
    NodeStatus,
    NodeType,
    RendezvousName,
)
from dlrover_tpu_torch.common.global_context import Context
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.node import Node, NodeEvent
from dlrover_tpu_torch.master.job_context import get_job_context
from dlrover_tpu_torch.master.kv_store import KVStoreService
from dlrover_tpu_torch.master.master_service import create_master_service
from dlrover_tpu_torch.master.perf_monitor import PerfMonitor
from dlrover_tpu_torch.master.rdzv_manager import (
    ElasticTrainingRendezvousManager,
    NetworkCheckRendezvousManager,
)
from dlrover_tpu_torch.master.servicer import MasterServicer
from dlrover_tpu_torch.master.sync_service import SyncService
from dlrover_tpu_torch.master.task_manager import TaskManager


class LocalJobManager:
    """Minimal node lifecycle for a standalone job: the hosts register by
    reporting events; heartbeats time out into failure events."""

    def __init__(self, job_context=None):
        self._job_context = job_context or get_job_context()
        self.abort_reason = None

    def request_abort(self, reason: str):
        """Deterministic-failure fail-fast (see DistributedJobManager)."""
        logger.error("job abort requested: %s", reason)
        self.abort_reason = reason

    def add_node(self, node_id: int, node_type: str = NodeType.WORKER):
        node = Node(node_type, node_id, status=NodeStatus.RUNNING)
        node.heartbeat_time = time.time()
        self._job_context.update_job_node(node)

    def process_reported_node_event(self, event: NodeEvent, reason: str = ""):
        node = event.node
        if node is None:
            return
        tracked = self._job_context.job_node(node.type, node.id)
        if tracked is None:
            self._job_context.update_job_node(node)
            tracked = node
        if event.event_type == NodeEventType.ADDED:
            tracked.update_status(NodeStatus.RUNNING)
            tracked.heartbeat_time = time.time()
        elif event.event_type == NodeEventType.DELETED:
            tracked.update_status(NodeStatus.DELETED)
        elif event.event_type == NodeEventType.ERROR:
            tracked.exit_reason = reason
            tracked.update_status(NodeStatus.FAILED)
        elif event.event_type == NodeEventType.NODE_CHECK_FAILED:
            tracked.update_status(NodeStatus.BREAKDOWN)
        logger.info("node event %s for node %s", event.event_type, node.id)

    def all_workers_exited(self) -> bool:
        nodes = self._job_context.job_nodes_by_type(NodeType.WORKER)
        if not nodes:
            return False
        return all(n.status in NodeStatus.end_states() for n in nodes.values())

    def all_workers_succeeded(self) -> bool:
        nodes = self._job_context.job_nodes_by_type(NodeType.WORKER)
        if not nodes:
            return False
        return all(
            n.status == NodeStatus.SUCCEEDED or n.reported_status == "succeeded"
            for n in nodes.values()
        )


class LocalJobMaster:
    def __init__(self, port: int = 0, node_num: int = 1, job_name: str = "local"):
        ctx = Context.singleton_instance()
        self._job_context = get_job_context()
        self._job_context.job_name = job_name
        self.task_manager = TaskManager()
        self.perf_monitor = PerfMonitor()
        self.kv_store = KVStoreService()
        self.sync_service = SyncService()
        self.job_manager = LocalJobManager(self._job_context)
        self.rdzv_managers = {
            RendezvousName.TRAINING: ElasticTrainingRendezvousManager(),
            RendezvousName.NETWORK_CHECK: NetworkCheckRendezvousManager(),
        }
        for manager in self.rdzv_managers.values():
            manager.update_rdzv_params(
                min_nodes=node_num,
                max_nodes=node_num,
                waiting_timeout=3,
                node_unit=1,
            )
        # hang detection: no step progress while heartbeats continue =>
        # broadcast a worker restart (reference dist_master._diagnose_job)
        from dlrover_tpu_torch.diagnosis.diagnostician import DiagnosisManager
        from dlrover_tpu_torch.diagnosis.diagnosticians import (
            TrainingHangDiagnostician,
        )

        self.diagnosis_manager = DiagnosisManager(
            interval_secs=30.0,
            sink=lambda action: self._job_context.enqueue_action(
                action.node_id, action.to_dict()
            ),
        )
        self.servicer = MasterServicer(
            task_manager=self.task_manager,
            rdzv_managers=self.rdzv_managers,
            perf_monitor=self.perf_monitor,
            kv_store=self.kv_store,
            sync_service=self.sync_service,
            job_manager=self.job_manager,
            diagnosis_manager=self.diagnosis_manager,
        )
        self.diagnosis_manager.register(
            TrainingHangDiagnostician(
                self.perf_monitor, self._job_context,
                metric_context=self.servicer.metric_context,
            )
        )
        # the reference registers its perf-regression sentinels over the
        # heartbeat-digest time series here, and an incident engine that
        # captures coordinated evidence of a hang (broadcast flight dumps
        # -> merged timeline + classified INCIDENT.json): not ported
        # (ROADMAP item 11, the rest)
        self._server = create_master_service(
            port, self.servicer, ctx.master_service_type
        )
        self.port = self._server.port
        self._node_num = node_num
        self._stopped = threading.Event()
        self.exit_reason = ""

    def prepare(self):
        self._server.start()
        self.diagnosis_manager.start()
        for i in range(self._node_num):
            self.job_manager.add_node(i)
            for manager in self.rdzv_managers.values():
                manager.add_alive_node(i)

    def run(self, poll_secs: float = 2.0) -> int:
        """Block until all workers exit (reference dist_master.run :293).
        With ``hold`` set (multi-role jobs), record the verdict but keep
        serving the KV/sync fabric until terminated."""
        try:
            while not self._stopped.is_set():
                if self.job_manager.abort_reason is not None:
                    self.exit_reason = JobExitReason.WORKER_ERROR
                    self._job_context.update_job_stage(JobStage.FAILED)
                    if not getattr(self, "hold", False):
                        return 1
                    self._stopped.wait(poll_secs)
                    continue
                if self.job_manager.all_workers_exited():
                    if self.job_manager.all_workers_succeeded():
                        self.exit_reason = JobExitReason.SUCCEEDED
                        self._job_context.update_job_stage(JobStage.SUCCEEDED)
                        if not getattr(self, "hold", False):
                            return 0
                    else:
                        self.exit_reason = JobExitReason.WORKER_ERROR
                        self._job_context.update_job_stage(JobStage.FAILED)
                        if not getattr(self, "hold", False):
                            return 1
                self._stopped.wait(poll_secs)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()
        return 0

    def stop(self):
        self._stopped.set()
        self.diagnosis_manager.stop()
        self._server.stop()
