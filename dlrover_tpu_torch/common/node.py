"""In-memory node model + status FSM used by the master.

Copy of ``dlrover_tpu/common/node.py``, its imports the port's.

The JAX package's counterpart of DLRover's ``dlrover/python/common/node.py``
(``Node:162``, ``NodeResource:44``, ``NodeGroupResource:137``) and the status
flow FSM (``master/node/status_flow.py:164``).  A "node" here is a TPU-VM
host (one agent, N chips); group resources count hosts per slice.
"""

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from dlrover_tpu_torch.common.constants import (
    NodeEventType,
    NodeExitReason,
    NodeStatus,
    NodeType,
)

# Legal status transitions.  Anything not listed is ignored (stale watch
# events arriving out of order must not move a node backwards).
_ALLOWED_TRANSITIONS = {
    NodeStatus.INITIAL: {
        NodeStatus.PENDING,
        NodeStatus.RUNNING,
        NodeStatus.SUCCEEDED,
        NodeStatus.FAILED,
        NodeStatus.DELETED,
        NodeStatus.UNKNOWN,
    },
    NodeStatus.PENDING: {
        NodeStatus.RUNNING,
        NodeStatus.SUCCEEDED,
        NodeStatus.FAILED,
        NodeStatus.DELETED,
        NodeStatus.BREAKDOWN,
    },
    NodeStatus.RUNNING: {
        NodeStatus.SUCCEEDED,
        NodeStatus.FAILED,
        NodeStatus.DELETED,
        NodeStatus.BREAKDOWN,
    },
    NodeStatus.UNKNOWN: {
        NodeStatus.PENDING,
        NodeStatus.RUNNING,
        NodeStatus.SUCCEEDED,
        NodeStatus.FAILED,
        NodeStatus.DELETED,
    },
    NodeStatus.BREAKDOWN: {NodeStatus.DELETED, NodeStatus.FAILED},
    NodeStatus.SUCCEEDED: {NodeStatus.DELETED},
    NodeStatus.FAILED: {NodeStatus.DELETED},
    NodeStatus.DELETED: set(),
}


def is_allowed_transition(from_status: str, to_status: str) -> bool:
    if from_status == to_status:
        return False
    return to_status in _ALLOWED_TRANSITIONS.get(from_status, set())


@dataclass
class NodeResource:
    """Resources of one host: CPU cores, host memory MB, TPU chips."""

    cpu: float = 0.0
    memory: int = 0  # MB
    tpu_chips: int = 0
    tpu_type: str = ""  # e.g. v5litepod, v5p
    priority: str = ""

    @classmethod
    def resource_str_to_node_resource(cls, resource: str) -> "NodeResource":
        """Parse "cpu=4,memory=8192,tpu=4,tpu_type=v5e"."""
        res = cls()
        if not resource:
            return res
        for kv in resource.split(","):
            if "=" not in kv:
                continue
            k, v = kv.split("=", 1)
            k = k.strip().lower()
            if k == "cpu":
                res.cpu = float(v)
            elif k in ("memory", "mem"):
                res.memory = int(v.lower().replace("mi", "").replace("mb", ""))
            elif k in ("tpu", "tpu_chips"):
                res.tpu_chips = int(v)
            elif k == "tpu_type":
                res.tpu_type = v.strip()
        return res

    def to_resource_dict(self) -> Dict[str, object]:
        return {
            "cpu": self.cpu,
            "memory": f"{self.memory}Mi",
            "tpu_chips": self.tpu_chips,
            "tpu_type": self.tpu_type,
        }


@dataclass
class NodeGroupResource:
    """count hosts, each with node_resource (a slice = count hosts)."""

    count: int = 0
    node_resource: NodeResource = field(default_factory=NodeResource)

    def update(self, count: int = 0, cpu: float = 0, memory: int = 0):
        if count > 0:
            self.count = count
        if cpu > 0:
            self.node_resource.cpu = cpu
        if memory > 0:
            self.node_resource.memory = memory


class Node:
    """One schedulable host in the job, tracked by the master."""

    def __init__(
        self,
        node_type: str = NodeType.WORKER,
        node_id: int = -1,
        rank_index: Optional[int] = None,
        name: str = "",
        status: str = NodeStatus.INITIAL,
        config_resource: Optional[NodeResource] = None,
        max_relaunch_count: int = 3,
        relaunch_on_worker_failure: int = 3,
        slice_id: int = 0,
        critical: bool = False,
    ):
        self.type = node_type
        self.id = node_id
        self.rank_index = rank_index if rank_index is not None else node_id
        self.name = name or f"{node_type}-{node_id}"
        self.status = status
        self.config_resource = config_resource or NodeResource()
        self.used_resource = NodeResource()
        self.max_relaunch_count = max_relaunch_count
        self.relaunch_count = 0
        self.relaunchable = True
        self.relaunch_on_worker_failure = relaunch_on_worker_failure
        self.slice_id = slice_id
        self.critical = critical
        self.exit_reason = ""
        self.host_ip = ""
        self.host_name = ""
        self.create_time: Optional[float] = None
        self.start_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self.heartbeat_time: float = 0.0
        self.start_hang_time: float = 0.0
        self.is_released = False
        self.paral_config = None
        self.restart_training = False
        self.migrated = False
        self.unrecoverable_failure_msg = ""
        self.reported_status: str = ""
        self.group: Optional[int] = None  # network-check pairing group

    # -- status ------------------------------------------------------------

    def update_status(self, status: str) -> bool:
        """Apply a watch-event status through the FSM; returns True if moved."""
        if not is_allowed_transition(self.status, status):
            return False
        self.status = status
        now = time.time()
        if status == NodeStatus.RUNNING and self.start_time is None:
            self.start_time = now
        if status in NodeStatus.end_states():
            self.finish_time = now
        return True

    def update_info(
        self,
        name: Optional[str] = None,
        restart_training: bool = False,
        relaunch_count: int = 0,
        host_ip: str = "",
        host_name: str = "",
    ):
        if name is not None:
            self.name = name
        if host_ip:
            self.host_ip = host_ip
        if host_name:
            self.host_name = host_name
        self.relaunch_count = max(self.relaunch_count, relaunch_count)
        self.restart_training = restart_training

    # -- relaunch policy ---------------------------------------------------

    def inc_relaunch_count(self):
        self.relaunch_count += 1

    def exited_on_success(self) -> bool:
        return self.status == NodeStatus.SUCCEEDED

    def should_relaunch(self, relaunch_always: bool = False) -> bool:
        """Relaunch decision (reference ``dist_job_manager._should_relaunch``
        ``dist_job_manager.py:991``): bounded by relaunch budget, always
        relaunch preemption/hardware faults, never fatal code errors unless
        ``relaunch_always``."""
        if self.is_released or not self.relaunchable:
            return False
        if self.relaunch_count >= self.max_relaunch_count:
            return False
        if self.exit_reason in NodeExitReason.always_relaunch():
            return True
        if self.exit_reason == NodeExitReason.FATAL_ERROR:
            return relaunch_always
        if self.exit_reason == NodeExitReason.OOM:
            return True
        return relaunch_always or self.exit_reason in (
            NodeExitReason.UNKNOWN_ERROR,
            "",
        )

    def is_unrecoverable_failure(self) -> bool:
        return (
            self.relaunch_count >= self.max_relaunch_count
            and self.status == NodeStatus.FAILED
        )

    def timeout(self, timeout_secs: float, now: Optional[float] = None) -> bool:
        now = now or time.time()
        if self.heartbeat_time <= 0:
            return False
        return now - self.heartbeat_time > timeout_secs

    def get_relaunch_node_info(self, new_id: int) -> "Node":
        """Clone this node spec for its replacement."""
        new_node = Node(
            node_type=self.type,
            node_id=new_id,
            rank_index=self.rank_index,
            status=NodeStatus.INITIAL,
            config_resource=self.config_resource,
            max_relaunch_count=self.max_relaunch_count,
            relaunch_on_worker_failure=self.relaunch_on_worker_failure,
            slice_id=self.slice_id,
            critical=self.critical,
        )
        new_node.relaunch_count = self.relaunch_count
        return new_node

    def __repr__(self):
        return (
            f"Node(type={self.type}, id={self.id}, rank={self.rank_index}, "
            f"status={self.status}, relaunch={self.relaunch_count})"
        )


@dataclass
class NodeEvent:
    """An observed change of a node, fed to the job manager."""

    event_type: str = NodeEventType.MODIFIED
    node: Optional[Node] = None

    def is_node_check_event(self) -> bool:
        return self.event_type in (
            NodeEventType.NODE_CHECK_SUCCEEDED,
            NodeEventType.NODE_CHECK_FAILED,
        )
