"""In-memory job state shared across master components.

Copy of ``dlrover_tpu/master/job_context.py``, its imports the port's.

The JAX package's counterpart of DLRover's ``dlrover/python/master/node/job_context.py:411``:
a singleton holding the live node table, job stage, and the per-node queue
of diagnosis actions the master wants agents to execute.
"""

import threading
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.constants import JobStage, NodeStatus, NodeType
from dlrover_tpu_torch.common.node import Node


class JobContext:
    _instance = None
    _singleton_lock = threading.Lock()

    def __init__(self):
        self._lock = threading.Lock()
        self._nodes: Dict[str, Dict[int, Node]] = {}
        self._stage = JobStage.INIT
        self._actions: Dict[int, List[dict]] = {}  # node_id -> action queue
        self._broadcasts: List[dict] = []
        self._failed = False
        self.job_name = ""

    @classmethod
    def singleton_instance(cls) -> "JobContext":
        if cls._instance is None:
            with cls._singleton_lock:
                if cls._instance is None:
                    cls._instance = JobContext()
        return cls._instance

    @classmethod
    def reset(cls):
        with cls._singleton_lock:
            cls._instance = None

    # -- nodes -------------------------------------------------------------

    def update_job_node(self, node: Node):
        with self._lock:
            self._nodes.setdefault(node.type, {})[node.id] = node

    def remove_job_node(self, node_type: str, node_id: int):
        with self._lock:
            self._nodes.get(node_type, {}).pop(node_id, None)

    def job_node(self, node_type: str, node_id: int) -> Optional[Node]:
        with self._lock:
            return self._nodes.get(node_type, {}).get(node_id)

    def job_nodes_by_type(self, node_type: str) -> Dict[int, Node]:
        with self._lock:
            return dict(self._nodes.get(node_type, {}))

    def job_nodes(self) -> Dict[str, Dict[int, Node]]:
        with self._lock:
            return {t: dict(nodes) for t, nodes in self._nodes.items()}

    def running_nodes(self, node_type: str = NodeType.WORKER) -> List[Node]:
        with self._lock:
            return [
                n
                for n in self._nodes.get(node_type, {}).values()
                if n.status == NodeStatus.RUNNING
            ]

    def alive_node_ids(self, node_type: str = NodeType.WORKER) -> List[int]:
        with self._lock:
            return [
                n.id
                for n in self._nodes.get(node_type, {}).values()
                if n.status in (NodeStatus.PENDING, NodeStatus.RUNNING)
                and not n.is_released
            ]

    # -- stage -------------------------------------------------------------

    def update_job_stage(self, stage: str):
        with self._lock:
            self._stage = stage

    def get_job_stage(self) -> str:
        with self._lock:
            return self._stage

    def request_suspend(self):
        self.update_job_stage(JobStage.SUSPENDED)

    def is_suspended(self) -> bool:
        return self.get_job_stage() == JobStage.SUSPENDED

    # -- diagnosis actions -------------------------------------------------

    _BROADCAST_TTL = 600.0

    def enqueue_action(self, node_id: int, action: dict):
        """Queue an action dict for a node; -1 broadcasts to every node
        (each node receives it exactly once)."""
        import time as _time

        with self._lock:
            if node_id == -1:
                self._broadcasts.append(
                    {"action": action, "delivered": set(),
                     "ts": _time.time()}
                )
            else:
                self._actions.setdefault(node_id, []).append(action)

    def pending_action_summary(self) -> Dict:
        """Undelivered actions, for the dashboard's /diagnosis view."""
        with self._lock:
            return {
                "per_node": {
                    node_id: list(actions)
                    for node_id, actions in self._actions.items()
                    if actions
                },
                "broadcasts": [
                    {"action": b["action"],
                     "delivered_to": sorted(b["delivered"])}
                    for b in self._broadcasts
                ],
            }

    def next_actions(self, node_id: int) -> List[dict]:
        import time as _time

        with self._lock:
            actions = self._actions.pop(node_id, [])
            now = _time.time()
            self._broadcasts = [
                b for b in self._broadcasts
                if now - b["ts"] < self._BROADCAST_TTL
            ]
            for b in self._broadcasts:
                if node_id not in b["delivered"]:
                    b["delivered"].add(node_id)
                    actions.append(b["action"])
            return actions


def get_job_context() -> JobContext:
    return JobContext.singleton_instance()
