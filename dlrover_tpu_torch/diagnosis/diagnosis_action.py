"""Diagnosis actions: what the system decides to DO about an observation.

Copy of ``dlrover_tpu/diagnosis/diagnosis_action.py``, its imports the
port's.

The JAX package's counterpart of DLRover's
``dlrover/python/diagnosis/common/diagnosis_action.py`` (hierarchy
NoAction/EventAction/NodeAction/JobRestartAction/JobAbortionAction +
``DiagnosisActionQueue``).  Actions serialize to plain dicts so they ride
the heartbeat RPC back to agents.
"""

import threading
import time
from typing import Dict, List, Optional


class ActionType:
    NONE = "no_action"
    EVENT = "event"
    RESTART_WORKER = "restart_worker"  # agent restarts processes in place
    RELAUNCH_NODE = "relaunch_node"  # platform replaces the host
    RESTART_JOB = "restart_job"
    ABORT_JOB = "abort_job"
    # agent snapshots its flight recorder + all-thread stacks and
    # reports them into the named incident (observability/incidents.py)
    FLIGHT_DUMP = "flight_dump"


class DiagnosisAction:
    def __init__(
        self,
        action_type: str = ActionType.NONE,
        node_id: int = -1,
        reason: str = "",
        expiry_secs: float = 600.0,
        extra: Optional[Dict] = None,
    ):
        self.action_type = action_type
        self.node_id = node_id
        self.reason = reason
        self.created = time.time()
        self.expiry_secs = expiry_secs
        self.extra = extra or {}

    def expired(self) -> bool:
        return time.time() - self.created > self.expiry_secs

    def to_dict(self) -> Dict:
        return {
            "action": self.action_type,
            "node_id": self.node_id,
            "reason": self.reason,
            "extra": self.extra,
        }

    @classmethod
    def from_dict(cls, data: Dict) -> "DiagnosisAction":
        return cls(
            action_type=data.get("action", ActionType.NONE),
            node_id=data.get("node_id", -1),
            reason=data.get("reason", ""),
            extra=data.get("extra", {}),
        )

    def __repr__(self):
        return f"DiagnosisAction({self.action_type}, node={self.node_id}, {self.reason})"


class NoAction(DiagnosisAction):
    def __init__(self):
        super().__init__(ActionType.NONE)


class EventAction(DiagnosisAction):
    def __init__(self, reason: str = "", severity: str = "info",
                 node_id: int = -1):
        super().__init__(ActionType.EVENT, node_id, reason,
                         extra={"severity": severity})


class NodeRestartWorkerAction(DiagnosisAction):
    def __init__(self, node_id: int, reason: str = ""):
        super().__init__(ActionType.RESTART_WORKER, node_id, reason)


class NodeRelaunchAction(DiagnosisAction):
    def __init__(self, node_id: int, reason: str = ""):
        super().__init__(ActionType.RELAUNCH_NODE, node_id, reason)


class JobRestartAction(DiagnosisAction):
    def __init__(self, reason: str = ""):
        super().__init__(ActionType.RESTART_JOB, -1, reason)


class JobAbortionAction(DiagnosisAction):
    def __init__(self, reason: str = ""):
        super().__init__(ActionType.ABORT_JOB, -1, reason)


class FlightDumpAction(DiagnosisAction):
    """Broadcast "dump your flight recorder into incident X now".

    Short expiry: evidence from the rings is only worth collecting near
    the incident — a dump delivered to a node rejoining ten minutes
    later records a different world."""

    def __init__(self, incident_id: str, reason: str = ""):
        super().__init__(
            ActionType.FLIGHT_DUMP, -1, reason, expiry_secs=120.0,
            extra={"incident_id": incident_id},
        )


class DiagnosisActionQueue:
    """Per-node action queues with dedup + expiry (reference
    ``DiagnosisActionQueue``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._actions: Dict[int, List[DiagnosisAction]] = {}

    def add_action(self, action: DiagnosisAction):
        if action.action_type == ActionType.NONE:
            return
        with self._lock:
            queue = self._actions.setdefault(action.node_id, [])
            for existing in queue:
                if (
                    existing.action_type == action.action_type
                    and existing.reason == action.reason
                ):
                    return  # dedup identical pending action
            queue.append(action)

    def next_actions(self, node_id: int) -> List[DiagnosisAction]:
        with self._lock:
            queue = self._actions.pop(node_id, [])
            return [a for a in queue if not a.expired()]

    def pending_count(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._actions.values())
