"""Diagnostician framework: observe -> resolve -> action.

Copy of ``dlrover_tpu/diagnosis/diagnostician.py``, its imports the
port's.

The JAX package's counterpart of DLRover's
``dlrover/python/diagnosis/common/diagnostician.py`` +
``diagnosis_manager.py``: a Diagnostician observes one failure domain
(hang, node failure, resource collection...), resolves an observation into
a DiagnosisAction, and a manager periodically runs registered
diagnosticians and routes actions into the queue that heartbeats drain.
"""

import threading
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.diagnosis.diagnosis_action import (
    DiagnosisAction,
    DiagnosisActionQueue,
    NoAction,
)


class Observation:
    def __init__(self, observed: bool, detail: str = "",
                 extra: Optional[Dict] = None):
        self.observed = observed
        self.detail = detail
        self.extra = extra or {}

    @classmethod
    def nothing(cls) -> "Observation":
        return cls(False)


class Diagnostician:
    """One failure domain.  Subclasses override observe() and resolve().

    ``incident_kind`` (class attr, empty = none): when set and a
    diagnosis yields an action, the manager opens an incident of that
    kind through the incident engine — detection is only useful if the
    evidence is captured the moment it fires.  The last observation is
    stashed on the instance so the manager can pass its detail/culprit
    to the incident without re-running observe()."""

    name = "base"
    incident_kind = ""

    def observe(self, **kwargs) -> Observation:
        return Observation.nothing()

    def resolve(self, observation: Observation, **kwargs) -> DiagnosisAction:
        return NoAction()

    def diagnose(self, **kwargs) -> DiagnosisAction:
        self.last_observation: Optional[Observation] = None
        try:
            observation = self.observe(**kwargs)
            if not observation.observed:
                return NoAction()
            self.last_observation = observation
            action = self.resolve(observation, **kwargs)
            logger.info(
                "diagnostician %s: %s -> %s",
                self.name, observation.detail, action,
            )
            return action
        except Exception as e:  # noqa: BLE001 - diagnosis must not kill host
            logger.warning("diagnostician %s failed: %s", self.name, e)
            return NoAction()


class DiagnosisManager:
    """Periodic diagnosis loop (reference ``DiagnosisMaster``
    ``master/diagnosis/diagnosis_master.py``)."""

    def __init__(self, action_queue: Optional[DiagnosisActionQueue] = None,
                 interval_secs: float = 30.0, sink=None):
        """``sink``: optional callable(DiagnosisAction) that routes actions
        somewhere else (e.g. the master's JobContext heartbeat queues)
        instead of the internal queue."""
        self._diagnosticians: List[Diagnostician] = []
        self._action_queue = action_queue or DiagnosisActionQueue()
        self._sink = sink
        self._incident_manager = None
        self._interval = interval_secs
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # per-node hang reports feeding the job-level verdict; guarded by
        # a lock because near-simultaneous reports from every wedged peer
        # ARE the expected case (concurrent servicer threads) and the
        # dashboard reads the verdict from yet another thread
        self._hang_reports: Dict[int, Dict] = {}
        self._hang_lock = threading.Lock()
        self._last_hang_action = 0.0
        self._hang_action_window = 60.0

    @property
    def action_queue(self) -> DiagnosisActionQueue:
        return self._action_queue

    def register(self, diagnostician: Diagnostician):
        self._diagnosticians.append(diagnostician)

    def set_incident_manager(self, incident_manager):
        """Attach the incident engine
        (:class:`dlrover_tpu.observability.incidents.IncidentManager`):
        every diagnosis that fires from a diagnostician declaring an
        ``incident_kind`` opens an incident — broadcast flight dumps,
        merged timeline, classified INCIDENT.json."""
        self._incident_manager = incident_manager

    def _emit(self, action: DiagnosisAction):
        if self._sink is not None:
            self._sink(action)
        else:
            self._action_queue.add_action(action)

    def _open_incident(self, kind: str, detail: str, culprit: int = -1,
                       phase_hint: str = ""):
        if self._incident_manager is None:
            return
        try:
            self._incident_manager.open(
                kind, detail=detail, culprit=culprit,
                phase_hint=phase_hint,
            )
        except Exception as e:  # noqa: BLE001 - diagnosis must not die on
            # a broken evidence path; the detection still reached the log
            logger.warning("incident open (%s) failed: %s", kind, e)

    def diagnose_once(self, **kwargs) -> List[DiagnosisAction]:
        actions = []
        for d in self._diagnosticians:
            action = d.diagnose(**kwargs)
            if action.action_type != "no_action":
                # evidence BEFORE the cure: the incident's flight_dump
                # broadcast must enter the action queue ahead of the
                # restart this diagnosis emits, or agents tear the
                # wedged state down before dumping it
                if getattr(d, "incident_kind", ""):
                    obs = getattr(d, "last_observation", None)
                    extra = obs.extra if obs is not None else {}
                    self._open_incident(
                        d.incident_kind,
                        detail=obs.detail if obs is not None
                        else action.reason,
                        culprit=extra.get("culprit", action.node_id),
                        phase_hint=extra.get("phase", ""),
                    )
                self._emit(action)
                actions.append(action)
        return actions

    def start(self, **kwargs):
        def loop():
            while not self._stopped.wait(self._interval):
                self.diagnose_once(**kwargs)

        self._thread = threading.Thread(
            target=loop, daemon=True, name="diagnosis-manager"
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()

    # -- worker-reported observations (via the master servicer) ------------

    def report_hang(self, report):
        """A worker's native timer flagged a hang: fold it into the
        job-level hang verdict and broadcast one restart.

        In an SPMD job one stalled host wedges every peer inside the next
        collective, so several near-simultaneous reports are ONE incident;
        the culprit is the node whose activity stopped FIRST (peers were
        healthy until they blocked on it).  Reference: xpu_timer
        XPU_TIMER_COMMON_HANG gauges aggregated via
        ``diagnosis/datacollector/xpu_timer_metric_collector.py``."""
        from dlrover_tpu_torch.diagnosis.diagnosis_action import (
            NodeRestartWorkerAction,
        )

        if not getattr(report, "hung", False):
            with self._hang_lock:
                self._hang_reports.pop(
                    getattr(report, "node_id", -1), None
                )
            return
        node_id = getattr(report, "node_id", -1)
        with self._hang_lock:
            self._hang_reports[node_id] = {
                "node_id": node_id,
                "last_active_ts": float(
                    getattr(report, "last_active_ts", 0.0) or 0.0
                ),
                "detail": getattr(report, "detail", ""),
                "reported_at": time.time(),
            }
            # one restart per incident window, however many peers pile
            # on — decided under the lock so two concurrent reports can't
            # both win the check-then-set
            now = time.time()
            act = now - self._last_hang_action >= self._hang_action_window
            if act:
                self._last_hang_action = now
        verdict = self.hang_verdict()
        logger.warning("hang verdict: %s", verdict["summary"])
        if act:
            # the timer-reported hang is an incident too: capture every
            # rank's evidence while the wedge is still live — the dump
            # broadcast must precede the restart in the queue, or the
            # restart destroys the state the dump describes
            culprit = verdict.get("culprit")
            self._open_incident(
                "hang", detail=verdict["summary"],
                culprit=-1 if culprit is None else int(culprit),
            )
            self._emit(NodeRestartWorkerAction(-1, verdict["summary"]))

    def hang_verdict(self) -> Dict:
        """Job-level view of the current hang incident (dashboard/stats):
        every reporting node plus the suspected culprit.

        Reports expire after 10 minutes: a crash-relaunched worker never
        sends the hung=False recovery report (its fresh monitor doesn't
        know it ever hung), and a stale entry must not outlive the
        incident and blame the wrong node next time."""
        cutoff = time.time() - 600.0
        with self._hang_lock:
            for node_id in [
                n for n, r in self._hang_reports.items()
                if r["reported_at"] < cutoff
            ]:
                self._hang_reports.pop(node_id, None)
            reports = sorted(
                self._hang_reports.values(),
                key=lambda r: r["last_active_ts"],
            )
        if not reports:
            return {"hung_nodes": [], "culprit": None, "summary": "no hang"}
        culprit = reports[0]
        stalled_for = time.time() - culprit["last_active_ts"]
        summary = (
            f"node {culprit['node_id']} stalled first "
            f"({stalled_for:.0f}s ago): {culprit['detail'] or 'no detail'}"
            f"; {len(reports)} node(s) hung total"
        )
        return {
            "hung_nodes": [r["node_id"] for r in reports],
            "culprit": culprit["node_id"],
            "summary": summary,
            "reports": reports,
        }

    def report_failure(self, request):
        logger.info(
            "failure report from node %s: %s",
            getattr(request, "node_id", -1),
            getattr(request, "error_data", ""),
        )
        # post-mortem OOM classification: when the agent's failure
        # diagnosis named the hbm_oom signature (or the raw log matches
        # it), open a memory incident NOW — the finalize path embeds
        # the culprit's recent mem.* series and whether the forecast
        # sentinel had already breached, so predicted and unpredicted
        # OOMs are distinguishable artifacts
        try:
            import re as _re

            error = str(getattr(request, "error_data", "") or "")
            node_raw = getattr(request, "node_id", None)
            # node 0 is a real culprit: `or -1` would eat it
            node_id = int(node_raw) if node_raw is not None else -1
            match = _re.search(r"signature=(\w+)", error)
            signature = match.group(1) if match else None
            if signature is None and error:
                from dlrover_tpu_torch.diagnosis.diagnosticians import (
                    NodeFailureDiagnostician,
                )

                signature, _ = NodeFailureDiagnostician(
                ).classify_signature(error)
            if signature == "hbm_oom":
                self._open_incident(
                    "hbm_oom",
                    detail=(
                        f"post-mortem OOM classification from node "
                        f"{node_id}: {error}"
                    ),
                    culprit=node_id,
                    phase_hint="mem",
                )
        except Exception as e:  # noqa: BLE001 - evidence capture must
            # not fail the report RPC
            logger.warning("hbm_oom incident open failed: %s", e)

    def collect_diagnosis_data(self, data):
        logger.debug(
            "diagnosis data from node %s: %s",
            getattr(data, "node_id", -1),
            getattr(data, "data_type", ""),
        )
