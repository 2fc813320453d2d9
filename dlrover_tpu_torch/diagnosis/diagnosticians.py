"""Concrete diagnosticians: hang, node failure, heartbeat loss.

Copy of ``dlrover_tpu/diagnosis/diagnosticians.py``, its imports the
port's.

The JAX package's counterparts of DLRover's ``dlrover/python/diagnosis/diagnostician/``
(``training_hang.py:61``, ``node_failure.py``): observations come from the
perf monitor (step watermarks), the job context (node states/heartbeats),
and — once the native timer is attached — execution-timer metrics over XLA
collectives (the xpu_timer ``XPU_TIMER_COMMON_HANG`` analogue).
"""

import re
import time
from typing import Optional

from dlrover_tpu_torch.common.constants import NodeExitReason, NodeStatus, NodeType
from dlrover_tpu_torch.common.global_context import Context
from dlrover_tpu_torch.diagnosis.diagnosis_action import (
    DiagnosisAction,
    EventAction,
    JobAbortionAction,
    NodeRelaunchAction,
    NodeRestartWorkerAction,
)
from dlrover_tpu_torch.diagnosis.diagnostician import Diagnostician, Observation


class TrainingHangDiagnostician(Diagnostician):
    """Step-watermark hang detection: workers were reporting steps, then
    stopped for longer than ``hang_downtime_secs`` while still heartbeating
    (processes alive but no progress — classic collective deadlock /
    stuck-host shape).  Resolution: restart workers everywhere (the
    reference's hang exit / restart arbitration, dist_master.py:293)."""

    name = "training_hang"
    incident_kind = "hang"

    def __init__(self, perf_monitor, job_context=None,
                 metric_context=None):
        self._perf_monitor = perf_monitor
        self._job_context = job_context
        # device-level evidence source (master/metric_context.py): per-
        # chip duty cycle distinguishes "cores idle in a collective" (a
        # real hang) from "cores busy" (recompile/long step)
        self._metric_context = metric_context
        self._last_hang_report = 0.0
        self._busy_deferrals = 0
        self._first_deferral = 0.0

    def observe(self, **kwargs) -> Observation:
        ctx = Context.singleton_instance()
        if ctx.hang_detection <= 0:
            return Observation.nothing()
        if not self._perf_monitor.step_stalled(ctx.hang_downtime_secs):
            # the hang episode (if any) ended: stale deferral counters
            # from it must not pre-charge the cap for the NEXT episode,
            # whose first busy window deserves a fresh deferral budget
            self._busy_deferrals = 0
            return Observation.nothing()
        stalled_secs = time.time() - self._perf_monitor.last_step_time()
        detail = f"no step progress for {stalled_secs:.0f}s"
        self._chips_busy = False
        extra = {}
        if self._metric_context is not None:
            idle = self._metric_context.device_idle_nodes()
            known = self._metric_context.node_duty_means()
            if idle:
                detail += (
                    f"; chips idle on nodes {idle} (duty cycle ~0: "
                    "cores waiting in a collective, not computing)"
                )
                # idle cores in a stall = stuck inside a collective;
                # the incident classifier uses the hint + culprit
                extra = {"culprit": idle[0], "phase": "collective"}
            elif known:
                # duty data exists and NO node is idle: the cores are
                # executing — a long recompile / giant step, not a
                # collective deadlock.  resolve() defers the restart.
                self._chips_busy = True
                detail += (
                    "; chips BUSY on all reporting nodes (likely "
                    "recompile/long step) — restart deferred"
                )
        return Observation(True, detail, extra=extra)

    # a stuck job whose cores SPIN (or a metrics endpoint replaying
    # stale-but-fresh-enough busy samples) must not defer forever.  The
    # cap is WALL-CLOCK only: a count of diagnosis windows would scale
    # with the manager's poll interval (~30s), capping at ~2 minutes —
    # far below legitimate giant-model recompiles — and re-create the
    # kill-recompile loop the gate exists to prevent.  30 min is beyond
    # any sane compile; after that, restart anyway and log the override.
    MAX_DEFERRAL_SECS = 1800.0

    def resolve(self, observation: Observation, **kwargs) -> DiagnosisAction:
        ctx = Context.singleton_instance()
        now = time.time()
        # device-evidence gate: a stall with demonstrably BUSY chips is
        # usually not a hang — restarting would kill a recompile and
        # loop — but the gate has an escalation cap (above)
        if getattr(self, "_chips_busy", False):
            if self._busy_deferrals == 0:
                self._first_deferral = now
            self._busy_deferrals += 1
            if now - self._first_deferral <= self.MAX_DEFERRAL_SECS:
                return EventAction(observation.detail, severity="warn")
            observation = Observation(True, (
                observation.detail
                + f"; busy-chip deferral cap hit ({self._busy_deferrals - 1}"
                f" deferrals / {now - self._first_deferral:.0f}s) — "
                "restarting despite busy duty cycle"
            ))
        else:
            self._busy_deferrals = 0
        # rate-limit: one restart per hang window
        if now - self._last_hang_report < ctx.hang_downtime_secs:
            return EventAction(observation.detail, severity="warn")
        self._last_hang_report = now
        self._busy_deferrals = 0
        return NodeRestartWorkerAction(-1, f"hang: {observation.detail}")


class LaggardSetDiagnostician(Diagnostician):
    """Shared consecutive-window laggard accounting for the runtime
    straggler screens (device duty cycle / heartbeat step-time digest).

    A node must lag ``CONSECUTIVE_WINDOWS`` diagnosis windows in a row
    before anything fires (one slow step must not relaunch a host); the
    action is an exclusion relaunch only when
    ``DLROVER_TPU_EXCLUDE_STRAGGLER`` is set, else a loud event — the
    same conservative default as the reference's straggler handling.
    Subclasses provide ``_laggards()`` (the screen) and
    ``_laggard_detail(persistent)`` (the evidence line)."""

    incident_kind = "straggler"
    CONSECUTIVE_WINDOWS = 3

    def __init__(self):
        self._lag_counts: dict = {}
        self._relaunched: set = set()

    def _laggards(self) -> list:
        raise NotImplementedError

    def _laggard_detail(self, persistent: list) -> str:
        raise NotImplementedError

    def observe(self, **kwargs) -> Observation:
        laggards = self._laggards()
        for node_id in list(self._lag_counts):
            if node_id not in laggards:
                del self._lag_counts[node_id]
                # the node stopped lagging — usually because the
                # exclusion relaunch replaced it.  Clear the relaunch
                # guard so the REPLACEMENT (same node id) is eligible
                # again if it too lags CONSECUTIVE_WINDOWS in a row;
                # without this, one relaunch per node id per job.
                self._relaunched.discard(node_id)
        persistent = []
        for node_id in laggards:
            self._lag_counts[node_id] = self._lag_counts.get(node_id, 0) + 1
            if self._lag_counts[node_id] >= self.CONSECUTIVE_WINDOWS:
                persistent.append(node_id)
        if not persistent:
            return Observation.nothing()
        return Observation(
            True, self._laggard_detail(persistent),
            extra={"culprit": persistent[0], "laggards": persistent},
        )

    def resolve(self, observation: Observation, **kwargs) -> DiagnosisAction:
        from dlrover_tpu_torch.common.global_context import Context

        ctx = Context.singleton_instance()
        if not getattr(ctx, "exclude_straggler", False):
            return EventAction(observation.detail, severity="warn")
        for node_id, count in sorted(self._lag_counts.items()):
            if (
                count >= self.CONSECUTIVE_WINDOWS
                and node_id not in self._relaunched
            ):
                self._relaunched.add(node_id)
                return NodeRelaunchAction(
                    node_id,
                    f"{self.name}: {observation.detail}",
                )
        return EventAction(observation.detail, severity="warn")


class DeviceStragglerDiagnostician(LaggardSetDiagnostician):
    """RUNTIME straggler screen on device evidence: a slow host drags
    every collective, so its chips WAIT more and their duty cycle sits
    below the job median (``metric_context.duty_cycle_laggards``).

    Counterpart of the reference's straggler verdicts over its metric
    schemas (``diagnosis/diagnostician/training_hang.py:61`` wiring
    shape; ``rdzv_manager get_straggler:841`` is the pre-flight host
    screen) — this one runs DURING training on per-chip evidence, not
    host timings."""

    name = "device_straggler"

    def __init__(self, metric_context):
        super().__init__()
        self._metric_context = metric_context

    def _laggards(self) -> list:
        return self._metric_context.duty_cycle_laggards()

    def _laggard_detail(self, persistent: list) -> str:
        means = self._metric_context.node_duty_means()
        return (
            f"duty-cycle stragglers {persistent} "
            f"({self._lag_counts[persistent[0]]} consecutive windows; "
            "node duty means "
            + ", ".join(f"{n}:{means.get(n, -1):.0f}%" for n in persistent)
            + ")"
        )


class StepTimeStragglerDiagnostician(LaggardSetDiagnostician):
    """RUNTIME straggler screen on the per-rank step-time digests the
    agent heartbeats carry (``HeartBeat.digest`` ->
    ``metric_context.record_step_digest``): a node whose p50 step time
    sits above ``DLROVER_TPU_STRAGGLER_STEP_RATIO`` x the job median is
    dragging every synchronous step.

    Same data source as the dashboard's laggard flags and the exclusion
    policy (``DLROVER_TPU_EXCLUDE_STRAGGLER``) — the heartbeat digest is
    the single step-time feed, so the screen, the laggard set, and the
    incident evidence can never disagree about what a rank reported."""

    name = "step_straggler"

    def __init__(self, metric_context):
        super().__init__()
        self._metric_context = metric_context

    def _laggards(self) -> list:
        return self._metric_context.step_time_laggards()

    def _laggard_detail(self, persistent: list) -> str:
        digests = self._metric_context.latest_digests()
        return (
            f"step-time stragglers {persistent} "
            f"({self._lag_counts[persistent[0]]} consecutive windows; "
            "p50 step seconds "
            + ", ".join(
                f"{n}:{digests.get(n, {}).get('step_p50_s', -1):.3f}"
                for n in persistent
            )
            + ")"
        )


class CkptStallDiagnostician(Diagnostician):
    """A node whose checkpoint saver has been busy on one persist longer
    than ``DLROVER_TPU_CKPT_STALL_S`` (heartbeat digest ``ckpt_busy_s``)
    is stalled in storage — slow NFS/object store, a wedged writer pool.
    The resolution is an event + incident (the flight dumps show which
    storage span never finished); restart decisions stay with the hang
    and failure paths, which see the consequences."""

    name = "ckpt_stall"
    incident_kind = "ckpt_stall"

    def __init__(self, metric_context):
        self._metric_context = metric_context

    def observe(self, **kwargs) -> Observation:
        from dlrover_tpu_torch.common import envs

        threshold = envs.get_float("DLROVER_TPU_CKPT_STALL_S")
        stalled = {
            node_id: busy
            for node_id, busy in self._metric_context.ckpt_busy().items()
            if busy >= threshold
        }
        if not stalled:
            return Observation.nothing()
        worst = max(stalled, key=lambda n: stalled[n])
        detail = (
            f"checkpoint persist stalled on node(s) "
            + ", ".join(
                f"{n} ({stalled[n]:.0f}s)" for n in sorted(stalled)
            )
            + f"; threshold {threshold:.0f}s"
        )
        return Observation(
            True, detail,
            extra={"culprit": worst, "phase": "ckpt", "stalled": stalled},
        )

    def resolve(self, observation: Observation, **kwargs) -> DiagnosisAction:
        return EventAction(observation.detail, severity="warn")


class OverloadStormDiagnostician(Diagnostician):
    """Sustained admission-control refusals (the r11
    ``dlrover_tpu_servicer_overload_total`` counter) above
    ``DLROVER_TPU_OVERLOAD_STORM_RATE`` per second mean the control
    plane is shedding load faster than the hint-paced retries drain it —
    a reconnect herd, a poll-loop regression, an undersized cap.  The
    incident's master dump carries the RED snapshot + queue-depth
    gauges that show which methods are storming."""

    name = "overload_storm"
    incident_kind = "overload_storm"

    def __init__(self):
        self._last_total: Optional[float] = None
        self._last_ts = 0.0

    def observe(self, **kwargs) -> Observation:
        from dlrover_tpu_torch.common import envs
        from dlrover_tpu_torch.observability import metrics as obs_metrics

        total = obs_metrics.registry().counter_total(
            "dlrover_tpu_servicer_overload_total"
        )
        now = time.time()
        last_total, last_ts = self._last_total, self._last_ts
        self._last_total, self._last_ts = total, now
        if last_total is None or now <= last_ts:
            return Observation.nothing()  # first window: baseline only
        rate = (total - last_total) / (now - last_ts)
        threshold = envs.get_float("DLROVER_TPU_OVERLOAD_STORM_RATE")
        if rate < threshold:
            return Observation.nothing()
        detail = (
            f"admission overload storm: {rate:.0f} refusals/s over the "
            f"last {now - last_ts:.0f}s (threshold {threshold:.0f}/s)"
        )
        return Observation(
            True, detail, extra={"phase": "admission", "rate": rate},
        )

    def resolve(self, observation: Observation, **kwargs) -> DiagnosisAction:
        return EventAction(observation.detail, severity="warn")


class NodeFailureDiagnostician(Diagnostician):
    """Classify a worker failure into restart-in-place vs relaunch-node vs
    abort (agent side; reference ``diagnose_training_failure``
    diagnosis_agent.py:153)."""

    name = "node_failure"

    # -- XLA/jax crash-signature table (VERDICT r4 #6; reference
    # training_log_collector.py's exception parsing) -----------------
    # Ordered — first match wins.  Each signature names a recurring TPU
    # failure mode and the response that actually helps:
    #   sharding_mismatch  a program/config bug (pjit/GSPMD shape or
    #                      sharding error): deterministic — neither a
    #                      restart nor a new host changes the program.
    #                      ABORT fast instead of burning TPU time.
    #   hbm_oom            HBM exhaustion: deterministic at a fixed
    #                      config — restart while budget lasts (the
    #                      config tuner can shrink the next
    #                      incarnation), then ABORT: a replacement host
    #                      has the same HBM.
    #   coordinator_timeout a PEER/master problem, not this host:
    #                      restart into a new rendezvous round;
    #                      relaunching a healthy host wastes it.
    #   pjrt_wedged        the device/runtime is sick: RELAUNCH.
    _SIGNATURES = [
        ("sharding_mismatch", "abort", [
            r"sharding.*(mismatch|incompatible)",
            r"(does not evenly divide|not divisible by).*(mesh|shard)",
            r"mesh.*(shape|axis).*(mismatch|not found|unknown)",
            r"pjit.*(incompatible|mismatch)",
            r"received incompatible devices for jitted computation",
        ]),
        ("hbm_oom", "oom_device", [
            r"RESOURCE_EXHAUSTED",
            r"(out of|insufficient).*(hbm|device memory)",
            r"OOM when allocating",
            r"allocation.*exceeds.*(hbm|device memory)",
        ]),
        ("coordinator_timeout", "restart", [
            r"failed to connect to.*coordinator",
            r"coordination service.*(unavailable|error|timed? ?out)",
            r"DEADLINE_EXCEEDED.*(heartbeat|barrier|coordination)",
            r"barrier timed out",
            r"(missed|lost).*heartbeat|heartbeat.*timed? ?out",
        ]),
        ("pjrt_wedged", "relaunch", [
            r"PJRT.*(timed? ?out|stuck|deadlock|internal error)",
            r"libtpu.*(abort|fatal)",
            r"tpu.*(unavailable|unhealthy|device.*error)",
            r"slice.*unreachable",
            r"DATA_LOSS",
        ]),
    ]
    # generic fallbacks for logs no signature claims
    _OOM_PATTERNS = [
        r"out of memory",
        r"OOM",
        r"Cannot allocate memory",
    ]

    def classify_signature(self, error_log: str):
        """(signature_name, response) of the first matching signature,
        or (None, None)."""
        log = error_log or ""
        for name, response, patterns in self._SIGNATURES:
            for pattern in patterns:
                if re.search(pattern, log, re.IGNORECASE):
                    return name, response
        return None, None

    def classify_exit(self, exit_code: Optional[int],
                      error_log: str = "") -> str:
        signature, response = self.classify_signature(error_log)
        if response == "abort":
            return NodeExitReason.FATAL_ERROR
        if response == "oom_device":
            return NodeExitReason.OOM
        if response == "relaunch":
            return NodeExitReason.HARDWARE_ERROR
        if response == "restart":
            return NodeExitReason.UNKNOWN_ERROR  # transient; retryable
        log = error_log or ""
        for pattern in self._OOM_PATTERNS:
            if re.search(pattern, log, re.IGNORECASE):
                return NodeExitReason.OOM
        if exit_code is None:
            return NodeExitReason.UNKNOWN_ERROR
        if exit_code == 0:
            return NodeExitReason.SUCCEEDED
        if exit_code < 0:  # killed by signal (SIGKILL=-9: oom-killer/preempt)
            if exit_code == -9:
                return NodeExitReason.KILLED
            return NodeExitReason.UNKNOWN_ERROR
        return NodeExitReason.FATAL_ERROR

    def observe(self, exit_codes=None, error_log: str = "", **kwargs):
        if not exit_codes:
            return Observation.nothing()
        reasons = {
            rank: self.classify_exit(code, error_log)
            for rank, code in exit_codes.items()
        }
        if all(r == NodeExitReason.SUCCEEDED for r in reasons.values()):
            return Observation.nothing()
        signature, response = self.classify_signature(error_log)
        detail = f"exit reasons {reasons}"
        if signature:
            detail += f"; signature={signature}"
        return Observation(True, detail, extra={
            "reasons": reasons, "signature": signature,
            "response": response,
        })

    def resolve(self, observation: Observation, node_id: int = -1,
                remaining_restarts: int = 0, **kwargs) -> DiagnosisAction:
        signature = observation.extra.get("signature")
        response = observation.extra.get("response")
        if response == "abort":
            return JobAbortionAction(
                f"{signature}: deterministic program/config failure — "
                f"{observation.detail}"
            )
        if response == "oom_device":
            if remaining_restarts > 0:
                return NodeRestartWorkerAction(
                    node_id,
                    f"{signature}: retry (config tuner may shrink the "
                    "next incarnation)",
                )
            return JobAbortionAction(
                f"{signature}: HBM exhaustion persists across restarts "
                "— a replacement host has the same HBM; aborting "
                f"({observation.detail})"
            )
        if response == "restart":
            if remaining_restarts > 0:
                return NodeRestartWorkerAction(
                    node_id,
                    f"{signature}: peer/master issue — rejoin a new "
                    "rendezvous round",
                )
            # persistent coordination failure: maybe the 'healthy host'
            # read is wrong — let the platform replace it
            return NodeRelaunchAction(
                node_id, f"{signature} persists; relaunching"
            )
        if response == "relaunch":
            # restarting processes on a sick host is futile
            return NodeRelaunchAction(node_id, f"{signature or 'hardware'}")
        reasons = set(observation.extra.get("reasons", {}).values())
        if NodeExitReason.HARDWARE_ERROR in reasons:
            return NodeRelaunchAction(node_id, "hardware error")
        if NodeExitReason.OOM in reasons:
            if remaining_restarts > 0:
                return NodeRestartWorkerAction(node_id, "oom retry")
            return NodeRelaunchAction(node_id, "oom, restarts exhausted")
        if remaining_restarts > 0:
            return NodeRestartWorkerAction(node_id, observation.detail)
        return NodeRelaunchAction(node_id, "restart budget exhausted")


class HeartbeatDiagnostician(Diagnostician):
    """Master side: running nodes whose heartbeat went silent are dead
    (reference ``_get_dead_node_event`` dist_job_manager.py:550)."""

    name = "heartbeat"

    def __init__(self, job_context):
        self._job_context = job_context

    def observe(self, **kwargs) -> Observation:
        ctx = Context.singleton_instance()
        dead = []
        now = time.time()
        for node in self._job_context.job_nodes_by_type(
            NodeType.WORKER
        ).values():
            if node.status == NodeStatus.RUNNING and node.timeout(
                ctx.heartbeat_timeout_secs, now
            ):
                dead.append(node.id)
        if not dead:
            return Observation.nothing()
        return Observation(True, f"dead nodes {dead}", extra={"dead": dead})

    def resolve(self, observation: Observation, **kwargs) -> DiagnosisAction:
        dead = observation.extra.get("dead", [])
        return NodeRelaunchAction(dead[0], "no heartbeat")
