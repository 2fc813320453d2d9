"""Always-on in-process flight recorder: bounded rings of recent evidence.

Copy of ``dlrover_tpu/observability/flight_recorder.py``: four bounded
rings per process (finished trace spans, training events, per-step
timings, warning-level log lines), appended on the paths that already
exist.  :meth:`FlightRecorder.step_digest` (``last_step``,
``step_p50_s``, ``step_max_s``, ``steps``, ``ts``) is the head of the
per-rank digest file the trainer writes (``trainer/train.py``).

Appends are single ``deque.append`` calls on ``maxlen`` deques: no lock,
O(1).  Feeds are one-directional and guarded by their callers, so a
broken recorder never breaks training.  ``DLROVER_TPU_RECORDER=0`` turns
every append into a flag check.  :meth:`FlightRecorder.snapshot` freezes
the rings, every thread's Python stack, the open spans and the metrics
registry into one JSON document, and :func:`dump` writes it: the unit the
incident engine (``observability/incidents.py``) collects from every
process (the master's own at the open, each agent's over the report RPC).
The role tag is ``DLROVER_TPU_ROLE`` (``proc`` by default), as in
``trace.py``.
"""

import json
import logging
import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.common.log import logger


def enabled() -> bool:
    return envs.get_bool("DLROVER_TPU_RECORDER")


def all_thread_stacks() -> Dict[str, List[str]]:
    """Formatted Python stacks of every live thread, keyed
    ``"<thread name>:<ident>"`` — the ``sys._current_frames`` analogue
    of a ``faulthandler`` dump, but structured and capturable without a
    file descriptor.  Needs no cooperation from a stuck thread, which
    is the whole point: the thread wedged inside a collective cannot
    report itself."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: Dict[str, List[str]] = {}
    for ident, frame in sys._current_frames().items():
        key = f"{names.get(ident, '?')}:{ident}"
        out[key] = traceback.format_stack(frame)
    return out


class _RingLogHandler(logging.Handler):
    """Warning-and-up log lines into the recorder's log ring (INFO from
    the chatty heartbeat/tuner loops would evict the lines that
    matter)."""

    def __init__(self, recorder: "FlightRecorder"):
        super().__init__(level=logging.WARNING)
        self._recorder = recorder

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self._recorder.record_log(self.format(record))
        except Exception:  # noqa: BLE001 - logging must never recurse/raise
            pass


class FlightRecorder:
    """The per-process ring set.  One instance per process (see
    :func:`recorder`); tests may build private ones."""

    def __init__(self, attach_log_handler: bool = True):
        self._build_rings()
        self._log_handler: Optional[_RingLogHandler] = None
        if attach_log_handler:
            self._log_handler = _RingLogHandler(self)
            self._log_handler.setFormatter(
                logging.Formatter("%(asctime)s %(levelname)s %(message)s")
            )
            logger.addHandler(self._log_handler)

    def _build_rings(self) -> None:
        self.spans: deque = deque(
            maxlen=max(1, envs.get_int("DLROVER_TPU_RECORDER_SPANS"))
        )
        self.events: deque = deque(
            maxlen=max(1, envs.get_int("DLROVER_TPU_RECORDER_EVENTS"))
        )
        # (ts, step, dur_s)
        self.steps: deque = deque(
            maxlen=max(1, envs.get_int("DLROVER_TPU_RECORDER_STEPS"))
        )
        self.logs: deque = deque(
            maxlen=max(1, envs.get_int("DLROVER_TPU_RECORDER_LOG_LINES"))
        )
        self._t0 = time.time()
        # approximate totals (unlocked by design; see module docstring)
        self.total_spans = 0
        self.total_events = 0
        self.total_steps = 0

    def reset(self) -> None:
        """Drop everything and re-read capacities (tests, per-scenario
        drill isolation)."""
        self._build_rings()

    # -- appends (the hot path) --------------------------------------------

    def record_span(self, record: Dict[str, Any]) -> None:
        """A finished SPAN record (``trace.Span.to_record`` shape)."""
        if not enabled():
            return
        self.spans.append(record)
        self.total_spans += 1

    def record_event(self, record: Dict[str, Any]) -> None:
        """A training event (BEGIN/END/INSTANT) or a chaos-fault record."""
        if not enabled():
            return
        self.events.append(record)
        self.total_events += 1

    def record_step(self, step: int, dur_s: float) -> None:
        if not enabled():
            return
        self.steps.append((round(time.time(), 6), int(step), float(dur_s)))
        self.total_steps += 1

    def record_log(self, line: str) -> None:
        if not enabled():
            return
        self.logs.append(line)

    # -- derived views ------------------------------------------------------

    def step_digest(self) -> Dict[str, float]:
        """Compact step-time summary of the ring — the per-rank digest
        heartbeats carry to the master's straggler screens.  Empty when
        no steps were recorded."""
        samples = list(self.steps)
        if not samples:
            return {}
        durs = sorted(d for _, _, d in samples)
        return {
            "last_step": float(samples[-1][1]),
            "step_p50_s": round(durs[len(durs) // 2], 6),
            "step_max_s": round(durs[-1], 6),
            "steps": float(len(durs)),
            "ts": round(samples[-1][0], 6),
        }

    def snapshot(self, stacks: bool = True) -> Dict[str, Any]:
        """Freeze the rings + live-thread stacks + open spans + metrics
        into one JSON-serializable document (the incident dump unit)."""
        snap: Dict[str, Any] = {
            "role": os.environ.get("DLROVER_TPU_ROLE", "proc"),
            "pid": os.getpid(),
            "ts": round(time.time(), 6),
            "uptime_s": round(time.time() - self._t0, 3),
            "totals": {
                "spans": self.total_spans,
                "events": self.total_events,
                "steps": self.total_steps,
            },
            "spans": list(self.spans),
            "events": list(self.events),
            "steps": [list(s) for s in self.steps],
            "logs": list(self.logs),
            "step_digest": self.step_digest(),
        }
        try:
            from dlrover_tpu_torch.observability import trace

            # the stuck operation is exactly the span that never
            # finished — it is NOT in the spans ring, only here
            snap["open_spans"] = trace.open_spans()
        except Exception:  # noqa: BLE001 - snapshot is best-effort
            snap["open_spans"] = []
        try:
            from dlrover_tpu_torch.observability import metrics

            snap["metrics"] = metrics.registry().snapshot()
        except Exception:  # noqa: BLE001
            snap["metrics"] = {}
        if stacks:
            snap["stacks"] = all_thread_stacks()
        return snap


def dump(dir_path: str, tag: str,
         snapshot: Optional[Dict[str, Any]] = None) -> str:
    """Write a snapshot into ``dir_path/dump_<tag>.json`` (atomic
    tmp+rename) and return the path."""
    snap = snapshot if snapshot is not None else recorder().snapshot()
    os.makedirs(dir_path, exist_ok=True)
    path = os.path.join(dir_path, f"dump_{tag}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(snap, f, sort_keys=True)
    os.replace(tmp, path)
    return path


_RECORDER: Optional[FlightRecorder] = None
_RECORDER_MU = threading.Lock()


def recorder() -> FlightRecorder:
    """The process singleton every feed writes to."""
    global _RECORDER
    if _RECORDER is None:
        with _RECORDER_MU:
            if _RECORDER is None:
                _RECORDER = FlightRecorder()
    return _RECORDER


# -- feed helpers (called from trace/emitter/chaos/trainer; every caller
# wraps in try/except so instrumentation can never break the host) ----------


def on_span(record: Dict[str, Any]) -> None:
    recorder().record_span(record)


def on_event(record: Dict[str, Any]) -> None:
    recorder().record_event(record)


def on_step(step: int, dur_s: float) -> None:
    recorder().record_step(step, dur_s)
