"""Structured training-event SDK: spans, processes, exporters.

Copy of ``dlrover_tpu/training_event/emitter.py``: master, agent and
trainer emit begin/end/instant events that an offline tool assembles into
the job's timeline.  Exceptions inside instrumentation never propagate into
training.  Every event carries the ids of the live trace span
(``observability/trace.py``) and lands in the flight recorder's event
ring; ``Process.emit_span`` writes a finished span's record into the same
stream (the trace module's default sink).  The default event file lies
under the temp directory.
"""

import json
import os
import tempfile
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.common.log import logger


class EventType:
    BEGIN = "BEGIN"
    END = "END"
    INSTANT = "INSTANT"
    # a finished trace span (observability/trace.py) riding the same
    # exporter stream; the timeline assembler joins these across
    # processes by trace id
    SPAN = "SPAN"


class Exporter:
    def export(self, event: Dict):
        raise NotImplementedError

    def close(self):
        pass


class TextFileExporter(Exporter):
    """JSON-lines file, size-rotated (reference AsyncFileExporter)."""

    def __init__(self, path: str, max_bytes: int = 64 * 1024 * 1024):
        self._path = path
        self._max_bytes = max_bytes
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._file = open(path, "a")

    def export(self, event: Dict):
        line = json.dumps(event, separators=(",", ":"))
        with self._lock:
            if self._file.tell() > self._max_bytes:
                self._file.close()
                os.replace(self._path, self._path + ".1")
                self._file = open(self._path, "a")
            self._file.write(line + "\n")
            self._file.flush()

    def close(self):
        with self._lock:
            self._file.close()


class MemoryExporter(Exporter):
    """Kept in memory (tests / dashboards)."""

    def __init__(self):
        self.events: List[Dict] = []
        self._lock = threading.Lock()

    def export(self, event: Dict):
        with self._lock:
            self.events.append(event)


class RingExporter(Exporter):
    """Bounded in-memory ring, optionally teeing into another exporter.

    The master keeps one of these so the dashboard can answer "what
    happened recently" (reference keeps an event reporter feeding both
    k8s events and the web UI) while the full stream still lands in the
    rotating event file via ``tee``.
    """

    def __init__(self, capacity: int = 512, tee: Optional[Exporter] = None):
        from collections import deque

        self._events: Any = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._tee = tee

    def export(self, event: Dict):
        with self._lock:
            self._events.append(event)
        if self._tee is not None:
            self._tee.export(event)

    def recent(self, n: int = 100) -> List[Dict]:
        with self._lock:
            events = list(self._events)
        return events[-n:]

    def close(self):
        if self._tee is not None:
            self._tee.close()


class DurationSpan:
    """begin()/end() pair; usable as a context manager; stages allowed."""

    def __init__(self, emitter: "Process", name: str,
                 content: Optional[Dict] = None):
        self._emitter = emitter
        self.name = name
        self.content = content or {}
        self.span_id = uuid.uuid4().hex[:12]
        self._begun = False
        self._done = False

    def begin(self, **extra) -> "DurationSpan":
        if not self._begun:
            self._begun = True
            self._emitter._emit(
                self.name, EventType.BEGIN, self.span_id,
                {**self.content, **extra},
            )
        return self

    def stage(self, stage_name: str, **extra):
        self._emitter._emit(
            f"{self.name}.{stage_name}", EventType.INSTANT, self.span_id,
            extra,
        )

    def end(self, success: bool = True, **extra):
        if self._begun and not self._done:
            self._done = True
            self._emitter._emit(
                self.name, EventType.END, self.span_id,
                {**extra, "success": success},
            )

    def fail(self, error: str = ""):
        self.end(success=False, error=error)

    def __enter__(self):
        return self.begin()

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.fail(str(exc))
        else:
            self.end()
        return False


class Process:
    """One event-emitting component (master/agent/trainer)."""

    def __init__(self, target: str, exporter: Optional[Exporter] = None):
        self.target = target
        self._exporter = exporter or _default_exporter()
        self.pid = os.getpid()

    @staticmethod
    def _trace_stamp() -> Dict[str, str]:
        """trace/span/parent ids of the live trace context, stamped on
        every event; empty strings when nothing is live."""
        try:
            from dlrover_tpu_torch.observability import trace

            sp = trace.current_span()
            if sp is not None:
                return {
                    "trace_id": sp.trace_id,
                    "span_id": sp.span_id,
                    "parent_span_id": sp.parent_span_id,
                }
        except Exception:  # noqa: BLE001 - stamping is best-effort
            pass
        return {"trace_id": "", "span_id": "", "parent_span_id": ""}

    def _emit(self, name: str, event_type: str, span_id: str,
              content: Dict):
        try:
            event = {
                "ts": round(time.time(), 6),
                "target": self.target,
                "pid": self.pid,
                "name": name,
                "type": event_type,
                "span": span_id,
                "content": content,
                **self._trace_stamp(),
            }
            try:
                # the flight recorder's event ring (SPAN records reach it
                # from trace._export instead: emit_span must not feed it,
                # or spans would land twice)
                from dlrover_tpu_torch.observability import flight_recorder

                flight_recorder.on_event(event)
            except Exception:  # noqa: BLE001 - recorder is best-effort
                pass
            self._exporter.export(event)
        except Exception as e:  # noqa: BLE001 - never break training
            logger.debug("event export failed: %s", e)

    def emit_span(self, record: Dict):
        """Export a finished trace-span record (``type="SPAN"``) into
        this process's event stream.  The record comes fully formed from
        ``observability/trace.py``; only the process envelope is added."""
        try:
            self._exporter.export(
                {"target": self.target, "pid": self.pid, **record}
            )
        except Exception as e:  # noqa: BLE001 - never break training
            logger.debug("span export failed: %s", e)

    def instant(self, name: str, content: Optional[Dict] = None):
        self._emit(name, EventType.INSTANT, "", content or {})

    def duration(self, name: str, content: Optional[Dict] = None
                 ) -> DurationSpan:
        return DurationSpan(self, name, content)

    def custom(self, name: str, content: Optional[Dict] = None):
        self.instant(name, content)


# predefined taxonomies (reference predefined/_dlrover.py, trainer.py)
class MasterEvents:
    JOB_START = "master.job.start"
    RENDEZVOUS = "master.rendezvous"
    NODE_STARTED = "master.node.started"
    NODE_SUCCEEDED = "master.node.succeeded"
    NODE_FAILED = "master.node.failed"
    NODE_DELETED = "master.node.deleted"
    NODE_RELAUNCH = "master.node.relaunch"
    JOB_EXIT = "master.job.exit"


class AgentEvents:
    WORKER_START = "agent.worker.start"
    WORKER_RESTART = "agent.worker.restart"
    NETWORK_CHECK = "agent.network_check"
    CKPT_PERSIST = "agent.ckpt.persist"


class TrainerEvents:
    INIT = "trainer.init"
    COMPILE = "trainer.compile"
    STEP = "trainer.step"
    CKPT_SAVE = "trainer.ckpt.save"
    # async save could not dispatch (HBM slot busy) and degraded to the
    # blocking path; the CKPT_SAVE for the actual save follows separately
    CKPT_SYNC_FALLBACK = "trainer.ckpt.sync_fallback"
    CKPT_LOAD = "trainer.ckpt.load"


_default: Optional[Process] = None
_default_lock = threading.Lock()


def _default_exporter() -> Exporter:
    path = envs.get_str("DLROVER_TPU_EVENT_FILE") or os.path.join(
        tempfile.gettempdir(), "dlrover_tpu", "events",
        f"events_{os.getpid()}.jsonl",
    )
    try:
        return TextFileExporter(path)
    except OSError:
        return MemoryExporter()


def get_default_emitter(target: str = "trainer") -> Process:
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = Process(target)
    return _default
