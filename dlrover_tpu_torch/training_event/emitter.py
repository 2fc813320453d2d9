"""Structured training-event SDK: spans, processes, exporters.

Copy of ``dlrover_tpu/training_event/emitter.py``: master, agent and
trainer emit begin/end/instant events that an offline tool assembles into
the job's timeline.  Exceptions inside instrumentation never propagate into
training.  Left out with the rest of the telemetry (ROADMAP queue 1 item
7): the trace-context stamps and the flight recorder's event ring.  The
default event file lies under the temp directory.
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
            }
            self._exporter.export(event)
        except Exception as e:  # noqa: BLE001 - never break training
            logger.debug("event export failed: %s", e)

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
