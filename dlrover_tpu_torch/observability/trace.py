"""W3C-traceparent-style trace context, spans and their sink.

Copy of ``dlrover_tpu/observability/trace.py``.  One trace is one causal
story: a 128-bit ``trace_id`` minted at the root operation, a 64-bit
``span_id`` per operation and ``parent_span_id`` links forming the tree.
The current span rides a :mod:`contextvars` ContextVar; a span's
``traceparent()`` is what crosses a process boundary: the master client
puts :func:`current_traceparent` into each envelope, and the servicer
opens a :func:`server_span` parented to it.  Retries and the admission
control attach events to the live span (:func:`add_event`).  Left out
(ROADMAP item 11, the rest): the registry of open spans that an incident
dump reads.

Every finished span feeds the flight recorder's span ring
(``flight_recorder.on_span``) and the goodput ledger
(``goodput.on_span``), then the sink: by default the training-event
emitter's ``emit_span`` (or ``DLROVER_TPU_TRACE_FILE``).  A span of the
port also opens ``torch.profiler.record_function`` under its name, so a
profiled step sees it beside the trainer's own ``record_function`` phases.

Design constraints, as in the reference: exporting never breaks the
caller; ids come from one module ``Random`` (``DLROVER_TPU_TRACE_SEED``
or :func:`seed_ids` makes the stream deterministic); and
``DLROVER_TPU_TRACE=0`` turns :func:`span` into a no-op yielding
:data:`NOOP_SPAN`, read at call time.
"""

import contextlib
import contextvars
import dataclasses
import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from torch.profiler import record_function

from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.common.log import logger

#: span kinds (OpenTelemetry vocabulary, lowercase)
INTERNAL = "internal"
CLIENT = "client"
SERVER = "server"

_TRACEPARENT_VERSION = "00"

# ---------------------------------------------------------------------------
# Id generation: one module RNG, optionally seeded.
# ---------------------------------------------------------------------------

_ids_mu = threading.Lock()
_ids_rng: Optional[random.Random] = None


def seed_ids(seed: int) -> None:
    """Re-seed the id stream (tests/drills).  ``seed=0`` restores the
    entropy default."""
    global _ids_rng
    with _ids_mu:
        if seed:
            _ids_rng = random.Random(seed)
        else:
            _ids_rng = None


def _rng() -> random.Random:
    global _ids_rng
    with _ids_mu:
        if _ids_rng is None:
            seed = envs.get_int("DLROVER_TPU_TRACE_SEED")
            if seed:
                _ids_rng = random.Random(seed)
            else:
                _ids_rng = random.Random(
                    int.from_bytes(os.urandom(8), "big")
                    ^ (os.getpid() << 17)
                    ^ time.time_ns()
                )
        return _ids_rng


def new_trace_id() -> str:
    rng = _rng()
    with _ids_mu:
        return f"{rng.getrandbits(128):032x}"


def new_span_id() -> str:
    rng = _rng()
    with _ids_mu:
        return f"{rng.getrandbits(64):016x}"


# ---------------------------------------------------------------------------
# Context + spans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """The wire-portable part of a span: what ``traceparent`` carries."""

    trace_id: str
    span_id: str
    sampled: bool = True

    def traceparent(self) -> str:
        flags = "01" if self.sampled else "00"
        return (
            f"{_TRACEPARENT_VERSION}-{self.trace_id}-{self.span_id}-{flags}"
        )


def parse_traceparent(header: str) -> Optional[TraceContext]:
    """``00-<32 hex>-<16 hex>-<2 hex>`` -> TraceContext, else None.
    Unknown versions are accepted (forward compatibility), malformed
    ids are not."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
        sampled = bool(int(flags, 16) & 1)
    except ValueError:
        return None
    if int(trace_id, 16) == 0 or int(span_id, 16) == 0:
        return None
    return TraceContext(trace_id=trace_id, span_id=span_id, sampled=sampled)


class Span:
    """One traced operation.  Mutable until :meth:`end`; exported once."""

    __slots__ = (
        "name", "kind", "trace_id", "span_id", "parent_span_id",
        "start_ts", "end_ts", "attrs", "events", "status", "error",
        "sampled", "_ended",
    )

    def __init__(self, name: str, kind: str, trace_id: str, span_id: str,
                 parent_span_id: str = "", sampled: bool = True,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.kind = kind
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id
        self.start_ts = time.time()
        self.end_ts = 0.0
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.events: List[Dict[str, Any]] = []
        self.status = "ok"
        self.error = ""
        self.sampled = sampled
        self._ended = False

    # -- mutation ----------------------------------------------------------

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def add_event(self, name: str, **attrs: Any) -> None:
        """Attach a timestamped event (retry attempt, breaker flip,
        chaos fault).  Bounded: a retry storm must not grow a span
        without limit."""
        if len(self.events) >= envs.get_int("DLROVER_TPU_TRACE_MAX_EVENTS"):
            return
        self.events.append(
            {"ts": round(time.time(), 6), "name": name, "attrs": attrs}
        )

    def end(self, status: Optional[str] = None, error: str = "") -> None:
        if self._ended:
            return
        self._ended = True
        self.end_ts = time.time()
        if status is not None:
            self.status = status
        if error:
            self.error = error

    def context(self) -> TraceContext:
        return TraceContext(
            trace_id=self.trace_id, span_id=self.span_id,
            sampled=self.sampled,
        )

    def traceparent(self) -> str:
        return self.context().traceparent()

    def to_record(self) -> Dict[str, Any]:
        """The JSONL record the timeline assembler consumes."""
        return {
            "ts": round(self.start_ts, 6),
            "dur": round(max(0.0, (self.end_ts or time.time())
                             - self.start_ts), 6),
            "name": self.name,
            "type": "SPAN",
            "kind": self.kind,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "status": self.status,
            **({"error": self.error} if self.error else {}),
            "attrs": self.attrs,
            "events": self.events,
        }


class _NoopSpan:
    """Shared do-nothing span handed out when tracing is disabled (or a
    root is head-sampled away and export suppressed entirely)."""

    name = ""
    kind = INTERNAL
    trace_id = ""
    span_id = ""
    parent_span_id = ""
    sampled = False
    attrs: Dict[str, Any] = {}
    events: List[Dict[str, Any]] = []

    def set_attr(self, key: str, value: Any) -> None:
        pass

    def add_event(self, name: str, **attrs: Any) -> None:
        pass

    def end(self, status: Optional[str] = None, error: str = "") -> None:
        pass

    def traceparent(self) -> str:
        return ""


NOOP_SPAN = _NoopSpan()

_CURRENT: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "dlrover_tpu_trace_span", default=None
)

def enabled() -> bool:
    return envs.get_bool("DLROVER_TPU_TRACE")


def current_span() -> Optional[Span]:
    return _CURRENT.get()


def current_traceparent() -> str:
    """The header to inject into an outgoing RPC ("" when no live
    span / tracing off)."""
    sp = _CURRENT.get()
    if sp is None or not enabled():
        return ""
    return sp.traceparent()


def add_event(name: str, **attrs: Any) -> bool:
    """Attach an event to the live span, if any.  The hook the retry
    policy, circuit breaker and admission control call: they never hold
    a span themselves."""
    sp = _CURRENT.get()
    if sp is None:
        return False
    sp.add_event(name, **attrs)
    return True


def _sampled_root() -> bool:
    sample = envs.get_float("DLROVER_TPU_TRACE_SAMPLE")
    if sample >= 1.0:
        return True
    rng = _rng()
    with _ids_mu:
        return rng.random() < sample


@contextlib.contextmanager
def span(name: str, kind: str = INTERNAL,
         attrs: Optional[Dict[str, Any]] = None,
         parent: Optional[TraceContext] = None):
    """Open a span as the new current context.

    Parentage: an explicit ``parent`` (a remote TraceContext) wins;
    else the live span; else this is a root (new trace id, head
    sampling applies).  An exception ends the span with
    ``status="error"`` and re-raises.
    """
    if not enabled():
        yield NOOP_SPAN
        return
    live = _CURRENT.get()
    if parent is not None:
        sp = Span(
            name, kind, parent.trace_id, new_span_id(),
            parent_span_id=parent.span_id, sampled=parent.sampled,
            attrs=attrs,
        )
    elif live is not None:
        sp = Span(
            name, kind, live.trace_id, new_span_id(),
            parent_span_id=live.span_id, sampled=live.sampled, attrs=attrs,
        )
    else:
        sp = Span(
            name, kind, new_trace_id(), new_span_id(),
            sampled=_sampled_root(), attrs=attrs,
        )
    token = _CURRENT.set(sp)
    try:
        # the same name on torch.profiler's timeline: a profiled step
        # attributes the span's device work to it
        with record_function(name):
            yield sp
    except BaseException as e:
        sp.end(status="error", error=f"{type(e).__name__}: {e}")
        raise
    finally:
        _CURRENT.reset(token)
        sp.end()
        _export(sp)


@contextlib.contextmanager
def server_span(name: str, traceparent: str,
                attrs: Optional[Dict[str, Any]] = None):
    """Open the server side of an RPC: parented to the remote caller's
    span when ``traceparent`` parses, a fresh root otherwise."""
    with span(
        name, kind=SERVER, attrs=attrs, parent=parse_traceparent(traceparent)
    ) as sp:
        yield sp


# ---------------------------------------------------------------------------
# Export: finished spans become SPAN records in the per-process event
# stream (or a dedicated DLROVER_TPU_TRACE_FILE), which the timeline
# assembler later joins across processes.
# ---------------------------------------------------------------------------

_sink_mu = threading.Lock()
_sink: Optional[Callable[[Dict[str, Any]], None]] = None


def set_span_sink(sink: Optional[Callable[[Dict[str, Any]], None]]) -> None:
    """Override where span records go (tests, the CI smoke).  ``None``
    restores the default (the training-event exporter / trace file)."""
    global _sink
    with _sink_mu:
        _sink = sink


def _default_sink() -> Callable[[Dict[str, Any]], None]:
    path = envs.get_str("DLROVER_TPU_TRACE_FILE")
    if path:
        from dlrover_tpu_torch.training_event.emitter import TextFileExporter

        exporter = TextFileExporter(path)
        target = os.environ.get("DLROVER_TPU_ROLE", "proc")
        pid = os.getpid()

        def _file_sink(record: Dict[str, Any]) -> None:
            exporter.export({"target": target, "pid": pid, **record})

        return _file_sink
    from dlrover_tpu_torch.training_event.emitter import get_default_emitter

    return get_default_emitter().emit_span


def _export(sp: Span) -> None:
    if not sp.sampled:
        return
    record = sp.to_record()
    try:
        # flight recorder first: the ring must hold the span even when
        # the export sink is broken/replaced (tests) — the incident
        # dump is the consumer that must never miss evidence
        from dlrover_tpu_torch.observability import flight_recorder

        flight_recorder.on_span(record)
    except Exception:  # noqa: BLE001 - never break the RPC
        pass
    try:
        # goodput ledger: ckpt/rendezvous spans are wall-clock phases
        from dlrover_tpu_torch.observability import goodput

        goodput.on_span(record)
    except Exception:  # noqa: BLE001 - never break the RPC
        pass
    global _sink
    with _sink_mu:
        sink = _sink
        if sink is None:
            try:
                sink = _sink = _default_sink()
            except Exception as e:  # noqa: BLE001 - never break the RPC
                logger.debug("span sink unavailable: %s", e)
                return
    try:
        sink(record)
    except Exception as e:  # noqa: BLE001 - never break the RPC
        logger.debug("span export failed: %s", e)
