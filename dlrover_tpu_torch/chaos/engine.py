"""Deterministic chaos-injection engine.

Copy of ``dlrover_tpu/chaos/engine.py``: the same plans, fault kinds,
per-spec seeded streams and trace records, so a plan and a seed fire the
same faults at the same calls in both packages.

Fault handling is only trustworthy if the fault paths are *manufactured*
on demand: a node loss that happens to occur in production exercises one
interleaving once, while a seeded injection replays the same fault trace
every run.  This module is the single owner of fault injection for the
whole tree — named **injection points** are woven into the master RPC
transport, kv-store/barrier paths, shm staging, storage persist,
rendezvous, and the agent heartbeat (the
scenario library, ``scenarios.py``, names them), and a **plan** of fault specs decides what fires where.

Design constraints, in order:

1. **Off by default, near-zero cost.**  ``point(name)`` is a module-flag
   check when no plan is armed; production code paths pay one branch.
   The ``DLROVER_TPU_CHAOS`` knob must default off; only tests and
   drills arm a plan in process.
2. **Deterministic.**  A plan carries a seed; every spec draws from its
   own ``random.Random`` stream seeded by ``crc32(point_pattern) ^
   seed`` (never ``hash()`` — that is salted per process).  Per-point
   call counters drive nth-call predicates.  The same seed over the
   same call sequence yields an identical fault trace, asserted by
   ``tests/test_torch_chaos.py`` and replayed by
   ``diagnosis/chaos_drill.py``.
3. **Injection points are dumb.**  A site calls ``chaos.point(name)``
   and gets exception/delay behavior for free; only sites that can
   cooperate (torn writes, drops, flaps) inspect the returned
   :class:`Fault`.  No site ever imports fault *specs* — wiring stays
   one-directional.

Fault kinds:

``exception``   raise :class:`ChaosError` (or a provided exception type)
``delay``       sleep ``delay_s`` at the point, then continue
``torn_write``  returned to the caller; storage/shm writers corrupt or
                truncate the payload they were about to write
``drop``        returned to the caller; the operation is silently
                skipped (a lost RPC, a swallowed heartbeat)
``flap``        returned to the caller; the resource reports absent for
                ``flap_count`` consecutive calls then recovers
``callback``    invoke a user function with the point's context (the
                compatibility kind behind ``snapshot.set_stream_fault``)
"""

import dataclasses
import fnmatch
import json
import threading
import time
import zlib
from random import Random
from typing import Any, Callable, Dict, List, Optional

from dlrover_tpu_torch.common.log import logger

EXCEPTION = "exception"
DELAY = "delay"
TORN_WRITE = "torn_write"
DROP = "drop"
FLAP = "flap"
CALLBACK = "callback"

FAULT_KINDS = (EXCEPTION, DELAY, TORN_WRITE, DROP, FLAP, CALLBACK)


class ChaosError(RuntimeError):
    """The exception an ``exception``-kind fault raises.  A distinct
    type so tests and retry policies can tell injected failures from
    organic ones."""


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault.

    ``point`` is an fnmatch pattern over injection-point names
    (``"kv_store.*"`` matches get/set/wait).  Scheduling predicates
    compose with AND:

    * ``on_calls``: fire only on these 0-based per-point call indices
    * ``after``: fire only once the point's call index is >= this
    * ``every``: fire on every Nth call (after ``after``)
    * ``probability``: fire with this chance (seeded stream — still
      deterministic for a fixed seed and call sequence)
    * ``times``: stop after firing this many times (0 = unlimited)
    """

    point: str
    kind: str = EXCEPTION
    on_calls: Optional[List[int]] = None
    after: int = 0
    every: int = 0
    probability: float = 1.0
    times: int = 0
    delay_s: float = 0.0
    flap_count: int = 1
    message: str = ""
    exception: Optional[type] = None
    callback: Optional[Callable[..., None]] = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"fault kind {self.kind!r} not one of {FAULT_KINDS}"
            )

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "point": self.point,
            "kind": self.kind,
            "after": self.after,
            "every": self.every,
            "probability": self.probability,
            "times": self.times,
            "delay_s": self.delay_s,
            "flap_count": self.flap_count,
        }
        if self.on_calls is not None:
            out["on_calls"] = list(self.on_calls)
        if self.message:
            out["message"] = self.message
        return out

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "FaultSpec":
        known = {f.name for f in dataclasses.fields(FaultSpec)}
        bad = set(data) - known
        if bad:
            raise ValueError(f"unknown FaultSpec fields: {sorted(bad)}")
        return FaultSpec(**data)


@dataclasses.dataclass(frozen=True)
class Fault:
    """What ``point()`` hands back to a cooperating site."""

    kind: str
    spec: FaultSpec
    point: str
    call_index: int
    seq: int  # global fire sequence number (the trace position)

    @property
    def delay_s(self) -> float:
        return self.spec.delay_s


@dataclasses.dataclass
class ChaosPlan:
    """A named, seeded set of fault specs — one drill scenario."""

    name: str = "adhoc"
    seed: int = 0
    faults: List[FaultSpec] = dataclasses.field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(
            {
                "name": self.name,
                "seed": self.seed,
                "faults": [f.to_dict() for f in self.faults],
            }
        )

    @staticmethod
    def from_json(text: str) -> "ChaosPlan":
        data = json.loads(text)
        return ChaosPlan(
            name=data.get("name", "adhoc"),
            seed=int(data.get("seed", 0)),
            faults=[
                FaultSpec.from_dict(f) for f in data.get("faults", [])
            ],
        )


class _ArmedSpec:
    """Runtime state for one spec: its seeded RNG stream, fire budget,
    and flap window."""

    def __init__(self, spec: FaultSpec, seed: int):
        self.spec = spec
        # crc32 keyed by the PATTERN (not the matched point): a spec's
        # stream must not depend on which concrete point matched first,
        # or two runs with different point interleavings diverge
        self.rng = Random(zlib.crc32(spec.point.encode()) ^ (seed or 0))
        self.fired = 0
        self.flap_left = 0

    def should_fire(self, call_index: int) -> bool:
        s = self.spec
        if self.flap_left > 0:
            return True  # mid-flap: keep reporting absent
        if s.times and self.fired >= s.times:
            return False
        if call_index < s.after:
            return False
        if s.on_calls is not None and call_index not in s.on_calls:
            return False
        if s.every and (call_index - s.after) % s.every != 0:
            return False
        if s.probability < 1.0 and self.rng.random() >= s.probability:
            return False
        return True


def _current_trace_span():
    """The live observability span, or None.  Lazy + guarded: the chaos
    engine must work even if the observability package is broken, and
    the import must not run on the disarmed fast path."""
    try:
        from dlrover_tpu_torch.observability import trace

        return trace.current_span()
    except Exception:  # noqa: BLE001 - attribution is best-effort
        return None


def _record_fault_metric(point_name: str, kind: str) -> None:
    try:
        from dlrover_tpu_torch.observability import metrics

        metrics.record_chaos_fault(point_name, kind)
    except Exception:  # noqa: BLE001 - instrumentation only
        pass


def _record_fault_flight(record: Dict[str, Any]) -> None:
    """Mirror a fired fault into the flight recorder's event ring so an
    incident dump carries the chaos evidence of the process the fault
    fired in.  A COPY with a wall-clock ts: the engine's own trace
    records stay ts-free, because the seeded replay-determinism
    contract compares them byte-for-byte."""
    try:
        from dlrover_tpu_torch.observability import flight_recorder

        flight_recorder.on_event(
            {
                "type": "CHAOS",
                "name": f"chaos:{record.get('point', '?')}",
                "ts": round(time.time(), 6),
                **record,
            }
        )
    except Exception:  # noqa: BLE001 - instrumentation only
        pass


class ChaosEngine:
    """Holds the armed plan, per-point call counters, and the trace."""

    def __init__(self):
        self._mu = threading.Lock()
        self._plan: Optional[ChaosPlan] = None
        self._armed: List[_ArmedSpec] = []
        self._counters: Dict[str, int] = {}
        self._trace: List[Dict[str, Any]] = []
        self._trace_file: str = ""

    # -- arming ------------------------------------------------------------

    def arm(self, plan: ChaosPlan, trace_file: str = "") -> None:
        with self._mu:
            self._plan = plan
            self._armed = [_ArmedSpec(s, plan.seed) for s in plan.faults]
            self._counters = {}
            self._trace = []
            self._trace_file = trace_file
        logger.info(
            "chaos armed: plan=%s seed=%d faults=%d",
            plan.name, plan.seed, len(plan.faults),
        )

    def disarm(self) -> None:
        with self._mu:
            self._plan = None
            self._armed = []
            self._counters = {}
            self._trace = []
            self._trace_file = ""

    def add_fault(self, spec: FaultSpec) -> None:
        """Append one spec to the armed plan (arming an empty plan if
        none is active).  Counters and the trace are preserved."""
        with self._mu:
            if self._plan is None:
                self._plan = ChaosPlan(name="adhoc", seed=0)
            self._plan.faults.append(spec)
            self._armed.append(_ArmedSpec(spec, self._plan.seed))

    def remove_faults(self, point_pattern: str) -> int:
        """Drop every armed spec whose pattern equals ``point_pattern``;
        returns how many were removed."""
        with self._mu:
            before = len(self._armed)
            self._armed = [
                a for a in self._armed if a.spec.point != point_pattern
            ]
            if self._plan is not None:
                self._plan.faults = [
                    f for f in self._plan.faults
                    if f.point != point_pattern
                ]
            return before - len(self._armed)

    @property
    def armed(self) -> bool:
        return bool(self._armed)

    @property
    def plan(self) -> Optional[ChaosPlan]:
        return self._plan

    # -- the hot path ------------------------------------------------------

    def point(self, name: str, **ctx: Any) -> Optional[Fault]:
        """Evaluate the armed plan at injection point ``name``.

        Raises for ``exception`` faults, sleeps for ``delay`` faults,
        invokes ``callback`` faults, and RETURNS ``torn_write`` /
        ``drop`` / ``flap`` faults for the caller to act on.  Returns
        None when nothing fires."""
        with self._mu:
            if not self._armed:
                return None
            call_index = self._counters.get(name, 0)
            self._counters[name] = call_index + 1
            hit: Optional[_ArmedSpec] = None
            for armed in self._armed:
                if not fnmatch.fnmatchcase(name, armed.spec.point):
                    continue
                if armed.should_fire(call_index):
                    hit = armed
                    break
            if hit is None:
                return None
            spec = hit.spec
            if spec.kind == FLAP:
                if hit.flap_left == 0:
                    hit.flap_left = max(1, spec.flap_count)
                    hit.fired += 1
                hit.flap_left -= 1
            else:
                hit.fired += 1
            fault = Fault(
                kind=spec.kind,
                spec=spec,
                point=name,
                call_index=call_index,
                seq=len(self._trace),
            )
            live_span = _current_trace_span()
            record = {
                "seq": fault.seq,
                "point": name,
                "kind": spec.kind,
                "call": call_index,
                # fault -> span attribution: which traced operation the
                # injection landed in (empty when no span is live).
                # NOTE: ids are random per run — determinism checks
                # must compare presence, not values (chaos_drill
                # normalizes them to booleans).
                "trace_id": live_span.trace_id if live_span else "",
                "span_id": live_span.span_id if live_span else "",
            }
            # bounded: a callback spec fires on EVERY matching call
            # (e.g. every streamed chunk) and must not grow the trace
            # without limit on a long drill
            if len(self._trace) < 100_000:
                self._trace.append(record)
            trace_file = self._trace_file
        # side effects OUTSIDE the lock: a delay fault must not serialize
        # every other injection point behind its sleep
        if trace_file:
            self._append_trace(trace_file, record)
        if live_span is not None:
            # the fault becomes an EVENT on the live span: the merged
            # timeline shows the injection inside the RPC/storage span
            # it fired in (joined back to this record by `seq`)
            live_span.add_event(
                "chaos.fault",
                point=name, kind=spec.kind, seq=fault.seq,
                call=call_index,
            )
        _record_fault_metric(name, spec.kind)
        _record_fault_flight(record)
        log = logger.debug if spec.kind == CALLBACK else logger.info
        log(
            "chaos fired: %s kind=%s call=%d seq=%d",
            name, spec.kind, call_index, fault.seq,
        )
        if spec.kind == DELAY:
            time.sleep(spec.delay_s)
            return fault
        if spec.kind == EXCEPTION:
            exc_type = spec.exception or ChaosError
            raise exc_type(
                spec.message
                or f"chaos: injected failure at {name} (call {call_index})"
            )
        if spec.kind == CALLBACK and spec.callback is not None:
            spec.callback(**ctx)
            return fault
        return fault

    @staticmethod
    def _append_trace(path: str, record: Dict[str, Any]) -> None:
        try:
            with open(path, "a") as f:
                f.write(json.dumps(record) + "\n")
        except OSError as e:
            logger.warning("chaos trace append to %s failed: %s", path, e)

    # -- introspection -----------------------------------------------------

    def trace(self) -> List[Dict[str, Any]]:
        with self._mu:
            return list(self._trace)

    def call_count(self, name: str) -> int:
        with self._mu:
            return self._counters.get(name, 0)


# ---------------------------------------------------------------------------
# Module-level singleton + the fast-path guard.
#
# ``_ACTIVE`` is a plain bool read without the lock: Python guarantees
# atomic reads of object attributes, and the worst case of a stale read
# is one extra (or one missed) lock acquisition at arming time — never
# a correctness issue for production, where chaos is off for the whole
# process lifetime.
# ---------------------------------------------------------------------------

_ENGINE = ChaosEngine()
_ACTIVE = False
_ENV_LOADED = False
_ENV_MU = threading.Lock()


def engine() -> ChaosEngine:
    return _ENGINE


def is_active() -> bool:
    return _ACTIVE


def configure(plan: ChaosPlan, trace_file: str = "") -> None:
    """Arm ``plan`` for this process.  Tests/drills only: a production
    process arms through ``DLROVER_TPU_CHAOS``."""
    global _ACTIVE
    _ENGINE.arm(plan, trace_file=trace_file)
    _ACTIVE = True


def inject(spec: FaultSpec) -> None:
    """Arm one extra fault (tests/drills only)."""
    global _ACTIVE
    _ENGINE.add_fault(spec)
    _ACTIVE = True


def clear(point_pattern: Optional[str] = None) -> None:
    """Remove faults for ``point_pattern`` (None = disarm everything)."""
    global _ACTIVE, _ENV_LOADED
    if point_pattern is None:
        _ENGINE.disarm()
        _ACTIVE = False
        # re-open the env probe: a test that sets DLROVER_TPU_CHAOS
        # after a clear() must still be able to arm lazily
        _ENV_LOADED = False
        return
    _ENGINE.remove_faults(point_pattern)
    if not _ENGINE.armed:
        _ACTIVE = False


def trace() -> List[Dict[str, Any]]:
    return _ENGINE.trace()


def _load_from_env() -> None:
    """Arm from DLROVER_TPU_CHAOS_* once per process (worker processes
    of a drill inherit the spec through their env)."""
    global _ENV_LOADED
    with _ENV_MU:
        if _ENV_LOADED:
            return
        _ENV_LOADED = True
        from dlrover_tpu_torch.common import envs

        if not envs.get_bool("DLROVER_TPU_CHAOS"):
            return
        spec = envs.get_str("DLROVER_TPU_CHAOS_SPEC")
        if not spec:
            logger.warning(
                "DLROVER_TPU_CHAOS set without DLROVER_TPU_CHAOS_SPEC; "
                "nothing armed"
            )
            return
        try:
            if spec.lstrip().startswith("{"):
                text = spec
            else:
                with open(spec) as f:  # one-time load
                    text = f.read()
            plan = ChaosPlan.from_json(text)
        except (OSError, ValueError) as e:
            logger.warning("chaos spec %r unusable: %s", spec, e)
            return
        seed = envs.get_int("DLROVER_TPU_CHAOS_SEED", default=plan.seed)
        plan.seed = seed
        configure(
            plan, trace_file=envs.get_str("DLROVER_TPU_CHAOS_TRACE_FILE")
        )


def point(name: str, **ctx: Any) -> Optional[Fault]:
    """THE injection point.  Near-free when chaos is off: after the
    one-time env probe, the disarmed path is two module-bool checks."""
    if not _ACTIVE:
        if not _ENV_LOADED:
            _load_from_env()
            if _ACTIVE:
                return _ENGINE.point(name, **ctx)
        return None
    return _ENGINE.point(name, **ctx)
