"""Compile observatory: the kernel builds a watched call paid, attributed.

Port of ``dlrover_tpu/observability/jitscope.py``.  The port compiles no
step: its compile is the kernel build at first use (``ops/cuda/_build.py``
``build``).  A library whose source-hash file already exists is a
persistent-cache **hit**; an nvcc run is a **miss**, with its seconds.
:func:`install` hooks that (``_build.add_listener``) and nothing else,
counting per thread and per process.

:class:`JitScope` (process singleton, :func:`scope`)
    The per-process compile ledger.  :func:`watch` wraps a callable (the
    trainer's step); on each call the wrapper snapshots the thread's
    counters, and a nonzero delta means THIS call resolved libraries: the
    scope records a **compile event** (function name, measured build
    seconds, cache hit or miss) with a **trigger** classified by diffing
    the call's signature (per-leaf shape, dtype, placement, the device or
    mesh, caller-declared statics) against the call site's last one
    (:data:`TRIGGERS`, :func:`classify_trigger`).  Events are spans
    (``jitscope.compile``) too, so they land in the flight recorder.

**Dispatch-stall probe**
    A watched call that blocks the host longer than
    ``DLROVER_TPU_JITSCOPE_STALL_MS`` while build work landed in its
    window emits a ``jitscope.dispatch_stall`` span; a daemon thread
    drops a ``jitscope.stall_detected`` event into the recorder while the
    call is still blocked.

**The digest**
    ``js_*`` keys (cumulative; an agent folds several ranks' files with
    :func:`merge_digest`, :data:`DIGEST_MERGE`) ride the rank's digest
    file.

**The persistent cache**
    The kernel build directory is the port's persistent compile cache
    (the reference's is XLA's cache dir).  A scope made without explicit
    flags seeds ``warm_expected`` and ``cache_enabled`` from the worker
    bootstrap's boot state (:func:`_cache_info`,
    ``trainer/bootstrap.compile_cache_info``): a warm start is expected
    when the directory held libraries at boot or the process is a
    restart.  :func:`persistent_cache_override` points the build at
    another directory for its duration (drills, tests).

Chaos: :data:`COMPILE_POINT` fires inside every detected compile
window, so a seeded DELAY is injected compile seconds — the
deterministic storm the ``cache_cold`` drill scenario prices.

Everything is guarded: a broken observatory never breaks a call, and
``DLROVER_TPU_JITSCOPE=0`` turns every hook into a flag check.
"""

import contextlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.pytree import flatten_with_path

#: chaos injection point: fires inside every detected compile window
#: (after the call, while the window is still open), so a seeded
#: DELAY fault IS injected compile time — the deterministic
#: recompile-storm the drills price.
COMPILE_POINT = "jitscope.compile"

#: the trigger taxonomy, classification priority order
TRIGGERS: Tuple[str, ...] = (
    "first-trace",
    "persistent-cache-miss",
    "mesh-change",
    "arg-shape-delta",
    "dtype-delta",
    "sharding-delta",
    "donation-mismatch",
    "retrace",
)

#: digest-key schema (flat floats riding ``comm.HeartBeat.digest``).
#: All cumulative except the markers; the agent merges rank files per
#: :data:`DIGEST_MERGE` and the master differentiates across ``js_seq``
#: advances.
DIGEST_PREFIX = "js_"

#: digest key -> merge rule across one host's rank files
#: (``elastic_agent._collect_digest``): "max" | "min" | "sum".
#: Counters SUM (node totals; the hit ratio derives from the sums),
#: markers take max (newest event ts; warm/cache are per-host flags).
DIGEST_MERGE: Dict[str, str] = {
    "js_ts": "max",
    "js_boot": "max",
    "js_seq": "sum",
    "js_compile_s": "sum",
    "js_hits": "sum",
    "js_misses": "sum",
    "js_stalls": "sum",
    "js_warm": "max",
    "js_cache": "max",
}


def enabled() -> bool:
    return envs.get_bool("DLROVER_TPU_JITSCOPE")


# ---------------------------------------------------------------------------
# The kernel-build listener: per-thread + process-total compile counters.
# Registered once per process; it writes to module-level accumulators so
# scope resets never re-register.
# ---------------------------------------------------------------------------


class _Counters(threading.local):
    """Per-thread compile accumulators (a kernel library is built in the
    thread whose call first needs it, so a watched call's delta is
    exactly its own build work)."""

    def __init__(self):
        self.compile_s = 0.0
        self.hits = 0
        self.misses = 0


_tls = _Counters()
_totals_mu = threading.Lock()
_TOTALS = {"compile_s": 0.0, "hits": 0, "misses": 0}
_installed = False
_install_mu = threading.Lock()


def _on_build(name: str, cached: bool, seconds: float) -> None:
    """One library ``_build.build`` resolved: a hit when its source-hash
    file existed, else a miss with the seconds nvcc ran."""
    if cached:
        _tls.hits += 1
    else:
        _tls.misses += 1
        _tls.compile_s += max(0.0, seconds)
    with _totals_mu:
        if cached:
            _TOTALS["hits"] += 1
        else:
            _TOTALS["misses"] += 1
            _TOTALS["compile_s"] += max(0.0, seconds)


def install() -> bool:
    """Hook the kernel build (``ops/cuda/_build.py``: every library it
    resolves) and nothing else; idempotent, returns whether the hook is
    live.  Called from the worker bootstrap and lazily by the first
    :func:`watch` call."""
    global _installed
    if _installed:
        return True
    with _install_mu:
        if not _installed:
            from dlrover_tpu_torch.ops.cuda import _build

            _build.add_listener(_on_build)
            _installed = True
    return True


def _thread_counters() -> Tuple[float, int, int]:
    return _tls.compile_s, _tls.hits, _tls.misses


def totals() -> Dict[str, float]:
    """Process-wide compile counters (all threads, watched or not)."""
    with _totals_mu:
        return dict(_TOTALS)


# ---------------------------------------------------------------------------
# Abstract signatures + trigger classification.
# ---------------------------------------------------------------------------


def _placement(leaf: Any) -> Tuple[str, str]:
    """``(spec, mesh fingerprint)`` of a tensor: a DTensor's placements
    and its device mesh's axes and size; a plain tensor's device."""
    mesh = getattr(leaf, "device_mesh", None)
    if mesh is None:
        return "", str(leaf.device)
    try:
        shape = tuple(sorted(zip(mesh.mesh_dim_names or (),
                                 (int(s) for s in mesh.shape))))
        return str(tuple(leaf.placements)), f"{shape}x{mesh.size()}"
    except Exception:  # noqa: BLE001 - a mesh we cannot fingerprint
        return str(getattr(leaf, "placements", "")), "mesh?"


def signature_of(args: tuple, kwargs: dict,
                 static: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The abstract signature of one call: per-leaf shape/dtype/placement
    tuples, the set of device or mesh fingerprints, and the
    caller-declared statics.  Leaves are the tensors (and arrays) of the
    arguments; a leaf without a shape (the step, a count) contributes
    its type.  Computed ONLY when a compile was detected, never on the
    hot path."""
    shapes: List[Tuple] = []
    dtypes: List[str] = []
    specs: List[str] = []
    meshes: set = set()
    for _, leaf in flatten_with_path((args, kwargs)):
        shape = getattr(leaf, "shape", None)
        if shape is None:
            shapes.append((type(leaf).__name__,))
            dtypes.append(type(leaf).__name__)
            specs.append("")
            continue
        shapes.append(tuple(int(d) for d in shape))
        dtypes.append(str(getattr(leaf, "dtype", "")))
        if torch.is_tensor(leaf):
            spec, mesh = _placement(leaf)
            specs.append(spec)
            meshes.add(mesh)
        else:
            specs.append("")
    return {
        "shapes": tuple(shapes),
        "dtypes": tuple(dtypes),
        "specs": tuple(specs),
        "meshes": tuple(sorted(meshes)),
        "static": dict(static or {}),
    }


def classify_trigger(prev: Optional[Dict[str, Any]],
                     cur: Dict[str, Any],
                     missed: bool,
                     cache_enabled: bool,
                     warm_expected: bool) -> str:
    """Why did this call compile?  Diff against the call site's
    last-seen signature; a cold call site is ``first-trace`` unless the
    persistent cache was supposed to absorb it and did not."""
    if prev is None:
        if missed and cache_enabled and warm_expected:
            return "persistent-cache-miss"
        return "first-trace"
    if prev["meshes"] != cur["meshes"]:
        return "mesh-change"
    if prev["shapes"] != cur["shapes"]:
        return "arg-shape-delta"
    if prev["dtypes"] != cur["dtypes"]:
        return "dtype-delta"
    if prev["specs"] != cur["specs"]:
        return "sharding-delta"
    if prev["static"] != cur["static"]:
        return "donation-mismatch"
    if missed and cache_enabled:
        return "persistent-cache-miss"
    return "retrace"


# ---------------------------------------------------------------------------
# The process scope.
# ---------------------------------------------------------------------------


class JitScope:
    """Per-process compile ledger: bounded event ring, per-call-site
    last-seen signatures, stall bookkeeping, the digest.  One instance
    per process (see :func:`scope`); tests may build private ones."""

    def __init__(self, warm_expected: Optional[bool] = None,
                 cache_enabled: Optional[bool] = None):
        self._mu = threading.Lock()
        # boot marker: lets the master distinguish "this process
        # restarted" from "more events landed" even when the new
        # boot's event count EXCEEDS the dead boot's (cross-boot
        # deltas were the gp_seq/mm_ts bug class of r15/r17)
        self._boot = time.time()
        self._events: List[Dict[str, Any]] = []
        self._cap = max(16, envs.get_int("DLROVER_TPU_JITSCOPE_EVENTS"))
        # call-site name -> last-seen signature (updated on compiles)
        self._last_sig: Dict[str, Dict[str, Any]] = {}
        self._compile_s = 0.0
        self._hits = 0
        self._misses = 0
        self._stalls = 0
        self._seq = 0
        self._last_ts = 0.0
        self._last_event: Optional[Dict[str, Any]] = None
        if warm_expected is None or cache_enabled is None:
            info = _cache_info()
            if warm_expected is None:
                warm_expected = bool(
                    info.get("entries_at_boot", 0)
                ) or bool(info.get("restart", False))
            if cache_enabled is None:
                cache_enabled = bool(info.get("enabled", False))
        self.warm_expected = bool(warm_expected)
        self.cache_enabled = bool(cache_enabled)

    # -- recording ----------------------------------------------------------

    def record_compile(
        self,
        name: str,
        signature: Dict[str, Any],
        compile_s: float,
        hits: int,
        misses: int,
        start_ts: float,
        end_ts: float,
        wall_s: float,
    ) -> Dict[str, Any]:
        """One detected compile on a watched call site: classify the
        trigger, append the event, emit the span.  Returns the event."""
        with self._mu:
            prev = self._last_sig.get(name)
            trigger = classify_trigger(
                prev, signature, misses > 0,
                self.cache_enabled, self.warm_expected,
            )
            self._last_sig[name] = signature
            # a mixed window (one library cached, another built) is a
            # MISS: something still had to compile
            cache = (
                "off" if not self.cache_enabled
                else "miss" if misses > 0
                else "hit" if hits > 0
                else "uncached"  # below the cache's min-compile floor
            )
            event = {
                "ts": round(end_ts, 6),
                "fn": name,
                "trigger": trigger,
                "cache": cache,
                "compile_s": round(compile_s, 6),
                "dispatch_s": round(wall_s, 6),
            }
            self._events.append(event)
            del self._events[:-self._cap]
            self._compile_s += compile_s
            self._hits += hits
            self._misses += misses
            self._seq += 1
            self._last_ts = end_ts
            self._last_event = event
        try:
            from dlrover_tpu_torch.observability import metrics as obs_metrics

            reg = obs_metrics.registry()
            reg.counter_inc(
                "dlrover_tpu_compile_seconds_total", compile_s,
                help=obs_metrics._help(
                    "dlrover_tpu_compile_seconds_total"
                ),
                fn=name,
            )
            reg.counter_inc(
                "dlrover_tpu_recompile_total",
                help=obs_metrics._help("dlrover_tpu_recompile_total"),
                fn=name, trigger=trigger,
            )
        except Exception:  # noqa: BLE001 - metrics must not break
            pass  # a dispatch
        _emit_span(
            "jitscope.compile", start_ts, end_ts,
            {"fn": name, "trigger": trigger, "cache": cache,
             "compile_s": round(compile_s, 6)},
        )
        return event

    def record_stall(self, name: str, start_ts: float, end_ts: float,
                     compile_s: float) -> None:
        """A watched call that blocked the host past the stall
        threshold while compile work landed in its window."""
        with self._mu:
            self._stalls += 1
        try:
            from dlrover_tpu_torch.observability import metrics as obs_metrics

            obs_metrics.registry().counter_inc(
                "dlrover_tpu_dispatch_stall_total",
                help=obs_metrics._help(
                    "dlrover_tpu_dispatch_stall_total"
                ),
                fn=name,
            )
        except Exception:  # noqa: BLE001 - metrics must not break
            pass  # a dispatch
        _emit_span(
            "jitscope.dispatch_stall", start_ts, end_ts,
            {"fn": name, "compile_s": round(compile_s, 6),
             "blocked_s": round(end_ts - start_ts, 6)},
        )

    # -- reading ------------------------------------------------------------

    @property
    def last_event(self) -> Optional[Dict[str, Any]]:
        with self._mu:
            return dict(self._last_event) if self._last_event else None

    def events(self) -> List[Dict[str, Any]]:
        with self._mu:
            return [dict(e) for e in self._events]

    def summary(self) -> Dict[str, Any]:
        with self._mu:
            events = [dict(e) for e in self._events]
            by_trigger: Dict[str, int] = {}
            by_fn: Dict[str, float] = {}
            for event in events:
                by_trigger[event["trigger"]] = by_trigger.get(
                    event["trigger"], 0
                ) + 1
                by_fn[event["fn"]] = by_fn.get(
                    event["fn"], 0.0
                ) + event["compile_s"]
            looked_up = self._hits + self._misses
            return {
                "events": self._seq,
                "compile_s": round(self._compile_s, 6),
                "cache_hits": self._hits,
                "cache_misses": self._misses,
                "cache_hit_ratio": (
                    round(self._hits / looked_up, 6)
                    if looked_up else None
                ),
                "cache_enabled": self.cache_enabled,
                "warm_expected": self.warm_expected,
                "stalls": self._stalls,
                "by_trigger": by_trigger,
                "compile_s_by_fn": {
                    fn: round(s, 6) for fn, s in by_fn.items()
                },
                "recent": events[-8:],
            }

    def digest(self) -> Dict[str, float]:
        """Flat cumulative account for the heartbeat digest channel;
        the master differentiates across ``js_seq`` advances."""
        with self._mu:
            return {
                "js_ts": round(self._last_ts, 6),
                "js_boot": round(self._boot, 3),
                "js_seq": float(self._seq),
                "js_compile_s": round(self._compile_s, 6),
                "js_hits": float(self._hits),
                "js_misses": float(self._misses),
                "js_stalls": float(self._stalls),
                "js_warm": 1.0 if self.warm_expected else 0.0,
                "js_cache": 1.0 if self.cache_enabled else 0.0,
            }


def merge_digest(digest: Dict[str, float],
                 rank_digest: Dict[str, Any]) -> None:
    """Merge one rank file's ``js_*`` keys into the host digest per
    :data:`DIGEST_MERGE` (called by ``elastic_agent._collect_digest``)."""
    for key, rule in DIGEST_MERGE.items():
        value = rank_digest.get(key)
        if value is None:
            continue
        value = float(value)
        if rule == "sum":
            digest[key] = digest.get(key, 0.0) + value
        elif rule == "min":
            digest[key] = (
                value if key not in digest else min(digest[key], value)
            )
        else:
            digest[key] = max(digest.get(key, 0.0), value)


# ---------------------------------------------------------------------------
# The watch wrapper + dispatch-stall probe.
# ---------------------------------------------------------------------------

#: thread ident -> {"name", "start_ts", "flagged"} for every watched
#: call currently blocking its host thread (the stall probe's registry)
_INFLIGHT: Dict[int, Dict[str, Any]] = {}
_inflight_mu = threading.Lock()


class _StallProbe:
    """Daemon poller: a compile STILL in flight past the threshold
    drops a ``jitscope.stall_detected`` event into the flight recorder
    — evidence an incident dump can capture before the dispatch
    returns."""

    def __init__(self):
        self._started = False
        self._mu = threading.Lock()

    def ensure_started(self) -> None:
        if self._started:
            return
        with self._mu:
            if self._started:
                return
            self._started = True
            thread = threading.Thread(
                target=self._loop, daemon=True, name="jitscope-stall"
            )
            thread.start()

    def _loop(self) -> None:
        while True:
            threshold = _stall_s()
            time.sleep(max(0.05, threshold / 4 if threshold > 0 else 1.0))
            if threshold <= 0:
                continue
            now = time.time()
            flagged: List[Dict[str, Any]] = []
            with _inflight_mu:
                for entry in _INFLIGHT.values():
                    if (
                        not entry["flagged"]
                        and now - entry["start_ts"] >= threshold
                    ):
                        entry["flagged"] = True
                        flagged.append(dict(entry))
            for entry in flagged:
                try:
                    from dlrover_tpu_torch.observability import flight_recorder

                    flight_recorder.on_event({
                        "ts": round(now, 6),
                        "type": "INSTANT",
                        "name": "jitscope.stall_detected",
                        "content": {
                            "fn": entry["name"],
                            "blocked_s": round(
                                now - entry["start_ts"], 3
                            ),
                        },
                    })
                except Exception as e:  # noqa: BLE001 - evidence is
                    logger.debug(  # best-effort
                        "jitscope stall event failed: %s", e
                    )


_STALL_PROBE = _StallProbe()


def _stall_s() -> float:
    return envs.get_float("DLROVER_TPU_JITSCOPE_STALL_MS") / 1000.0


class WatchedFunction:
    """The :func:`watch` wrapper: counts this thread's compile work
    around each call; a nonzero delta records a classified compile
    event on the scope.  The cached hot path costs two counter reads
    and one registry insert/remove."""

    def __init__(self, fn: Callable, name: str,
                 static: Optional[Dict[str, Any]] = None):
        self._fn = fn
        self.name = name
        self._static = dict(static or {})
        self.last_event: Optional[Dict[str, Any]] = None

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        if not enabled():
            return self._fn(*args, **kwargs)
        install()
        _STALL_PROBE.ensure_started()
        ident = threading.get_ident()
        with _inflight_mu:
            nested = ident in _INFLIGHT
        if nested:
            # nested watched call: the OUTER site owns this thread's
            # window — measuring here would double-count the compile
            # seconds and clobber the stall registry.  Dispatch OUTSIDE
            # the lock: a nested compile must not block every other
            # thread's registry insert (or the stall probe itself).
            return self._fn(*args, **kwargs)
        c0, h0, m0 = _thread_counters()
        start_ts = time.time()
        self.last_event = None
        with _inflight_mu:
            _INFLIGHT[ident] = {
                "name": self.name, "start_ts": start_ts, "flagged": False,
            }
        try:
            result = self._fn(*args, **kwargs)
        finally:
            with _inflight_mu:
                _INFLIGHT.pop(ident, None)
        c1, h1, m1 = _thread_counters()
        compile_s = c1 - c0
        if compile_s <= 0 and h1 == h0 and m1 == m0:
            return result  # the cached hot path
        try:
            # the chaos point fires INSIDE the still-open window: a
            # seeded DELAY is injected compile time, priced as exactly
            # the time the point call took (the sleep), nothing more
            from dlrover_tpu_torch import chaos

            point_t0 = time.time()
            if chaos.point(COMPILE_POINT, fn=self.name) is not None:
                compile_s += time.time() - point_t0
        except Exception:  # noqa: BLE001 - chaos must not break dispatch
            pass
        end_ts = time.time()
        wall_s = end_ts - start_ts
        # the libraries of one build run their nvcc side by side, so
        # their summed seconds can exceed the call's wall: clamp, this
        # call cannot have compiled longer than it ran
        compile_s = min(compile_s, wall_s)
        try:
            signature = signature_of(args, kwargs, self._static)
            self.last_event = scope().record_compile(
                self.name, signature, compile_s,
                h1 - h0, m1 - m0, start_ts, end_ts, wall_s,
            )
            threshold = _stall_s()
            if threshold > 0 and wall_s >= threshold:
                scope().record_stall(
                    self.name, start_ts, end_ts, compile_s
                )
        except Exception as e:  # noqa: BLE001 - the observatory must
            # never break a dispatch
            logger.debug("jitscope record failed: %s", e)
        return result


def watch(fn: Callable, name: str,
          static: Optional[Dict[str, Any]] = None) -> WatchedFunction:
    """Wrap a callable (the trainer's step) as a watched call site.  ``static``
    carries caller-declared compile-relevant flags (e.g.
    ``{"donate": True}``) so their changes classify as
    ``donation-mismatch``."""
    return WatchedFunction(fn, name, static=static)


# ---------------------------------------------------------------------------
# Span synthesis (events are known post-hoc, so the live trace.span
# context cannot carry them; records flow through the same export path).
# ---------------------------------------------------------------------------


def _emit_span(name: str, start_ts: float, end_ts: float,
               attrs: Dict[str, Any]) -> None:
    try:
        from dlrover_tpu_torch.observability import trace

        if not trace.enabled():
            # tracing off: the flight recorder still gets the evidence
            from dlrover_tpu_torch.observability import flight_recorder

            flight_recorder.on_span({
                "ts": round(start_ts, 6),
                "dur": round(max(0.0, end_ts - start_ts), 6),
                "name": name, "type": "SPAN", "kind": "internal",
                "trace_id": "", "span_id": "", "parent_span_id": "",
                "status": "ok", "attrs": attrs, "events": [],
            })
            return
        sp = trace.Span(
            name, trace.INTERNAL, trace.new_trace_id(),
            trace.new_span_id(), attrs=attrs,
        )
        sp.start_ts = start_ts
        sp.end()
        sp.end_ts = end_ts
        trace._export(sp)
    except Exception as e:  # noqa: BLE001 - telemetry must not break
        logger.debug("jitscope span emit failed: %s", e)


@contextlib.contextmanager
def persistent_cache_override(cache_dir: str):
    """Point the kernel build at ``cache_dir`` for the duration (drills,
    smokes, tests), with ``_build``'s library memo cleared, as the
    reference resets jax's "is the cache used" marker.  A library loaded
    before stays mapped and is neither unloaded nor rebuilt; on exit the
    build directory and the memo are the ones from before, even on an
    exception.  The reference's minimum compile time worth caching
    (``DLROVER_TPU_COMPILE_CACHE_MIN_S``) has no counterpart: every
    build is cached."""
    from dlrover_tpu_torch.ops.cuda import _build

    with _build.directory_override(cache_dir):
        yield


# ---------------------------------------------------------------------------
# Persistent-cache boot state (fed by trainer/bootstrap.py).
# ---------------------------------------------------------------------------


def _cache_info() -> Dict[str, Any]:
    try:
        from dlrover_tpu_torch.trainer import bootstrap

        return bootstrap.compile_cache_info()
    except Exception:  # noqa: BLE001 - bootstrap not importable
        return {}


_SCOPE: Optional[JitScope] = None
_SCOPE_MU = threading.Lock()


def scope() -> JitScope:
    """The process singleton every watched call writes to."""
    global _SCOPE
    if _SCOPE is None:
        with _SCOPE_MU:
            if _SCOPE is None:
                _SCOPE = JitScope()
    return _SCOPE


def reset_scope(warm_expected: Optional[bool] = None,
                cache_enabled: Optional[bool] = None) -> JitScope:
    """Replace the singleton (tests, per-boot drill isolation)."""
    global _SCOPE
    with _SCOPE_MU:
        _SCOPE = JitScope(
            warm_expected=warm_expected, cache_enabled=cache_enabled
        )
        return _SCOPE
