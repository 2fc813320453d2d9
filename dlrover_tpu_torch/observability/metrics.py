"""RED metrics registry (rate, errors, duration) with Prometheus text.

Copy of ``dlrover_tpu/observability/metrics.py``: counters, gauges, pull
gauges and fixed-bucket histograms under one lock, rendered in the
Prometheus text exposition format (0.0.4), with the same metric catalog
(:data:`METRICS`).  The port's memory, comm and compile scopes write their
counters and gauges here (``mem_samples_total``,
``comm_probe_latency_us``, ``comm_bucket_exchange_seconds``,
``compile_seconds_total``, ...), and the job runtime its RPCs, retries,
breakers, admission refusals and long-polls (:func:`observe_rpc`,
:func:`record_retry`, :func:`record_breaker`, :func:`record_overload`,
:func:`record_longpoll_coalesced`, :func:`observe_longpoll`), the
checkpoint path its phases (:func:`observe_ckpt_phase`), the chaos engine
its faults (:func:`record_chaos_fault`) and the incident engine its
counts, the master's time-series store its pull gauges
(``goodput_ledger``, ``step_p50_seconds``, ``mem_used_bytes``, ...), the
sentinels their fires (:func:`record_sentinel_breach`), the worker
bootstrap a compile cache it could not enable, and the servicer's shard
telemetry its data gauges (``data_backlog``, ``data_shards_per_second``,
``data_lease_p99_ms``).  Left out, with their callers (ROADMAP item 11,
the rest): the catalog's entries of the brain, and the catalog's
markdown generator.

Deliberately dependency-free (no prometheus_client).  Cardinality is
bounded: at most ``DLROVER_TPU_METRICS_MAX_SERIES`` label combinations
live per process; beyond that new series are dropped and counted in
``dlrover_tpu_metrics_dropped_series_total``.
"""

import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

from dlrover_tpu_torch.common import envs

#: default duration buckets (seconds): control-plane RPCs live in the
#: 1ms..60s range; checkpoint persists reach minutes
DURATION_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _render_labels(key: _LabelKey, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class MetricsRegistry:
    def __init__(self, max_series: Optional[int] = None):
        self._mu = threading.Lock()
        self._max_series = max_series
        # name -> (type, help)
        self._meta: Dict[str, Tuple[str, str]] = {}
        self._counters: Dict[str, Dict[_LabelKey, float]] = {}
        self._gauges: Dict[str, Dict[_LabelKey, float]] = {}
        # name -> {labels: [bucket_counts..., +Inf], sum, count}
        self._histograms: Dict[str, Dict[_LabelKey, Dict[str, Any]]] = {}
        self._buckets: Dict[str, Tuple[float, ...]] = {}
        # collect-on-read gauges: evaluated at scrape/snapshot time so
        # hot paths never pay registry traffic to keep a gauge fresh
        self._gauge_fns: Dict[str, Dict[_LabelKey, Any]] = {}
        self._dropped = 0

    # -- internals ---------------------------------------------------------

    def _series_budget_ok(self, table: Dict, key: _LabelKey) -> bool:
        """Under the lock: True when (name, labels) may be admitted."""
        if key in table:
            return True
        limit = self._max_series
        if limit is None:
            limit = envs.get_int("DLROVER_TPU_METRICS_MAX_SERIES")
        total = sum(
            len(per_name)
            for group in (self._counters, self._gauges, self._histograms)
            for per_name in group.values()
        )
        if total >= limit:
            self._dropped += 1
            return False
        return True

    # -- mutation ----------------------------------------------------------

    def counter_inc(self, name: str, value: float = 1.0, help: str = "",
                    **labels: Any) -> None:
        key = _label_key(labels)
        with self._mu:
            self._meta.setdefault(name, ("counter", help))
            table = self._counters.setdefault(name, {})
            if not self._series_budget_ok(table, key):
                return
            table[key] = table.get(key, 0.0) + value

    def gauge_set(self, name: str, value: float, help: str = "",
                  **labels: Any) -> None:
        key = _label_key(labels)
        with self._mu:
            self._meta.setdefault(name, ("gauge", help))
            table = self._gauges.setdefault(name, {})
            if not self._series_budget_ok(table, key):
                return
            table[key] = float(value)

    def gauge_fn(self, name: str, fn: Any, help: str = "",
                 **labels: Any) -> None:
        """Register a pull gauge: ``fn()`` is evaluated at read time
        (render/snapshot/gauge_value), so instrumenting a hot path costs
        nothing per operation.  Re-registering the same (name, labels)
        replaces the callback."""
        key = _label_key(labels)
        with self._mu:
            self._meta.setdefault(name, ("gauge", help))
            self._gauge_fns.setdefault(name, {})[key] = fn

    def _collect(self) -> None:
        """Fold registered pull gauges into the gauge tables.  Callbacks
        run OUTSIDE the registry lock — they may take their owner's lock
        (e.g. an admission pool's Condition)."""
        with self._mu:
            pending = [
                (name, key, fn)
                for name, fns in self._gauge_fns.items()
                for key, fn in fns.items()
            ]
        if not pending:
            return
        values = []
        for name, key, fn in pending:
            try:
                values.append((name, key, float(fn())))
            except Exception:  # noqa: BLE001 - a dead owner must not
                continue  # break the whole scrape
        with self._mu:
            for name, key, value in values:
                table = self._gauges.setdefault(name, {})
                if not self._series_budget_ok(table, key):
                    continue
                table[key] = value

    def observe(self, name: str, value: float,
                buckets: Iterable[float] = DURATION_BUCKETS,
                help: str = "", **labels: Any) -> None:
        key = _label_key(labels)
        with self._mu:
            self._meta.setdefault(name, ("histogram", help))
            bounds = self._buckets.setdefault(name, tuple(buckets))
            table = self._histograms.setdefault(name, {})
            if not self._series_budget_ok(table, key):
                return
            series = table.get(key)
            if series is None:
                series = table[key] = {
                    "buckets": [0] * (len(bounds) + 1),
                    "sum": 0.0,
                    "count": 0,
                }
            for i, bound in enumerate(bounds):
                if value <= bound:
                    series["buckets"][i] += 1
                    break
            else:
                series["buckets"][-1] += 1
            series["sum"] += float(value)
            series["count"] += 1

    def reset(self) -> None:
        with self._mu:
            self._meta.clear()
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._buckets.clear()
            self._gauge_fns.clear()
            self._dropped = 0

    # -- reading -----------------------------------------------------------

    def counter_value(self, name: str, **labels: Any) -> float:
        with self._mu:
            return self._counters.get(name, {}).get(_label_key(labels), 0.0)

    def counter_total(self, name: str) -> float:
        """Sum of a counter across ALL label series (0.0 when absent) —
        the rate sources diagnosticians watch care about volume, not
        which method/pool it landed on."""
        with self._mu:
            return float(sum(self._counters.get(name, {}).values()))

    def gauge_value(self, name: str, **labels: Any) -> Optional[float]:
        self._collect()
        with self._mu:
            return self._gauges.get(name, {}).get(_label_key(labels))

    def histogram_stats(self, name: str, **labels: Any) -> Dict[str, Any]:
        """{"count": n, "sum": s} for one series ({} when absent)."""
        with self._mu:
            series = self._histograms.get(name, {}).get(_label_key(labels))
            if series is None:
                return {}
            return {"count": series["count"], "sum": series["sum"]}

    def snapshot(self) -> Dict[str, Any]:
        """JSON-friendly dump: counters/gauges verbatim, histograms as
        count/sum/avg per series — the shape bench.py records as the
        per-round RED snapshot."""
        self._collect()
        with self._mu:
            out: Dict[str, Any] = {
                "counters": {
                    name: {
                        _render_labels(k) or "{}": v
                        for k, v in table.items()
                    }
                    for name, table in self._counters.items()
                },
                "gauges": {
                    name: {
                        _render_labels(k) or "{}": v
                        for k, v in table.items()
                    }
                    for name, table in self._gauges.items()
                },
                "histograms": {
                    name: {
                        _render_labels(k) or "{}": {
                            "count": s["count"],
                            "sum": round(s["sum"], 6),
                            "avg": round(s["sum"] / s["count"], 6)
                            if s["count"] else 0.0,
                        }
                        for k, s in table.items()
                    }
                    for name, table in self._histograms.items()
                },
            }
            if self._dropped:
                out["dropped_series"] = self._dropped
            return out

    def render(self) -> str:
        """Prometheus text exposition (format 0.0.4)."""
        self._collect()
        with self._mu:
            lines: List[str] = []
            for name in sorted(self._meta):
                type_, help_ = self._meta[name]
                if help_:
                    lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} {type_}")
                if type_ == "counter":
                    for key, value in sorted(self._counters[name].items()):
                        lines.append(
                            f"{name}{_render_labels(key)} {_fmt(value)}"
                        )
                elif type_ == "gauge":
                    # a gauge_fn-only name may have no stored series yet
                    # (callback failed at collect time)
                    table = self._gauges.get(name, {})
                    for key, value in sorted(table.items()):
                        lines.append(
                            f"{name}{_render_labels(key)} {_fmt(value)}"
                        )
                else:
                    bounds = self._buckets.get(name, ())
                    for key, series in sorted(
                        self._histograms[name].items()
                    ):
                        cumulative = 0
                        for i, bound in enumerate(bounds):
                            cumulative += series["buckets"][i]
                            le = 'le="%s"' % _fmt(bound)
                            lines.append(
                                f"{name}_bucket{_render_labels(key, le)}"
                                f" {cumulative}"
                            )
                        cumulative += series["buckets"][-1]
                        le = 'le="+Inf"'
                        lines.append(
                            f"{name}_bucket{_render_labels(key, le)}"
                            f" {cumulative}"
                        )
                        lines.append(
                            f"{name}_sum{_render_labels(key)} "
                            f"{_fmt(series['sum'])}"
                        )
                        lines.append(
                            f"{name}_count{_render_labels(key)} "
                            f"{series['count']}"
                        )
            if self._dropped:
                lines.append(
                    "# TYPE dlrover_tpu_metrics_dropped_series_total counter"
                )
                lines.append(
                    "dlrover_tpu_metrics_dropped_series_total "
                    f"{self._dropped}"
                )
            return "\n".join(lines) + "\n"


def _fmt(value: float) -> str:
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process singleton every instrumentation site writes to."""
    return _registry


# ---------------------------------------------------------------------------
# Metric catalog: the reference's entries (name -> type, labels, help) of
# every metric the port creates; the master and the dashboard key on these
# names, and the scopes take their help strings from it (``_help``).
# ---------------------------------------------------------------------------

#: name -> (type, label names, help)
METRICS: Dict[str, Tuple[str, Tuple[str, ...], str]] = {
    "dlrover_tpu_rpc_requests_total": (
        "counter", ("method", "code", "transport"),
        "control-plane RPCs by method and outcome (code=ok|error|"
        "overload)",
    ),
    "dlrover_tpu_rpc_duration_seconds": (
        "histogram", ("method", "transport"),
        "control-plane RPC service time; long-poll blocks and overload "
        "refusals are excluded (see longpoll_wait_seconds)",
    ),
    "dlrover_tpu_retry_total": (
        "counter", ("policy", "outcome"),
        "retry-policy activity (outcome=attempt_failed|exhausted|"
        "recovered)",
    ),
    "dlrover_tpu_breaker_transitions_total": (
        "counter", ("policy", "state"),
        "circuit-breaker state transitions (state=open|half_open|"
        "closed)",
    ),
    "dlrover_tpu_ckpt_phase_seconds": (
        "histogram", ("phase",),
        "flash-checkpoint phase duration (save/stage/persist/restore)",
    ),
    "dlrover_tpu_ckpt_phase_errors_total": (
        "counter", ("phase",),
        "flash-checkpoint phase failures",
    ),
    "dlrover_tpu_servicer_overload_total": (
        "counter", ("method", "pool"),
        "requests refused by admission control (answered with a "
        "retry-after hint, not executed)",
    ),
    "dlrover_tpu_longpoll_coalesced_total": (
        "counter", ("kind",),
        "long-poll waits coalesced onto an identical in-flight wait",
    ),
    "dlrover_tpu_longpoll_wait_seconds": (
        "histogram", ("kind", "outcome"),
        "server-side long-poll block duration (outcome=hit|expired)",
    ),
    "dlrover_tpu_chaos_faults_total": (
        "counter", ("point", "kind"),
        "chaos faults fired by injection point and kind",
    ),
    "dlrover_tpu_metrics_dropped_series_total": (
        "counter", (),
        "label combinations dropped by the per-process series budget "
        "(DLROVER_TPU_METRICS_MAX_SERIES)",
    ),
    "dlrover_tpu_incidents_open": (
        "gauge", (), "incidents opened but not yet finalized",
    ),
    "dlrover_tpu_incidents_total": (
        "counter", ("kind",), "incidents opened by kind",
    ),
    "dlrover_tpu_comm_probes_total": (
        "counter", ("axis",),
        "active mesh-probe rounds completed per mesh axis (the timed "
        "ppermute/psum micro-collectives feeding the FabricModel)",
    ),
    "dlrover_tpu_comm_probe_latency_us": (
        "gauge", ("axis",),
        "latest probe-measured per-hop latency per mesh axis (µs; the "
        "comm.axis_delay chaos point inflates exactly this)",
    ),
    "dlrover_tpu_comm_probe_bandwidth_gbps": (
        "gauge", ("axis",),
        "latest probe-measured achieved bandwidth per mesh axis (GB/s, "
        "ring all-reduce accounting)",
    ),
    "dlrover_tpu_comm_bucket_exchange_seconds": (
        "histogram", ("transport", "axis"),
        "sampled per-bucket grad-sync chain time "
        "(pack/encode/exchange/decode) by resolved transport tier and "
        "sync axis",
    ),
    "dlrover_tpu_comm_exposed_seconds_total": (
        "counter", ("transport", "axis"),
        "measured exposed (non-overlapped) sync seconds sub-attributed "
        "by transport tier and mesh axis — the breakdown of the goodput "
        "ledger's exposed_comm phase",
    ),
    "dlrover_tpu_mem_samples_total": (
        "counter", (),
        "memory-observatory samples taken by this process (device stats "
        "+ host RSS/shm + the subsystem account)",
    ),
    "dlrover_tpu_mem_host_rss_bytes": (
        "gauge", (),
        "this process's resident set size at the latest memory sample",
    ),
    "dlrover_tpu_compile_seconds_total": (
        "counter", ("fn",),
        "measured XLA compile seconds (jaxpr trace + MLIR lowering + "
        "backend compile) attributed per watched jit call site by the "
        "compile observatory",
    ),
    "dlrover_tpu_recompile_total": (
        "counter", ("fn", "trigger"),
        "compile events per watched call site by classified trigger "
        "(first-trace/arg-shape-delta/dtype-delta/sharding-delta/"
        "mesh-change/donation-mismatch/persistent-cache-miss/retrace)",
    ),
    "dlrover_tpu_dispatch_stall_total": (
        "counter", ("fn",),
        "watched dispatches that blocked the host past "
        "DLROVER_TPU_JITSCOPE_STALL_MS while compile work landed in "
        "their window (each also emits a jitscope.dispatch_stall span)",
    ),
    # the master's time-series store, its pull gauges and the sentinels
    "dlrover_tpu_goodput_ledger": (
        "gauge", (),
        "ledger-derived job goodput: fresh-node mean of the recent "
        "compute share (master time-series store)",
    ),
    "dlrover_tpu_goodput_phase_share": (
        "gauge", ("phase",),
        "recent wall-clock share per goodput-ledger phase (fresh-node "
        "mean; phases: compute/exposed_comm/ckpt_stall/"
        "rendezvous_restart/overload_rideout/compile/idle_unknown)",
    ),
    "dlrover_tpu_step_p50_seconds": (
        "gauge", (),
        "job p50 step time from heartbeat digests (slowest fresh host)",
    ),
    "dlrover_tpu_sentinel_breaches_total": (
        "counter", ("series", "detector"),
        "perf-regression sentinel fires by watched series and detector",
    ),
    "dlrover_tpu_mem_used_bytes": (
        "gauge", (),
        "worst-chip device bytes in use across fresh nodes (job "
        "rollup of the heartbeat mem digests)",
    ),
    "dlrover_tpu_mem_headroom": (
        "gauge", (),
        "worst-case per-chip headroom fraction (limit-used)/limit "
        "across fresh nodes — the mem-pressure sentinel's floor input",
    ),
    "dlrover_tpu_mem_subsystem_bytes": (
        "gauge", ("subsystem",),
        "worst-chip device bytes attributed per owning subsystem "
        "(params/optimizer/ef_residual/grad_sync/compile_workspace/"
        "other) across fresh nodes",
    ),
    "dlrover_tpu_compile_cache_disabled_total": (
        "counter", ("reason",),
        "persistent compile cache could not be enabled at bootstrap "
        "(a fleet-wide cold cache is an incident precursor, not a log "
        "line)",
    ),
    "dlrover_tpu_compile_recent_seconds": (
        "gauge", (),
        "compile seconds of the most recent differentiated per-node "
        "window (job.compile.s; each node's window joins the series "
        "once — the recompile-storm sentinel's input)",
    ),
    "dlrover_tpu_compile_cache_hit_ratio": (
        "gauge", (),
        "persistent-cache hit ratio of the most recent differentiated "
        "per-node window (job.compile.hit_ratio; the cache-cold "
        "sentinel reads the per-node view)",
    ),
    "dlrover_tpu_data_backlog": (
        "gauge", (),
        "data-pipeline backlog depth (todo + doing shards across all "
        "datasets) read live from the master's shard telemetry — the "
        "signal Brain's goodput_marginal arbiter treats as input-bound",
    ),
    "dlrover_tpu_data_shards_per_second": (
        "gauge", (),
        "shard completion throughput over the last datascope flush "
        "window (job.data.shards_per_s)",
    ),
    "dlrover_tpu_data_lease_p99_ms": (
        "gauge", (),
        "p99 master-side shard-lease service latency (dispatch work "
        "only — long-poll queue wait is tracked separately as "
        "job.data.queue_p99_ms; the shard-latency sentinel's input)",
    ),
}


def _help(name: str) -> str:
    return METRICS[name][2]


# ---------------------------------------------------------------------------
# Named helpers of the control plane: one vocabulary, so dashboards key on
# stable metric names.
# ---------------------------------------------------------------------------


def observe_rpc(method: str, ok: bool, dur_s: float,
                transport: str = "master",
                code: Optional[str] = None,
                record_duration: bool = True) -> None:
    """One served/issued RPC: the R, E and D of RED in two writes.
    ``code`` overrides the ok/error outcome label — admission control
    uses ``"overload"`` so shed load is distinguishable from failures
    (an overload was refused with a retry hint, not broken).
    ``record_duration=False`` counts the request without a histogram
    sample: a refusal's ~0s turnaround is not a service time, and a
    flood of them would read as the master getting FASTER under
    overload — the exact regime the duration percentiles diagnose."""
    reg = registry()
    reg.counter_inc(
        "dlrover_tpu_rpc_requests_total",
        help="control-plane RPCs by method and outcome",
        method=method, code=code or ("ok" if ok else "error"),
        transport=transport,
    )
    if record_duration:
        reg.observe(
            "dlrover_tpu_rpc_duration_seconds", dur_s,
            help="control-plane RPC duration (seconds)",
            method=method, transport=transport,
        )


def record_retry(policy: str, outcome: str) -> None:
    """``outcome``: attempt_failed | exhausted | recovered."""
    registry().counter_inc(
        "dlrover_tpu_retry_total",
        help="retry-policy activity by policy name and outcome",
        policy=policy, outcome=outcome,
    )


def record_breaker(policy: str, state: str) -> None:
    """``state``: open | half_open | closed."""
    registry().counter_inc(
        "dlrover_tpu_breaker_transitions_total",
        help="circuit-breaker state transitions by policy name",
        policy=policy, state=state,
    )


def record_overload(method: str, pool: str) -> None:
    """One admission-control rejection (the request was answered with
    ``OVERLOADED`` + retry-after, not executed)."""
    registry().counter_inc(
        "dlrover_tpu_servicer_overload_total",
        help="requests rejected by admission control",
        method=method, pool=pool,
    )


def record_longpoll_coalesced(kind: str) -> None:
    """A long-poll joined an identical in-flight wait instead of
    opening its own (``kind``: kv/rdzv/...)."""
    registry().counter_inc(
        "dlrover_tpu_longpoll_coalesced_total",
        help="long-poll waits coalesced onto an identical in-flight wait",
        kind=kind,
    )


def observe_longpoll(kind: str, dur_s: float, hit: bool) -> None:
    """One served long-poll chunk: how long it blocked and whether the
    awaited state arrived (hit) or the chunk expired (miss)."""
    reg = registry()
    reg.observe(
        "dlrover_tpu_longpoll_wait_seconds", dur_s,
        help="server-side long-poll block duration (seconds)",
        kind=kind, outcome="hit" if hit else "expired",
    )


def observe_ckpt_phase(phase: str, dur_s: float, ok: bool = True) -> None:
    """Checkpoint phase duration (save/stage/persist/restore)."""
    reg = registry()
    reg.observe(
        "dlrover_tpu_ckpt_phase_seconds", dur_s,
        help="flash-checkpoint phase duration (seconds)",
        phase=phase,
    )
    if not ok:
        reg.counter_inc(
            "dlrover_tpu_ckpt_phase_errors_total",
            help="flash-checkpoint phase failures",
            phase=phase,
        )


def record_chaos_fault(point: str, kind: str) -> None:
    registry().counter_inc(
        "dlrover_tpu_chaos_faults_total",
        help="chaos faults fired by injection point and kind",
        point=point, kind=kind,
    )


def record_sentinel_breach(series: str, detector: str) -> None:
    """One perf-regression sentinel fire (goodput/step-time/phase-share
    EWMA+MAD breach)."""
    registry().counter_inc(
        "dlrover_tpu_sentinel_breaches_total",
        help=_help("dlrover_tpu_sentinel_breaches_total"),
        series=series, detector=detector,
    )
