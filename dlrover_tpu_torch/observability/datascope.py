"""Datascope: the data-pipeline observatory.

Copy of ``dlrover_tpu/observability/datascope.py``.  Every other hot
path has an observatory (fabric, memory, compile); this one watches the
subsystem DLRover is named for, dynamic data sharding: shard
lease→complete latency, backlog depth, and the wall time a starved
input pipeline would otherwise book into the ledger's ``idle_unknown``
remainder.

Two halves, matching the L1/L2 split:

**Master side** — :class:`ShardTelemetry` is attached to the
``TaskManager`` (``set_telemetry``) and observes the full shard
lifecycle from the dispatcher's seat:

* per-lease latency with a queue-vs-service split: ``service_ms`` is
  the master-side cost of handing out the shard (where a ``data.lease``
  chaos DELAY shows up), ``queue_ms`` the long-poll wait for work to
  exist (the master's view of starvation);
* per-dataset backlog depth (todo + doing) and epoch progress;
* completion latency (lease→report, the worker's processing time as
  the master sees it) and throughput (shards/s).

Samples flush into the master's ``TimeSeriesStore`` at most once per
``DLROVER_TPU_DATA_FLUSH_S`` as ``job.data.*`` columns (plus
per-dataset ``data.<name>.*``), which the ``/data`` dashboard
endpoint, the pull gauges on ``/metrics`` and the two data sentinels
read (the reference's Brain reads the backlog too; the port has no
brain yet).

**Agent side** — a process-local scope fed by ``ShardingClient``'s
``data.fetch``/``data.consume`` spans: wait-vs-process attribution
counters that tests and the CI smoke assert against without scraping
the flight recorder.  The blocking portion of a fetch past
``DLROVER_TPU_DATA_STARVED_MIN_S`` is charged to the ledger's
``input_starved`` phase by the caller — never by span name, so a
prefetch that overlaps compute costs nothing (see
``goodput.SPAN_PHASE``).

Kill switch: ``DLROVER_TPU_DATASCOPE`` (default on) — when off, every
hook is a no-op and the task manager path pays one attribute read.
"""

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.common.log import default_logger as logger

__all__ = [
    "ShardTelemetry",
    "enabled",
    "record_consume",
    "record_fetch",
    "reset_scope",
    "scope_summary",
]


def enabled() -> bool:
    return envs.get_bool("DLROVER_TPU_DATASCOPE")


def _pcts(values: List[float]) -> Dict[str, float]:
    """p50/p99 of a sample list (nearest rank, as the reference's fleet
    bench reads them)."""
    if not values:
        return {"p50": 0.0, "p99": 0.0}
    ordered = sorted(values)
    last = len(ordered) - 1

    def _at(q: float) -> float:
        return ordered[min(last, int(round(q * last)))]

    return {"p50": _at(0.50), "p99": _at(0.99)}


class _DatasetStats:
    """Bounded per-dataset sample windows (master side)."""

    def __init__(self, window: int):
        self.service_ms: Deque[float] = deque(maxlen=window)
        self.queue_ms: Deque[float] = deque(maxlen=window)
        self.complete_ms: Deque[float] = deque(maxlen=window)
        self.leases = 0
        self.completions = 0
        self.backlog = 0
        self.peak_backlog = 0
        self.epoch = 0
        self.queue_wait_s = 0.0


class ShardTelemetry:
    """Master-side shard-lifecycle telemetry.

    Thread-safe; every hook is called by the ``TaskManager`` OUTSIDE
    its dispatch lock (a telemetry flush must never hold up a lease).
    ``store`` is the master's ``TimeSeriesStore`` (or None for a
    standalone collector that only reads ``summary()``).
    """

    def __init__(self, store: Optional[Any] = None):
        self._store = store
        self._mu = threading.Lock()
        window = max(16, envs.get_int("DLROVER_TPU_DATA_WINDOW"))
        self._window = window
        self._datasets: Dict[str, _DatasetStats] = {}
        self._flush_s = max(0.0, envs.get_float("DLROVER_TPU_DATA_FLUSH_S"))
        self._last_flush = time.time()
        self._last_completions = 0
        self._shards_per_s = 0.0

    # -- hooks (TaskManager) ----------------------------------------------

    def on_lease(self, dataset: str, count: int, queue_wait_s: float,
                 service_s: float, backlog: int, epoch: int) -> None:
        """One lease call answered: ``count`` shards handed out after
        ``queue_wait_s`` blocked waiting for work to exist and
        ``service_s`` of dispatch work.  ``backlog`` = todo + doing
        AFTER the lease."""
        with self._mu:
            st = self._dataset_locked(dataset)
            st.leases += 1
            st.epoch = int(epoch)
            st.backlog = int(backlog)
            st.peak_backlog = max(st.peak_backlog, int(backlog))
            st.service_ms.append(max(0.0, service_s) * 1000.0)
            st.queue_ms.append(max(0.0, queue_wait_s) * 1000.0)
            st.queue_wait_s += max(0.0, queue_wait_s)
        self._maybe_flush()

    def on_complete(self, dataset: str, latency_s: float, backlog: int,
                    epoch: int) -> None:
        """One shard reported done ``latency_s`` after its lease."""
        with self._mu:
            st = self._dataset_locked(dataset)
            st.completions += 1
            st.epoch = int(epoch)
            st.backlog = int(backlog)
            st.peak_backlog = max(st.peak_backlog, int(backlog))
            if latency_s >= 0:
                st.complete_ms.append(latency_s * 1000.0)
        self._maybe_flush()

    def on_backlog(self, dataset: str, backlog: int, epoch: int) -> None:
        """Backlog moved without a lease/completion (new epoch split,
        recover_tasks re-queue)."""
        with self._mu:
            st = self._dataset_locked(dataset)
            st.epoch = int(epoch)
            st.backlog = int(backlog)
            st.peak_backlog = max(st.peak_backlog, int(backlog))
        self._maybe_flush()

    def _dataset_locked(self, dataset: str) -> _DatasetStats:
        st = self._datasets.get(dataset)
        if st is None:
            st = self._datasets[dataset] = _DatasetStats(self._window)
        return st

    # -- flush into the time-series store ---------------------------------

    def _maybe_flush(self, force: bool = False) -> None:
        now = time.time()
        with self._mu:
            elapsed = now - self._last_flush
            if not force and elapsed < self._flush_s:
                return
            self._last_flush = now
            completions = sum(
                st.completions for st in self._datasets.values()
            )
            if elapsed > 0:
                self._shards_per_s = max(
                    0.0, (completions - self._last_completions) / elapsed
                )
            self._last_completions = completions
            points = self._points_locked(now)
        store = self._store
        if store is None:
            return
        try:
            for name, value in points.items():
                store.add(name, value, now)
        except Exception:
            # telemetry must never take down the dispatcher
            logger.warning("datascope flush failed", exc_info=True)

    def _points_locked(self, now: float) -> Dict[str, float]:
        service: List[float] = []
        queue: List[float] = []
        backlog = 0
        points: Dict[str, float] = {}
        for name, st in self._datasets.items():
            service.extend(st.service_ms)
            queue.extend(st.queue_ms)
            backlog += st.backlog
            ds = _pcts(list(st.service_ms))
            points[f"data.{name}.backlog"] = float(st.backlog)
            points[f"data.{name}.lease_p99_ms"] = ds["p99"]
            points[f"data.{name}.epoch"] = float(st.epoch)
        agg = _pcts(service)
        qagg = _pcts(queue)
        points["job.data.backlog"] = float(backlog)
        points["job.data.lease_p50_ms"] = agg["p50"]
        points["job.data.lease_p99_ms"] = agg["p99"]
        points["job.data.queue_p99_ms"] = qagg["p99"]
        points["job.data.shards_per_s"] = self._shards_per_s
        return points

    def flush(self) -> None:
        """Force a flush (tests, the smoke, a drill's teardown)."""
        self._maybe_flush(force=True)

    # -- reads ------------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        """The ``/data`` endpoint's view: per-dataset and
        aggregate lease latency, backlog, throughput."""
        with self._mu:
            service: List[float] = []
            queue: List[float] = []
            datasets: Dict[str, Any] = {}
            backlog = 0
            peak = 0
            leases = 0
            completions = 0
            for name, st in self._datasets.items():
                service.extend(st.service_ms)
                queue.extend(st.queue_ms)
                backlog += st.backlog
                peak = max(peak, st.peak_backlog)
                leases += st.leases
                completions += st.completions
                ds_service = _pcts(list(st.service_ms))
                ds_complete = _pcts(list(st.complete_ms))
                datasets[name] = {
                    "epoch": st.epoch,
                    "backlog": st.backlog,
                    "peak_backlog": st.peak_backlog,
                    "leases": st.leases,
                    "completions": st.completions,
                    "lease_p50_ms": round(ds_service["p50"], 3),
                    "lease_p99_ms": round(ds_service["p99"], 3),
                    "complete_p99_ms": round(ds_complete["p99"], 3),
                    "queue_wait_s": round(st.queue_wait_s, 3),
                }
            agg = _pcts(service)
            qagg = _pcts(queue)
            return {
                "backlog": backlog,
                "peak_backlog": peak,
                "leases": leases,
                "completions": completions,
                "shards_per_s": round(self._shards_per_s, 3),
                "lease_p50_ms": round(agg["p50"], 3),
                "lease_p99_ms": round(agg["p99"], 3),
                "queue_p50_ms": round(qagg["p50"], 3),
                "queue_p99_ms": round(qagg["p99"], 3),
                "datasets": datasets,
            }

    def gauges(self) -> Dict[str, float]:
        """The pull-gauge view (``/metrics``)."""
        summary = self.summary()
        return {
            "backlog": float(summary["backlog"]),
            "shards_per_s": float(summary["shards_per_s"]),
            "lease_p99_ms": float(summary["lease_p99_ms"]),
        }


# ---------------------------------------------------------------------------
# Agent-side scope: wait-vs-process counters fed by ShardingClient's
# data.fetch / data.consume spans.  Process-local; tests and the CI
# smoke read it instead of scraping the flight recorder.
# ---------------------------------------------------------------------------

_scope_mu = threading.Lock()
_scope: Dict[str, float] = {}


def _bump(key: str, value: float) -> None:
    with _scope_mu:
        _scope[key] = _scope.get(key, 0.0) + value


def record_fetch(dataset: str, wait_s: float, service_s: float,
                 starved: bool) -> None:
    """One ``fetch_shard`` return: ``wait_s`` blocked on an empty
    pipeline (client sleeps + long-poll waits), ``service_s`` paying
    the RPC itself.  ``starved`` marks the fetch whose blocked wall
    crossed the charge threshold (booked to ``input_starved``)."""
    if not enabled():
        return
    _bump("fetches", 1.0)
    _bump("wait_s", max(0.0, wait_s))
    _bump("service_s", max(0.0, service_s))
    if starved:
        _bump("starved_fetches", 1.0)
        _bump("starved_s", max(0.0, wait_s))


def record_consume(dataset: str, process_s: float) -> None:
    """One shard fully consumed ``process_s`` after its fetch returned
    (the worker-side processing time the ``data.consume`` span
    carries)."""
    if not enabled():
        return
    _bump("consumes", 1.0)
    _bump("process_s", max(0.0, process_s))


def scope_summary() -> Dict[str, float]:
    with _scope_mu:
        return dict(_scope)


def reset_scope() -> None:
    with _scope_mu:
        _scope.clear()
