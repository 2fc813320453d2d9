"""Per-node metric history on the master (JobMetricContext).

Copy of ``dlrover_tpu/master/metric_context.py``, its imports the port's.

The JAX package's counterpart of DLRover's ``dlrover/python/common/metric/context.py:26``
(+ the ``xpu_timer_metric_collector`` feed): every worker report that
passes through the servicer — resource stats, global steps, hang state —
lands in a bounded per-node time series, so diagnosis and the dashboard
can answer "what was node 7 doing for the last N minutes" instead of
only "what is it doing now".  Pure in-memory ring buffers; O(nodes ×
window).
"""

import threading
import time
from collections import deque
from typing import Dict, List, Optional

DEFAULT_WINDOW = 240  # samples per node per series (~1h at 15s reports)

#: how old a heartbeat digest / rank digest file may be and still count
#: as evidence — shared by the agent's rank-file filter
#: (``elastic_agent._collect_digest``), the master's laggard screens
#: below, and the time-series job rollup (``timeseries.FRESH_S``); one
#: constant so the three freshness judgments can never desynchronize.
DIGEST_FRESH_S = 180.0


class NodeMetricSeries:
    """Bounded time series for one node."""

    def __init__(self, window: int = DEFAULT_WINDOW):
        self.resource: deque = deque(maxlen=window)  # (ts, cpu, mem)
        self.steps: deque = deque(maxlen=window)  # (ts, step)
        self.hang: deque = deque(maxlen=window)  # (ts, hung, detail)
        # (ts, [chip dicts per common/metric.TpuChipMetric.to_dict])
        self.device: deque = deque(maxlen=window)
        # (ts, digest dict) — the heartbeat-carried per-rank step-time/
        # ckpt-busy digests (comm.HeartBeat.digest)
        self.digests: deque = deque(maxlen=window)

    def latest(self) -> Dict:
        out: Dict = {}
        if self.resource:
            ts, cpu, mem = self.resource[-1]
            out["resource"] = {
                "ts": ts, "cpu_percent": cpu, "memory_mb": mem,
            }
        if self.steps:
            ts, step = self.steps[-1]
            out["step"] = {"ts": ts, "step": step}
        if self.hang:
            ts, hung, detail = self.hang[-1]
            out["hang"] = {"ts": ts, "hung": hung, "detail": detail}
        if self.device:
            ts, chips = self.device[-1]
            out["device"] = {"ts": ts, "chips": chips}
        return out


class JobMetricContext:
    """All nodes' series + job-level derived views."""

    def __init__(self, window: int = DEFAULT_WINDOW):
        self._window = window
        self._nodes: Dict[int, NodeMetricSeries] = {}
        self._lock = threading.Lock()

    def _series(self, node_id: int) -> NodeMetricSeries:
        series = self._nodes.get(node_id)
        if series is None:
            series = self._nodes.setdefault(
                node_id, NodeMetricSeries(self._window)
            )
        return series

    # -- feeds (called from servicer report paths) -------------------------

    def record_resource(self, node_id: int, cpu_percent: float,
                        memory_mb: int):
        """Host resource sample; per-chip samples go to record_device
        (the taxonomy series) instead of riding along here."""
        with self._lock:
            self._series(node_id).resource.append(
                (time.time(), float(cpu_percent), int(memory_mb))
            )

    def record_step(self, node_id: int, step: int,
                    ts: Optional[float] = None):
        with self._lock:
            self._series(node_id).steps.append(
                (ts or time.time(), int(step))
            )

    def record_hang(self, node_id: int, hung: bool, detail: str = ""):
        with self._lock:
            self._series(node_id).hang.append(
                (time.time(), bool(hung), detail)
            )

    def record_device(self, node_id: int, chips: List[Dict]):
        """Per-chip TPU samples (common/metric.py taxonomy: HBM, duty
        cycle, tensorcore util, ICI counters)."""
        with self._lock:
            self._series(node_id).device.append(
                (time.time(), list(chips or []))
            )

    def record_step_digest(self, node_id: int, digest: Dict[str, float]):
        """A heartbeat-carried digest (``comm.HeartBeat.digest``): the
        ONE step-time data source the laggard-set screen, the step-time
        straggler diagnostician, and the ckpt-stall diagnostician all
        read.  A ``last_step`` key also feeds the step-watermark series
        so the cheap laggard screen shares the feed."""
        now = time.time()
        with self._lock:
            series = self._series(node_id)
            series.digests.append((now, dict(digest)))
            if "last_step" in digest:
                try:
                    series.steps.append((now, int(digest["last_step"])))
                except (TypeError, ValueError):
                    pass

    def evict_node(self, node_id: int):
        """Drop a dead/relaunched node's series so laggard screens and
        job summaries never report ghosts (relaunch assigns a fresh id)."""
        with self._lock:
            self._nodes.pop(node_id, None)

    # -- queries -----------------------------------------------------------

    def node_ids(self) -> List[int]:
        with self._lock:
            return sorted(self._nodes)

    def node_history(self, node_id: int) -> Dict[str, List]:
        with self._lock:
            series = self._nodes.get(node_id)
            if series is None:
                return {"resource": [], "steps": [], "hang": [],
                        "device": [], "digests": []}
            return {
                "resource": list(series.resource),
                "steps": list(series.steps),
                "hang": list(series.hang),
                "device": list(series.device),
                "digests": list(series.digests),
            }

    def latest_by_node(self) -> Dict[int, Dict]:
        with self._lock:
            return {
                node_id: series.latest()
                for node_id, series in self._nodes.items()
            }

    def step_laggards(self, tolerance: int = 0) -> List[int]:
        """Nodes whose latest reported step trails the job max by more
        than ``tolerance`` — the cheap straggler/stall screen the
        reference derives from its per-node step watermarks."""
        with self._lock:
            latest = {
                node_id: series.steps[-1][1]
                for node_id, series in self._nodes.items()
                if series.steps
            }
        if not latest:
            return []
        top = max(latest.values())
        return sorted(
            n for n, s in latest.items() if top - s > tolerance
        )

    def latest_digests(self, max_age_secs: float = DIGEST_FRESH_S) -> Dict[int, Dict]:
        """node -> most recent FRESH heartbeat digest (stale ones are
        not evidence: a wedged agent stops reporting and its last
        healthy digest must not vouch for it)."""
        cutoff = time.time() - max_age_secs
        out: Dict[int, Dict] = {}
        with self._lock:
            for node_id, series in self._nodes.items():
                if series.digests:
                    ts, digest = series.digests[-1]
                    if ts >= cutoff:
                        out[node_id] = dict(digest)
        return out

    def step_time_laggards(self, ratio: Optional[float] = None,
                           samples: int = 3,
                           max_age_secs: float = DIGEST_FRESH_S) -> List[int]:
        """Nodes whose mean p50 step time (over the last ``samples``
        fresh digests) exceeds ``ratio`` x the job median — the
        heartbeat-digest straggler screen.  Needs >= 2 reporting nodes
        (a lone node has no peers to lag)."""
        if ratio is None:
            from dlrover_tpu_torch.common import envs

            ratio = envs.get_float("DLROVER_TPU_STRAGGLER_STEP_RATIO")
        cutoff = time.time() - max_age_secs
        means: Dict[int, float] = {}
        with self._lock:
            for node_id, series in self._nodes.items():
                vals = [
                    float(d["step_p50_s"])
                    for ts, d in list(series.digests)[-samples:]
                    if ts >= cutoff and d.get("step_p50_s", 0) > 0
                ]
                if vals:
                    means[node_id] = sum(vals) / len(vals)
        if len(means) < 2:
            return []
        ordered = sorted(means.values())
        mid = len(ordered) // 2
        # true median (even counts average the middles): with 2 nodes
        # the upper-middle alone would BE the straggler's own mean and
        # the screen could structurally never fire
        if len(ordered) % 2:
            median = ordered[mid]
        else:
            median = (ordered[mid - 1] + ordered[mid]) / 2.0
        if median <= 0:
            return []
        return sorted(n for n, m in means.items() if m > ratio * median)

    def ckpt_busy(self, max_age_secs: float = DIGEST_FRESH_S) -> Dict[int, float]:
        """node -> seconds its checkpoint saver has been busy on one
        persist, from the latest fresh digest (``ckpt_busy_s``)."""
        return {
            node_id: float(digest["ckpt_busy_s"])
            for node_id, digest in self.latest_digests(max_age_secs).items()
            if digest.get("ckpt_busy_s", 0) > 0
        }

    def node_duty_means(self, samples: int = 4,
                        max_age_secs: float = 120.0) -> Dict[int, float]:
        """node -> mean KNOWN chip duty cycle over the last ``samples``
        device reports no older than ``max_age_secs``; nodes with no
        known FRESH duty data are absent.  The age gate matters for the
        hang path: a wedged host stops reporting, and its last pre-stall
        "busy" samples must not defer a restart forever."""
        from dlrover_tpu_torch.common.metric import TpuMetricEnum, UNKNOWN

        cutoff = time.time() - max_age_secs
        out = {}
        with self._lock:
            for node_id, series in self._nodes.items():
                vals = []
                for ts, chips in list(series.device)[-samples:]:
                    if ts < cutoff:
                        continue
                    for chip in chips:
                        v = chip.get(TpuMetricEnum.DUTY_CYCLE, UNKNOWN)
                        if v != UNKNOWN:
                            vals.append(float(v))
                if vals:
                    out[node_id] = sum(vals) / len(vals)
        return out

    def device_idle_nodes(self, idle_pct: float = 5.0,
                          samples: int = 4) -> List[int]:
        """Nodes whose chips report a KNOWN duty cycle under
        ``idle_pct`` across the recent window — device-level evidence
        that a step stall is a real hang (cores idle in a collective)
        rather than a long compile (cores busy).  Nodes without duty
        data never appear (unknown is not evidence)."""
        means = self.node_duty_means(samples)
        return sorted(n for n, m in means.items() if m < idle_pct)

    def duty_cycle_laggards(self, ratio: float = 0.6,
                            samples: int = 4) -> List[int]:
        """Nodes whose mean duty cycle sits below ``ratio`` x the job
        median — the device-level straggler screen (a slow host drags
        every collective; its chips WAIT more, so duty drops)."""
        means = self.node_duty_means(samples)
        if len(means) < 2:
            return []
        ordered = sorted(means.values())
        median = ordered[len(ordered) // 2]
        if median <= 0:
            return []
        return sorted(
            n for n, m in means.items() if m < ratio * median
        )

    def min_chip_hbm_limit_bytes(self,
                                 max_age_secs: float = DIGEST_FRESH_S
                                 ) -> float:
        """The fleet's MEASURED per-chip HBM budget: the minimum KNOWN
        ``hbm_total_mb`` across every chip of every freshly-reporting
        node, in bytes (a heterogeneous or mislabeled fleet is only as
        big as its smallest chip).  0.0 when no node has reported a
        known limit — callers fall back to their static tables."""
        cutoff = time.time() - max_age_secs
        worst = 0.0
        with self._lock:
            for series in self._nodes.values():
                if not series.device:
                    continue
                ts, chips = series.device[-1]
                if ts < cutoff:
                    continue
                for chip in chips:
                    total_mb = float(chip.get("hbm_total_mb", 0.0))
                    if total_mb <= 0:
                        continue  # unknown is not evidence
                    total = total_mb * 2 ** 20
                    worst = total if worst <= 0 else min(worst, total)
        return worst

    def max_hbm_pressure(self) -> Dict[int, float]:
        """node -> worst chip used/total HBM of the latest sample
        (ratio semantics owned by common/metric.NodeTpuMetric)."""
        from dlrover_tpu_torch.common.metric import NodeTpuMetric

        out = {}
        with self._lock:
            for node_id, series in self._nodes.items():
                if not series.device:
                    continue
                _, chips = series.device[-1]
                out[node_id] = NodeTpuMetric.from_list(
                    node_id, chips
                ).max_hbm_pressure()
        return out

    def job_summary(self) -> Dict:
        latest = self.latest_by_node()
        cpus = [
            v["resource"]["cpu_percent"]
            for v in latest.values() if "resource" in v
        ]
        mems = [
            v["resource"]["memory_mb"]
            for v in latest.values() if "resource" in v
        ]
        steps = [v["step"]["step"] for v in latest.values() if "step" in v]
        hung = sorted(
            n for n, v in latest.items()
            if v.get("hang", {}).get("hung")
        )
        return {
            "nodes": len(latest),
            "cpu_percent_avg": (sum(cpus) / len(cpus)) if cpus else 0.0,
            "memory_mb_max": max(mems) if mems else 0,
            "step_min": min(steps) if steps else -1,
            "step_max": max(steps) if steps else -1,
            "hung_nodes": hung,
        }
