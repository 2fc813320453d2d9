"""Perf-regression sentinels: EWMA+MAD detectors over the perf timeline.

Copy of ``dlrover_tpu/observability/sentinel.py``.  Two deployment
points, one detector:

* **Master-side** — diagnosticians watch the series the master's
  time-series store (``master/timeseries.py``) accumulates from heartbeat
  digests and recovery reports, and fire through the ``DiagnosisManager``
  loop, which opens a classified incident through the incident engine
  (the flight dumps and the chaos attribution then say *why* the curve
  moved).  :func:`register_sentinels` attaches the ten the local master
  runs: goodput, step time, exposed comm, checkpoint share, slow link,
  memory, compile, MTTR, data starvation and shard latency.
* **Bench-side** — :func:`compare_round` replays a recorded trajectory
  (a list of round entries) through the same detector and judges the
  current round.  The port has no benchmark yet, so nothing calls it.

The detector is EWMA+MAD: an exponentially-weighted baseline plus an
exponentially-weighted mean absolute deviation (the streaming MAD
analogue).  A sample breaches when it sits more than
``DLROVER_TPU_SENTINEL_MAD_K`` deviations on the BAD side of baseline
(direction-gated — goodput regresses DOWN, step time regresses UP);
``DLROVER_TPU_SENTINEL_CONSECUTIVE`` breaches in a row fire.  Breaching
samples do not feed the baseline (the regression must stay visible),
and a fire re-baselines so one regime change is one alert.

What differs from the copy: :class:`SlowLinkDiagnostician` keeps its
``demotion_hook`` parameter and the detail strings a hook's answer adds,
but :func:`register_sentinels` registers no hook and no brain action
sink.  The reference's ``parallel.hierarchy.DcnDemotionHook`` demotes a
cross-slice (DCN) leg, and the port's mesh has no DCN axis: the
hierarchy is ROADMAP item 6d and the brain comes after item 11.
"""

import time
from typing import Any, Dict, List, Optional, Sequence

from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.diagnosis.diagnosis_action import (
    DiagnosisAction,
    EventAction,
)
from dlrover_tpu_torch.diagnosis.diagnostician import Diagnostician, Observation


class EwmaMadDetector:
    """Streaming EWMA baseline + EWMA absolute deviation; fires on
    ``consecutive`` samples beyond ``k`` deviations in the bad
    direction.  ``direction``: ``"up"`` = higher is worse (step time,
    phase share), ``"down"`` = lower is worse (goodput)."""

    def __init__(self, direction: str = "up",
                 alpha: Optional[float] = None,
                 k: Optional[float] = None,
                 min_samples: Optional[int] = None,
                 consecutive: Optional[int] = None,
                 rel_floor: float = 0.05,
                 abs_floor: float = 0.0):
        if direction not in ("up", "down"):
            raise ValueError(f"direction {direction!r}")
        self.direction = direction
        self.alpha = float(
            alpha if alpha is not None
            else envs.get_float("DLROVER_TPU_SENTINEL_ALPHA")
        )
        self.k = float(
            k if k is not None
            else envs.get_float("DLROVER_TPU_SENTINEL_MAD_K")
        )
        self.min_samples = int(
            min_samples if min_samples is not None
            else envs.get_int("DLROVER_TPU_SENTINEL_MIN_SAMPLES")
        )
        self.consecutive = max(
            1,
            int(consecutive if consecutive is not None
                else envs.get_int("DLROVER_TPU_SENTINEL_CONSECUTIVE")),
        )
        # the deviation floors: with a near-constant baseline the MAD
        # collapses toward 0 and ANY jitter would read as k deviations;
        # a breach must also clear rel_floor x |baseline|.  rel_floor
        # alone dies at baseline ZERO (a share series that sat at 0.0
        # through warm-up makes every nonzero sample a breach), so
        # abs_floor is the absolute delta a breach must additionally
        # clear — set it to the smallest move worth alerting on.
        self.rel_floor = float(rel_floor)
        self.abs_floor = float(abs_floor)
        self.baseline: Optional[float] = None
        self.mad = 0.0
        self.samples = 0
        self._streak = 0
        self._good_streak = 0

    def _rebaseline(self, value: float, warm: bool = True) -> None:
        """Adopt ``value`` as the new regime.  A re-baseline from an
        established history keeps the detector warm (a regression right
        after an improvement spike must still fire); only the very
        first sample starts cold."""
        self.baseline = value
        self.mad = 0.0
        self.samples = self.min_samples if warm else 1
        self._streak = 0
        self._good_streak = 0

    def update(self, value: float) -> Optional[Dict[str, Any]]:
        """Feed one sample; returns a breach dict when the detector
        fires (``consecutive`` bad samples past the warm-up), else
        None.

        Out-of-band samples in EITHER direction are outliers and never
        feed the EWMA estimators — a one-sample improvement spike must
        not inflate the deviation estimate and mask the regression
        right behind it.  ``consecutive`` out-of-band GOOD samples are
        a regime change (the job genuinely got faster): re-baseline
        quietly; the same count of BAD samples fires, then re-baselines
        so one regression is one alert."""
        value = float(value)
        if self.baseline is None:
            self._rebaseline(value, warm=False)
            return None
        warm = self.samples >= self.min_samples
        delta = value - self.baseline
        bad = delta if self.direction == "up" else -delta
        floor = max(
            self.mad * self.k,
            self.rel_floor * abs(self.baseline),
            self.abs_floor,
        )
        if warm and abs(delta) > floor:
            if bad > 0:
                self._streak += 1
                self._good_streak = 0
                if self._streak >= self.consecutive:
                    fired = {
                        "value": round(value, 6),
                        "baseline": round(self.baseline, 6),
                        "mad": round(self.mad, 6),
                        "direction": self.direction,
                        "streak": self._streak,
                    }
                    self._rebaseline(value)
                    return fired
            else:
                self._good_streak += 1
                self._streak = 0
                if self._good_streak >= self.consecutive:
                    self._rebaseline(value)
            return None
        self._streak = 0
        self._good_streak = 0
        self.mad += self.alpha * (abs(delta) - self.mad)
        self.baseline += self.alpha * delta
        self.samples += 1
        return None


class SeriesRegressionDiagnostician(Diagnostician):
    """Base: watch ONE job series in a ``TimeSeriesStore`` and fire on
    an EWMA+MAD breach.  Subclasses pin the series, direction, incident
    kind and phase hint.  Only COMPLETED buckets feed the detector (the
    live bucket is still aggregating), each exactly once."""

    series = ""
    direction = "up"
    phase_hint = ""
    res_s = 10.0
    #: absolute move a breach must clear: a share series that sat at
    #: 0.0 through warm-up (no checkpoint yet) has baseline AND mad 0,
    #: where relative floors are 0 too — without this, the first
    #: routine checkpoint would open a regression incident
    abs_floor = 0.0

    def __init__(self, timeseries, res_s: Optional[float] = None):
        self._store = timeseries
        if res_s is not None:
            self.res_s = res_s
        self._detector = EwmaMadDetector(
            direction=self.direction, abs_floor=self.abs_floor
        )
        self._last_bucket_ts: float = -1.0

    def observe(self, **kwargs) -> Observation:
        points = self._store.series(self.series, res=self.res_s)
        if len(points) < 2:
            return Observation.nothing()
        fired: Optional[Dict[str, Any]] = None
        fired_ts = 0.0
        for point in points[:-1]:  # the last bucket is still live
            if point["ts"] <= self._last_bucket_ts:
                continue
            self._last_bucket_ts = point["ts"]
            breach = self._detector.update(point["mean"])
            if breach is not None:
                fired, fired_ts = breach, point["ts"]
        if fired is None:
            return Observation.nothing()
        arrow = "fell" if self.direction == "down" else "rose"
        detail = (
            f"{self.series} {arrow} to {fired['value']} "
            f"(baseline {fired['baseline']}, mad {fired['mad']}, "
            f"{fired['streak']} consecutive buckets at "
            f"{self.res_s:.0f}s resolution)"
        )
        from dlrover_tpu_torch.observability import metrics as obs_metrics

        obs_metrics.record_sentinel_breach(self.series, self.name)
        return Observation(
            True, detail,
            extra={"phase": self.phase_hint, "breach": fired,
                   "bucket_ts": fired_ts},
        )

    def resolve(self, observation: Observation, **kwargs) -> DiagnosisAction:
        # the incident (opened by the manager from incident_kind)
        # carries the evidence; the sentinel never restarts anything
        return EventAction(observation.detail, severity="warn")


class GoodputRegressionDiagnostician(SeriesRegressionDiagnostician):
    """The headline detector: the fresh-node mean of the ledger-derived
    goodput (``job.goodput``) dropping below its EWMA baseline.  No
    phase hint — the incident classifier derives the wounded subsystem
    from the flight dumps / chaos evidence, which is the point: the
    sentinel says *that* goodput regressed, the evidence says *why*."""

    name = "goodput_regression"
    incident_kind = "goodput_regression"
    series = "job.goodput"
    direction = "down"


class StepTimeRegressionDiagnostician(SeriesRegressionDiagnostician):
    """Job p50 step time (slowest fresh host) drifting UP — the
    regression every synchronous step pays."""

    name = "step_time_regression"
    incident_kind = "step_time_regression"
    series = "job.step_p50_s"
    direction = "up"


class ExposedCommDiagnostician(SeriesRegressionDiagnostician):
    """The ``exposed_comm`` ledger share rising: gradient sync stopped
    hiding behind backward compute (an overlap regression, a congested
    interconnect): the overlapped grad sync's win decaying in production."""

    name = "exposed_comm_regression"
    incident_kind = "exposed_comm_regression"
    series = "job.share.exposed_comm"
    direction = "up"
    phase_hint = "collective"
    abs_floor = 0.10  # share points: a tenth of the wall clock


class CkptShareDiagnostician(SeriesRegressionDiagnostician):
    """The ``ckpt_stall`` ledger share rising: checkpoints stopped
    being (nearly) free — slow storage, a persist regression."""

    name = "ckpt_share_regression"
    incident_kind = "ckpt_share_regression"
    series = "job.share.ckpt_stall"
    direction = "up"
    phase_hint = "ckpt"
    abs_floor = 0.10


class DataStarvationDiagnostician(SeriesRegressionDiagnostician):
    """The ``input_starved`` ledger share rising: workers are blocking
    on an empty prefetch — a stalled shard dispatch, a slow storage
    backend behind the loader, or a master wedged under lease load.
    The floor (``DLROVER_TPU_DATA_STARVED_SHARE``) keeps idle jobs
    from reading as starved: below a tenth of the wall clock the
    pipeline is keeping up."""

    name = "data_starvation"
    incident_kind = "data_starvation"
    series = "job.share.input_starved"
    direction = "up"
    phase_hint = "data"

    def __init__(self, timeseries, res_s: Optional[float] = None):
        self.abs_floor = envs.get_float("DLROVER_TPU_DATA_STARVED_SHARE")
        super().__init__(timeseries, res_s=res_s)


class ShardLatencyRegressionDiagnostician(SeriesRegressionDiagnostician):
    """Master-side shard-lease p99 service latency drifting UP
    (``job.data.lease_p99_ms`` from the datascope telemetry): dispatch
    itself got slower — lock contention under agent storms, a fault in
    the lease path — before workers necessarily starve.  The absolute
    floor (``DLROVER_TPU_DATA_P99_MIN_MS``) mutes micro-regressions on
    a sub-millisecond baseline."""

    name = "shard_latency_regression"
    incident_kind = "shard_latency_regression"
    series = "job.data.lease_p99_ms"
    direction = "up"
    phase_hint = "data"

    def __init__(self, timeseries, res_s: Optional[float] = None):
        self.abs_floor = envs.get_float("DLROVER_TPU_DATA_P99_MIN_MS")
        super().__init__(timeseries, res_s=res_s)


class SlowLinkDiagnostician(Diagnostician):
    """Which LINK is slow: EWMA+MAD detectors over the probe-measured
    per-axis fabric series (``job.comm.<axis>.lat_us`` rising /
    ``job.comm.<axis>.gbps`` falling — the comm observatory's
    ``FabricModel`` digests rolled up worst-case across nodes).  The
    series set is dynamic (axes appear as probes report), so this
    diagnostician keeps one detector per series instead of pinning a
    name like :class:`SeriesRegressionDiagnostician`.

    On a breach the incident is classified ``phase=comm`` and the
    observation names the degraded AXIS and the culprit rank — the
    node whose latest per-node sample is worst on that axis (max
    latency / min bandwidth).

    On a breach naming an axis that crosses the DCN boundary, an
    optional ``demotion_hook`` (``parallel.hierarchy.DcnDemotionHook``)
    is invoked with ``(axis, metric, breach)`` so the hierarchical
    grad-sync policy can demote its cross-slice leg to a heavier
    quantization tier — the link got slower, so ship fewer bytes."""

    name = "slow_link"
    incident_kind = "slow_link"

    def __init__(self, timeseries, res_s: float = 10.0,
                 demotion_hook=None):
        self._store = timeseries
        self._res = float(res_s)
        self._demotion_hook = demotion_hook
        # series name -> EwmaMadDetector
        self._detectors: Dict[str, EwmaMadDetector] = {}
        self._last_bucket_ts: Dict[str, float] = {}
        # breaches not yet reported: one observe() reports ONE breach
        # (the most severe), but a detector that fired already
        # re-baselined onto the degraded value — losing breaches must
        # queue for later rounds or that axis's regression is
        # permanently swallowed
        self._pending: List[Any] = []

    def _detector_for(self, series: str) -> Optional[EwmaMadDetector]:
        detector = self._detectors.get(series)
        if detector is not None:
            return detector
        if series.endswith(".lat_us"):
            detector = EwmaMadDetector(
                direction="up",
                abs_floor=envs.get_float(
                    "DLROVER_TPU_COMM_SLOWLINK_MIN_LAT_US"
                ),
            )
        elif series.endswith(".gbps"):
            detector = EwmaMadDetector(direction="down")
        else:
            return None
        self._detectors[series] = detector
        return detector

    def _culprit(self, axis: str, metric: str) -> int:
        """The node whose latest FRESH fabric sample is worst on
        ``axis`` (-1 when none).  Reads the store's per-node latest
        view (``comm_nodes``) rather than the raw series rings: rings
        outlive evicted nodes, and a long-gone node's final sample
        must not be named culprit."""
        import time as _time

        from dlrover_tpu_torch.master.metric_context import DIGEST_FRESH_S

        nodes = {}
        comm_nodes = getattr(self._store, "comm_nodes", None)
        if callable(comm_nodes):
            nodes = comm_nodes()
        cutoff = _time.time() - DIGEST_FRESH_S
        key = "lat_us" if metric == "lat_us" else "gbps"
        worst_node, worst = -1, None
        for node_id, entry in nodes.items():
            if float(entry.get("ts", 0.0)) < cutoff:
                continue
            value = (entry.get("axes") or {}).get(axis, {}).get(key)
            if value is None:
                continue
            if worst is None or (
                value > worst if key == "lat_us" else value < worst
            ):
                worst_node, worst = int(node_id), float(value)
        return worst_node

    @staticmethod
    def _severity(breach: Dict[str, Any]) -> float:
        """Relative badness of a breach: how many baselines the value
        moved.  Lets one diagnosis round pick the degraded axis over a
        coincidental jitter breach on a healthy series."""
        baseline = abs(float(breach.get("baseline", 0.0)))
        move = abs(float(breach.get("value", 0.0)) - float(
            breach.get("baseline", 0.0)
        ))
        return move / max(baseline, 1e-9)

    def observe(self, **kwargs) -> Observation:
        for series in self._store.names():
            if not series.startswith("job.comm."):
                continue
            detector = self._detector_for(series)
            if detector is None:
                continue
            points = self._store.series(series, res=self._res)
            if len(points) < 2:
                continue
            last_ts = self._last_bucket_ts.get(series, -1.0)
            for point in points[:-1]:  # the last bucket is still live
                if point["ts"] <= last_ts:
                    continue
                last_ts = point["ts"]
                breach = detector.update(point["mean"])
                if breach is not None:
                    self._pending.append(
                        (series, breach, point["ts"])
                    )
            self._last_bucket_ts[series] = last_ts
        if not self._pending:
            return Observation.nothing()
        # report the most severe breach now; the rest stay queued for
        # later rounds (their detectors already re-baselined, so
        # dropping them here would swallow those axes' regressions
        # forever).  Bounded: a breach storm keeps the 16 worst.
        self._pending.sort(key=lambda item: self._severity(item[1]))
        del self._pending[:-16]
        fired_series, fired, fired_ts = self._pending.pop()
        # job.comm.<axis>.<metric>
        parts = fired_series.split(".")
        axis = parts[2] if len(parts) >= 4 else "?"
        metric = parts[3] if len(parts) >= 4 else "lat_us"
        culprit = self._culprit(axis, metric)
        demoted = None
        if self._demotion_hook is not None:
            # the hook decides relevance (DCN axis, demotion enabled,
            # a tier left to demote to) and never raises
            demoted = self._demotion_hook(axis, metric, fired)
        arrow = "fell" if fired["direction"] == "down" else "rose"
        unit = "µs" if metric == "lat_us" else "GB/s"
        detail = (
            f"slow link on mesh axis {axis!r}: {fired_series} {arrow} "
            f"to {fired['value']}{unit} (baseline {fired['baseline']}, "
            f"mad {fired['mad']}, worst node {culprit})"
        )
        if demoted == "action_channel":
            detail += (
                "; DCN demotion queued on the master->agent action "
                "channel"
            )
        elif demoted == "rerouted":
            detail += (
                "; fabric tuner re-routed the comm plan around the "
                "degraded DCN leg (no demotion)"
            )
        elif demoted is not None:
            detail += f"; DCN grad-sync leg demoted to {demoted}"
        from dlrover_tpu_torch.observability import metrics as obs_metrics

        obs_metrics.record_sentinel_breach(fired_series, self.name)
        return Observation(
            True, detail,
            extra={"phase": "comm", "culprit": culprit, "axis": axis,
                   "series": fired_series, "breach": fired,
                   "bucket_ts": fired_ts, "dcn_demoted_to": demoted},
        )

    def resolve(self, observation: Observation, **kwargs) -> DiagnosisAction:
        return EventAction(observation.detail, severity="warn")


class MemPressureSentinel(Diagnostician):
    """OOM forecast BEFORE the crash: watches the per-node memory
    digests the store's ``mem_nodes()`` view accumulates
    (``observability/memscope.py`` accounts riding the heartbeat
    channel) and fires on two conditions:

    * ``hbm_leak`` — the EWMA slope of a node's in-use bytes is
      positive past ``DLROVER_TPU_MEM_LEAK_SLOPE_B_S`` for
      ``DLROVER_TPU_SENTINEL_CONSECUTIVE`` fresh samples in a row,
      AND (when the chip limit is known) the slope projects the chip
      hitting its limit within ``DLROVER_TPU_MEM_FORECAST_S`` — the
      forecast incident, opened while there is still evidence to dump;
    * ``mem_pressure`` — a node's headroom fraction sits below the
      absolute ``DLROVER_TPU_MEM_HEADROOM_FLOOR`` regardless of slope
      (already squeezed: the next big allocation is the OOM).

    ``incident_kind`` is set per observation (the manager reads it
    after ``diagnose()``), so one diagnostician opens both kinds;
    pressure outranks leak when both hold (it is the more imminent
    verdict).  Incidents classify ``phase=mem`` naming the culprit
    node; the per-kind incident cooldown dedups a persisting
    condition."""

    name = "mem_pressure"
    incident_kind = "mem_pressure"

    def __init__(self, timeseries, res_s: float = 10.0):
        self._store = timeseries
        self._res = float(res_s)
        # node_id -> {ts, used_b, slope_b_s, streak}
        self._track: Dict[int, Dict[str, float]] = {}
        # node_id -> sample ts of the last REPORTED pressure breach: a
        # persisting below-floor node re-reports only on a NEW sample,
        # so it cannot monopolize every round and starve a concurrent
        # leak forecast on another node
        self._pressure_ts: Dict[int, float] = {}

    def observe(self, **kwargs) -> Observation:
        import time as _time

        from dlrover_tpu_torch.master.metric_context import DIGEST_FRESH_S

        mem_nodes = getattr(self._store, "mem_nodes", None)
        nodes = mem_nodes() if callable(mem_nodes) else {}
        alpha = envs.get_float("DLROVER_TPU_MEM_EWMA_ALPHA")
        if not (0.0 < alpha <= 1.0):
            alpha = 0.5
        floor = envs.get_float("DLROVER_TPU_MEM_HEADROOM_FLOOR")
        min_slope = envs.get_float("DLROVER_TPU_MEM_LEAK_SLOPE_B_S")
        forecast_s = envs.get_float("DLROVER_TPU_MEM_FORECAST_S")
        consecutive = max(
            1, envs.get_int("DLROVER_TPU_SENTINEL_CONSECUTIVE")
        )
        cutoff = _time.time() - DIGEST_FRESH_S
        pressure: Optional[Observation] = None
        leak: Optional[Observation] = None
        for node_id in list(self._track):
            if node_id not in nodes:
                del self._track[node_id]  # evicted/scaled-out node
                self._pressure_ts.pop(node_id, None)
        for node_id, entry in sorted(nodes.items()):
            ts = float(entry.get("ts", 0.0))
            if ts < cutoff:
                continue
            used = float(entry.get("used_b", 0.0))
            limit = float(entry.get("limit_b", 0.0) or 0.0)
            headroom_frac = entry.get("headroom_frac")
            if (
                pressure is None
                and headroom_frac is not None
                and float(headroom_frac) < floor
                and ts > self._pressure_ts.get(node_id, -1.0)
            ):
                detail = (
                    f"memory pressure on node {node_id}: headroom "
                    f"{float(headroom_frac):.1%} below the "
                    f"{floor:.0%} floor ({used / 2**30:.2f}/"
                    f"{limit / 2**30:.2f}GiB in use)"
                )
                pressure = Observation(
                    True, detail,
                    extra={"phase": "mem", "culprit": int(node_id),
                           "kind": "mem_pressure", "sample_ts": ts,
                           "headroom_frac": float(headroom_frac)},
                )
            track = self._track.get(node_id)
            if track is None or ts <= track["ts"]:
                if track is None:
                    self._track[node_id] = {
                        "ts": ts, "used_b": used,
                        "slope_b_s": 0.0, "streak": 0,
                    }
                continue
            gap = ts - track["ts"]
            raw_slope = (used - track["used_b"]) / gap
            slope = track["slope_b_s"] + alpha * (
                raw_slope - track["slope_b_s"]
            )
            streak = (
                track["streak"] + 1 if slope >= min_slope else 0
            )
            self._track[node_id] = {
                "ts": ts, "used_b": used,
                "slope_b_s": slope, "streak": streak,
            }
            if leak is None and streak >= consecutive:
                tto = (
                    (limit - used) / slope
                    if limit > used and slope > 0 else None
                )
                if tto is not None and tto > forecast_s:
                    continue  # leaking, but the cliff is far off
                detail = (
                    f"hbm leak on node {node_id}: in-use bytes rising "
                    f"{slope / 2**20:.1f}MiB/s for {streak} consecutive "
                    "samples"
                ) + (
                    f"; at this slope the chip limit "
                    f"({limit / 2**30:.2f}GiB) is ~{tto:.0f}s away"
                    if tto is not None else "; chip limit unknown"
                )
                leak = Observation(
                    True, detail,
                    extra={"phase": "mem", "culprit": int(node_id),
                           "kind": "hbm_leak",
                           "slope_b_s": round(slope, 1),
                           "forecast_s": (
                               round(tto, 1) if tto is not None
                               else None
                           )},
                )
        fired = pressure or leak
        if fired is None:
            return Observation.nothing()
        if fired is leak:
            # one fire per regime: the streak re-arms only after the
            # slope condition re-establishes.  Reset ONLY when the leak
            # observation is actually REPORTED — a leak outranked by a
            # concurrent pressure observation keeps its streak, so the
            # forecast fires on the next round instead of being starved
            # for as long as any node sits below the headroom floor
            self._track[fired.extra["culprit"]]["streak"] = 0
        else:
            self._pressure_ts[fired.extra["culprit"]] = float(
                fired.extra["sample_ts"]
            )
        # the manager reads incident_kind AFTER diagnose(): set it to
        # the observation's verdict so one diagnostician opens both
        self.incident_kind = fired.extra["kind"]
        from dlrover_tpu_torch.observability import metrics as obs_metrics

        obs_metrics.record_sentinel_breach(
            f"node{fired.extra['culprit']}.mem", self.name
        )
        return fired

    def resolve(self, observation: Observation, **kwargs) -> DiagnosisAction:
        # the incident carries the evidence (flight dumps + the mem
        # counter tracks); the sentinel itself never restarts anything
        return EventAction(observation.detail, severity="warn")


class CompileSentinel(Diagnostician):
    """Recompile storms and cold caches, caught while they burn:
    watches the compile observatory's rollups
    (``observability/jitscope.py`` digests riding the heartbeat
    channel) and fires on two conditions:

    * ``recompile_storm`` — ``job.compile.s`` (compile seconds per
      rollup window, worst fresh node) breaches its EWMA+MAD baseline
      AND clears the absolute ``DLROVER_TPU_COMPILE_STORM_MIN_S``
      floor — shape drift or a thrashing cache eating the job's wall
      clock in recompiles;
    * ``cache_cold`` — a node that EXPECTED a warm persistent cache
      (restart_count > 0 or a non-empty cache dir at boot) reports
      misses with a hit ratio below ``DLROVER_TPU_CACHE_COLD_RATIO``
      — the restart paid a full compile the cache should have
      absorbed (wiped dir, changed cache key, broken mount).

    ``incident_kind`` is set per observation (the manager reads it
    after ``diagnose()``); cache-cold outranks the storm when both
    hold — it names the CAUSE, the storm is the symptom.  Incidents
    classify ``phase=compile`` naming the culprit node; finalize
    embeds the culprit's recent ``jitscope.compile`` spans from the
    flight dumps, so the verdict names the function and trigger."""

    name = "compile_observatory"
    incident_kind = "recompile_storm"

    def __init__(self, timeseries, res_s: float = 10.0):
        self._store = timeseries
        self._res = float(res_s)
        self._detector = EwmaMadDetector(
            direction="up",
            abs_floor=envs.get_float("DLROVER_TPU_COMPILE_STORM_MIN_S"),
        )
        self._last_bucket_ts = -1.0
        # node_id -> sample ts of the last REPORTED cold-cache breach:
        # a persistently cold node re-reports only on a NEW sample
        self._cold_ts: Dict[int, float] = {}

    def _cache_cold(self) -> Optional[Observation]:
        import time as _time

        from dlrover_tpu_torch.master.metric_context import DIGEST_FRESH_S

        compile_nodes = getattr(self._store, "compile_nodes", None)
        nodes = compile_nodes() if callable(compile_nodes) else {}
        floor = envs.get_float("DLROVER_TPU_CACHE_COLD_RATIO")
        cutoff = _time.time() - DIGEST_FRESH_S
        for node_id, entry in sorted(nodes.items()):
            ts = float(entry.get("ts", 0.0))
            if ts < cutoff or ts <= self._cold_ts.get(node_id, -1.0):
                continue
            if not (
                entry.get("warm_expected")
                and entry.get("cache_enabled")
            ):
                continue
            # the WINDOWED ratio when a differentiated window exists
            # (a restarted node's window IS its boot account): a long
            # healthy run's cumulative ratio must not dilute a freshly
            # cold cache (wiped dir / broken mount mid-run).  First
            # sight has no window yet — the cumulative IS the boot.
            window = entry.get("window") or {}
            ratio = entry.get("window_hit_ratio")
            misses = window.get("misses", 0.0)
            if ratio is None:
                ratio = entry.get("hit_ratio")
                misses = entry.get("misses", 0.0)
            if misses > 0 and ratio is not None and ratio < floor:
                detail = (
                    f"cold compile cache on node {node_id}: warm "
                    f"cache expected hits but got "
                    f"{int(misses)} recent miss(es) at hit ratio "
                    f"{ratio:.2f} (< {floor:.2f} floor), "
                    f"{entry.get('compile_s', 0.0):.2f}s recompiling"
                )
                return Observation(
                    True, detail,
                    extra={"phase": "compile", "culprit": int(node_id),
                           "kind": "cache_cold", "sample_ts": ts,
                           "hit_ratio": round(float(ratio), 6),
                           "compile_s": entry.get("compile_s", 0.0)},
                )
        return None

    def _storm(self) -> Optional[Observation]:
        points = self._store.series("job.compile.s", res=self._res)
        if len(points) < 2:
            return None
        fired: Optional[Dict[str, Any]] = None
        fired_ts = 0.0
        for point in points[:-1]:  # the last bucket is still live
            if point["ts"] <= self._last_bucket_ts:
                continue
            self._last_bucket_ts = point["ts"]
            breach = self._detector.update(point["mean"])
            if breach is not None:
                fired, fired_ts = breach, point["ts"]
        if fired is None:
            return None
        culprit, worst = -1, -1.0
        compile_nodes = getattr(self._store, "compile_nodes", None)
        for node_id, entry in (
            compile_nodes() if callable(compile_nodes) else {}
        ).items():
            window = entry.get("window") or {}
            if window.get("compile_s", 0.0) > worst:
                culprit = int(node_id)
                worst = float(window.get("compile_s", 0.0))
        detail = (
            f"recompile storm: job.compile.s rose to "
            f"{fired['value']}s/window (baseline {fired['baseline']}, "
            f"mad {fired['mad']}, worst node {culprit})"
        )
        return Observation(
            True, detail,
            extra={"phase": "compile", "culprit": culprit,
                   "kind": "recompile_storm", "breach": fired,
                   "bucket_ts": fired_ts},
        )

    def observe(self, **kwargs) -> Observation:
        cold = self._cache_cold()
        storm = self._storm()  # always drain the buckets: a storm
        # coinciding with a cold cache must not re-fire later from
        # stale points
        fired = cold or storm
        if fired is None:
            return Observation.nothing()
        if fired is cold:
            self._cold_ts[fired.extra["culprit"]] = float(
                fired.extra["sample_ts"]
            )
        # the manager reads incident_kind AFTER diagnose(): set it to
        # the observation's verdict so one diagnostician opens both
        self.incident_kind = fired.extra["kind"]
        from dlrover_tpu_torch.observability import metrics as obs_metrics

        obs_metrics.record_sentinel_breach(
            "job.compile.s" if fired is storm
            else f"node{fired.extra['culprit']}.compile",
            self.name,
        )
        return fired

    def resolve(self, observation: Observation, **kwargs) -> DiagnosisAction:
        # the incident carries the evidence (flight dumps hold the
        # classified compile events); the sentinel restarts nothing
        return EventAction(observation.detail, severity="warn")


class MttrSentinel(Diagnostician):
    """A recovery that blows its MTTR budget, named while the wound is
    fresh: watches the recovery reports the peer-restore ladder files
    with the master (``TimeSeriesStore.recoveries()``, fed by the
    ``RecoveryReport`` wire message) and fires when a finished
    recovery's wall-clock MTTR exceeds its budget.

    The budget is the report's own ``budget_s`` when the recovering
    host priced one (it read ``DLROVER_TPU_MTTR_BUDGET_S`` at recovery
    time), else the master's view of the same knob.  A budget of 0
    disables the sentinel — drills that only exercise the ladder must
    not open incidents.  Incidents classify ``phase=recovery`` with
    kind ``mttr_budget`` naming the culprit process and the ladder
    rung that ate the clock, so the verdict distinguishes a slow peer
    fetch from a full storage fallback."""

    name = "mttr_budget"
    incident_kind = "mttr_budget"

    def __init__(self, timeseries):
        self._store = timeseries
        # ts of the newest recovery already judged: each report is
        # judged exactly once, a standing breach must not re-fire
        self._last_ts = -1.0

    def observe(self, **kwargs) -> Observation:
        recoveries = getattr(self._store, "recoveries", None)
        reports = recoveries() if callable(recoveries) else []
        default_budget = envs.get_float("DLROVER_TPU_MTTR_BUDGET_S")
        fired: Optional[Observation] = None
        for report in reports:  # oldest first: fire on the newest
            ts = float(report.get("ts", 0.0))
            if ts <= self._last_ts:
                continue
            self._last_ts = ts
            budget = float(report.get("budget_s", 0.0) or 0.0)
            if budget <= 0.0:
                budget = default_budget
            mttr = float(report.get("mttr_s", 0.0) or 0.0)
            if budget <= 0.0 or mttr <= budget:
                continue
            rung = report.get("rung", "") or "unknown"
            culprit = int(report.get("process_id", -1))
            detail = (
                f"recovery blew its MTTR budget: process {culprit} "
                f"took {mttr:.2f}s (> {budget:.2f}s budget) restoring "
                f"step {report.get('step', -1)} via the "
                f"'{rung}' rung"
            )
            fired = Observation(
                True, detail,
                extra={"phase": "recovery", "culprit": culprit,
                       "kind": "mttr_budget", "rung": rung,
                       "mttr_s": round(mttr, 6),
                       "budget_s": round(budget, 6),
                       "step": int(report.get("step", -1)),
                       "storage_reads": int(
                           report.get("storage_reads", 0) or 0)},
            )
        if fired is None:
            return Observation.nothing()
        from dlrover_tpu_torch.observability import metrics as obs_metrics

        obs_metrics.record_sentinel_breach(
            "job.recovery.mttr_s", self.name
        )
        return fired

    def resolve(self, observation: Observation, **kwargs) -> DiagnosisAction:
        # the incident carries the priced ladder (the report names the
        # rung and the byte split); the sentinel restarts nothing
        return EventAction(observation.detail, severity="warn")


def register_sentinels(diagnosis_manager, timeseries,
                       job_context=None) -> List[Diagnostician]:
    """Attach the standard sentinel set to a master's diagnosis loop, in
    the reference's order.

    ``job_context`` is the reference's: there, a slow DCN link with no
    in-process demotion target queues a ``brain_demote`` action on the
    master->agent channel.  The port's mesh has no DCN axis and no brain
    (ROADMAP items 6d and 11), so the slow-link sentinel gets no
    demotion hook and the argument is accepted for the same call."""
    del job_context  # no DCN demotion to queue (ROADMAP item 6d)
    sentinels: List[Diagnostician] = [
        GoodputRegressionDiagnostician(timeseries),
        StepTimeRegressionDiagnostician(timeseries),
        ExposedCommDiagnostician(timeseries),
        CkptShareDiagnostician(timeseries),
        SlowLinkDiagnostician(timeseries),
        MemPressureSentinel(timeseries),
        CompileSentinel(timeseries),
        MttrSentinel(timeseries),
        DataStarvationDiagnostician(timeseries),
        ShardLatencyRegressionDiagnostician(timeseries),
    ]
    for sentinel in sentinels:
        diagnosis_manager.register(sentinel)
    return sentinels


# ---------------------------------------------------------------------------
# Bench-side gate: judge the current round against a recorded trajectory
# of round entries.
# ---------------------------------------------------------------------------

#: watched history fields: dotted path into an entry -> the direction
#: that is a REGRESSION
BENCH_WATCH: Dict[str, str] = {
    "step_ms": "up",
    "tokens_per_sec": "down",
    "vs_baseline": "down",
    "blocking_save_s": "up",
    "compile_s": "up",
    "cache_hit_ratio": "down",
    "fleet_goodput_gain": "down",
    # the live in-place transition must stay cheap, and keep its
    # edge over the restart path it replaces
    "live_reshard_s": "up",
    "reshard_speedup_vs_restart": "down",
    # a failure must stay sub-budget, and the peer rung must keep
    # its bandwidth edge over the storage path it bypasses
    "recovery_mttr_s": "up",
    "peer_read_gbps": "down",
    # the data pipeline must keep dispatching fast (lease p99,
    # throughput) and the ledger must not drift toward starvation
    "data_p99_ms": "up",
    "shards_per_s": "down",
    "gp_input_starved": "up",
}


def _comparable(entry: Dict[str, Any], current: Dict[str, Any]) -> bool:
    """Only rounds measured under the same conditions feed the
    baseline: a round run without its accelerator (the entry's
    ``tpu_unavailable`` flag, the reference's key) must not judge (or be
    judged by) a real-hardware trajectory, and a round whose headline
    came from another source (``headline_source``) is comparable only to
    rounds of that source."""
    return (
        bool(entry.get("tpu_unavailable"))
        == bool(current.get("tpu_unavailable"))
        and entry.get("preset") == current.get("preset")
        and entry.get("headline_source") == current.get("headline_source")
    )


def compare_round(
    history: Sequence[Dict[str, Any]],
    current: Dict[str, Any],
    watch: Optional[Dict[str, str]] = None,
) -> Dict[str, Any]:
    """Replay the comparable history through a fresh detector per
    watched metric, then judge the current round's value.  Returns
    ``{"regressions": [...], "checked": {metric: verdict}}``; a metric
    without enough comparable history is reported ``"cold"`` and never
    fails the gate."""
    watch = watch or BENCH_WATCH
    comparable = [e for e in history if _comparable(e, current)]
    checked: Dict[str, Any] = {}
    regressions: List[str] = []
    for metric, bad_direction in watch.items():
        value = current.get(metric)
        if value is None:
            continue
        detector = EwmaMadDetector(
            direction=bad_direction, consecutive=1
        )
        fed = 0
        for entry in comparable:
            past = entry.get(metric)
            if past is None:
                continue
            detector.update(float(past))
            fed += 1
        if fed < detector.min_samples:
            checked[metric] = {"verdict": "cold", "history": fed}
            continue
        breach = detector.update(float(value))
        if breach is not None:
            checked[metric] = {
                "verdict": "regression", "history": fed, **breach,
            }
            regressions.append(metric)
        else:
            checked[metric] = {
                "verdict": "ok", "history": fed,
                "baseline": round(detector.baseline, 6),
                "value": round(float(value), 6),
            }
    return {
        "regressions": regressions,
        "ok": not regressions,
        "checked": checked,
        "comparable_rounds": len(comparable),
        "ts": round(time.time(), 3),
    }
