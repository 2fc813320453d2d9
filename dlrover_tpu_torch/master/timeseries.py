"""Master time-series store: bounded multi-resolution rings + rollups.

Copy of ``dlrover_tpu/master/timeseries.py``.  The ``/metrics`` page
answers "what is the value now"; the flight recorder answers "what
happened in the last minute on one process".  Neither can answer "when
did step time start drifting" or "show me the goodput curve the incident
landed on": that needs a queryable timeline on the master.  This store
keeps one: every series is downsampled into three bounded rings (1 s /
10 s / 5 min buckets, each ``DLROVER_TPU_TS_POINTS`` buckets long), each
bucket aggregating mean/min/max/count/last.

Feeds:

* :meth:`TimeSeriesStore.record_digest` — the heartbeat-digest channel
  (``comm.HeartBeat.digest``, fed by the servicer).  Step-time digests
  become per-node ``node<N>.step_p50_s`` points; the cumulative
  goodput-ledger counters (``gp_<phase>``/``gp_wall`` from
  ``observability/goodput.py``) are differentiated per heartbeat into
  per-node goodput and per-phase *share* series, then rolled into
  fresh-node job aggregates (``job.goodput``, ``job.share.<phase>``,
  ``job.step_p50_s``).  The fabric keys (``fxl_*``/``fxb_*``,
  ``commscope``), the memory keys (``mm_*``/``mms_*``, ``memscope``) and
  the compile keys (``js_*``, ``jitscope``) feed ``node<N>.comm.*``,
  ``node<N>.mem.*`` and ``node<N>.compile.*`` with their job rollups.
* :meth:`TimeSeriesStore.record_recovery` — the servicer's
  ``RecoveryReport`` route: ``job.recovery.*`` and the recent reports the
  MTTR sentinel reads.
* :meth:`TimeSeriesStore.add` — anything else worth a curve.

Every key the store reads is one the port's scopes write.  Two of them
mean the kernel build cache here: ``js_warm`` and ``js_cache`` come from
the scope's ``warm_expected``/``cache_enabled``, seeded at boot from
``trainer/bootstrap.compile_cache_info()`` (the kernel build directory is
the port's persistent compile cache).  A memory digest without a limit
(``mm_limit_b`` 0: the CPU with no ``DLROVER_TPU_MEM_CPU_LIMIT_B``) feeds
no ``headroom_frac``/``job.mem.headroom`` series: absent, not zero.

Reads: :meth:`series`, :meth:`latest`, :meth:`snapshot`, pull gauges on
the ``/metrics`` registry (:meth:`register_pull_gauges`), and
:meth:`export_counters` — Perfetto counter-track records the incident
engine's timeline merges, so incidents land on top of the goodput curve.
:meth:`register_data_gauges` puts the servicer's datascope shard
telemetry on the same registry, read live.

Pure in-memory; every mutation is a few dict/deque updates under one
lock.
"""

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from dlrover_tpu_torch.common import envs

#: ring resolutions in seconds (fine -> coarse)
RESOLUTIONS = (1.0, 10.0, 300.0)

from dlrover_tpu_torch.master.metric_context import DIGEST_FRESH_S  # noqa: E402

#: how old a node's latest digest may be and still count toward the
#: job aggregates — the SAME constant the agent's rank-file filter and
#: the master's laggard screens use
FRESH_S = DIGEST_FRESH_S


class _Ring:
    """One bounded ring of ``[bucket_ts, mean, min, max, count, last]``
    buckets at a fixed resolution."""

    __slots__ = ("res", "_points")

    def __init__(self, res: float, maxlen: int):
        self.res = res
        self._points: deque = deque(maxlen=maxlen)

    def add(self, ts: float, value: float) -> None:
        bucket = int(ts / self.res) * self.res
        if self._points and self._points[-1][0] == bucket:
            point = self._points[-1]
            point[4] += 1
            point[1] += (value - point[1]) / point[4]
            point[2] = min(point[2], value)
            point[3] = max(point[3], value)
            point[5] = value
        elif not self._points or bucket > self._points[-1][0]:
            self._points.append([bucket, value, value, value, 1, value])
        # out-of-order points older than the live bucket are dropped:
        # the rings are append-only so reads stay monotone

    def points(self) -> List[List[float]]:
        return [list(p) for p in self._points]


class TimeSeriesStore:
    def __init__(self, points_per_ring: Optional[int] = None):
        self._maxlen = max(
            8,
            int(points_per_ring if points_per_ring is not None
                else envs.get_int("DLROVER_TPU_TS_POINTS")),
        )
        self._mu = threading.Lock()
        self._series: Dict[str, Dict[float, _Ring]] = {}
        # node_id -> (ts, last cumulative gp_* sample) for
        # differentiation + delta-plausibility gating
        self._gp_last: Dict[int, Any] = {}
        # node_id -> (ts, goodput, {phase: share}, step_p50) latest
        self._node_latest: Dict[int, Dict[str, Any]] = {}
        # node_id -> (ts, {axis: lat_us}, {axis: gbps}) latest fabric
        # sample (comm observatory, fxl_/fxb_ digest keys)
        self._comm_latest: Dict[int, Any] = {}
        # node_id -> latest memory-digest sample (memory observatory,
        # mm_/mms_ digest keys)
        self._mem_latest: Dict[int, Dict[str, Any]] = {}
        # node_id -> (event_ts, seq, cumulative js_ values) baseline +
        # latest view (compile observatory, js_ digest keys)
        self._js_last: Dict[int, Any] = {}
        self._js_latest: Dict[int, Dict[str, Any]] = {}
        # bounded recent recovery reports (record_recovery feed; the
        # MTTR sentinel and /recovery dashboard read them)
        self._recoveries: List[Dict[str, Any]] = []

    # -- writes -------------------------------------------------------------

    def add(self, name: str, value: float,
            ts: Optional[float] = None) -> None:
        ts = time.time() if ts is None else float(ts)
        value = float(value)
        with self._mu:
            rings = self._series.get(name)
            if rings is None:
                rings = self._series[name] = {
                    res: _Ring(res, self._maxlen) for res in RESOLUTIONS
                }
            for ring in rings.values():
                ring.add(ts, value)

    def record_digest(self, node_id: int, digest: Dict[str, float],
                      ts: Optional[float] = None) -> None:
        """One heartbeat digest: per-node points + job rollups.

        The ``gp_*`` keys are CUMULATIVE seconds; the per-heartbeat
        delta yields the recent-window account (``Δcompute/Δwall`` = the
        node's recent goodput).  A negative wall delta means a process
        restarted and reset its counters — the sample re-baselines
        instead of producing a bogus point."""
        ts = time.time() if ts is None else float(ts)
        step_p50 = float(digest.get("step_p50_s", 0.0) or 0.0)
        if step_p50 > 0:
            self.add(f"node{node_id}.step_p50_s", step_p50, ts)
        self._record_comm(node_id, digest, ts)
        self._record_mem(node_id, digest, ts)
        self._record_compile(node_id, digest, ts)
        gp_now = {
            k: float(v) for k, v in digest.items()
            if k.startswith("gp_") and k != "gp_seq"
        }
        seq = float(digest.get("gp_seq", 0.0) or 0.0)
        latest: Optional[Dict[str, Any]] = None
        if gp_now:
            plot = False
            with self._mu:
                prev = self._gp_last.get(node_id)
                if prev is None:
                    self._gp_last[node_id] = (ts, seq, gp_now)
            if prev is not None:
                prev_ts, prev_seq, gp_prev = prev
                d_wall = gp_now.get("gp_wall", 0.0) - gp_prev.get(
                    "gp_wall", 0.0
                )
                # the rank accounts only move when their digest files
                # rewrite (every DIGEST_EVERY steps) — gp_seq marks
                # those advances.  Heartbeats in between are NOT
                # re-baselined: their (agent-only or empty) deltas
                # accumulate until the next advance, so the plotted
                # delta always spans a full advance window.  Without a
                # seq (older agents) any positive wall delta advances.
                advanced = (
                    seq > prev_seq if (seq and prev_seq) else d_wall > 0
                )
                if d_wall < 0 or (seq and prev_seq and seq < prev_seq):
                    # a process restarted and reset its counters (or
                    # a stale rank dropped out of the sum): re-baseline
                    with self._mu:
                        self._gp_last[node_id] = (ts, seq, gp_now)
                elif advanced and d_wall > 0:
                    # plausibility gate, measured against the LAST
                    # ADVANCE: the summed wall moves by roughly
                    # (processes x window).  A much larger jump means a
                    # cumulative account REJOINED the sum after a
                    # staleness window (a wedged rank's file
                    # recovering) — re-baseline instead of plotting
                    # lifetime averages as one recent bucket.
                    gap = ts - prev_ts
                    procs = max(
                        1.0, float(digest.get("ranks", 1.0))
                    ) + 1.0
                    plot = not (
                        gap > 0 and d_wall > procs * gap * 3.0 + 30.0
                    )
                    with self._mu:
                        self._gp_last[node_id] = (ts, seq, gp_now)
                if plot:
                    shares: Dict[str, float] = {}
                    for key, value in gp_now.items():
                        if key == "gp_wall":
                            continue
                        delta = value - gp_prev.get(key, 0.0)
                        shares[key[3:]] = max(
                            0.0, min(1.0, delta / d_wall)
                        )
                    goodput = shares.get("compute", 0.0)
                    self.add(f"node{node_id}.goodput", goodput, ts)
                    for phase, share in shares.items():
                        self.add(
                            f"node{node_id}.share.{phase}", share, ts
                        )
                    latest = {
                        "ts": ts, "goodput": goodput, "shares": shares,
                        "step_p50_s": step_p50,
                    }
        if latest is None and step_p50 > 0:
            # a heartbeat with step times but no usable ledger delta:
            # only the step time is fresh — copying the PREVIOUS
            # goodput/shares forward under a new timestamp would
            # re-stamp stale ledger data as live indefinitely (e.g. a
            # node restarted with the ledger kill switch on)
            latest = {
                "ts": ts, "goodput": None, "shares": {},
                "step_p50_s": step_p50,
            }
        if latest is not None:
            with self._mu:
                self._node_latest[node_id] = latest
            self._roll_job(ts)

    def _record_comm(self, node_id: int, digest: Dict[str, float],
                     ts: float) -> None:
        """Fabric-model digest keys (``fxl_<axis>``/``fxb_<axis>`` from
        the comm observatory) -> per-node ``node<N>.comm.<axis>.lat_us``
        / ``.gbps`` series + WORST-case job rollups: a synchronous
        collective runs at the slowest link's pace, so
        ``job.comm.<axis>.lat_us`` is the max and
        ``job.comm.<axis>.gbps`` the min across fresh nodes — the
        series the slow-link sentinel watches."""
        from dlrover_tpu_torch.observability.commscope import (
            DIGEST_BW,
            DIGEST_LAT,
        )

        lat = {
            key[len(DIGEST_LAT):]: float(value)
            for key, value in digest.items()
            if key.startswith(DIGEST_LAT)
        }
        bw = {
            key[len(DIGEST_BW):]: float(value)
            for key, value in digest.items()
            if key.startswith(DIGEST_BW)
        }
        if not lat and not bw:
            return
        for axis, value in lat.items():
            self.add(f"node{node_id}.comm.{axis}.lat_us", value, ts)
        for axis, value in bw.items():
            self.add(f"node{node_id}.comm.{axis}.gbps", value, ts)
        cutoff = ts - FRESH_S
        with self._mu:
            self._comm_latest[node_id] = (ts, lat, bw)
            fresh = [
                entry for entry in self._comm_latest.values()
                if entry[0] >= cutoff
            ]
        worst_lat: Dict[str, float] = {}
        worst_bw: Dict[str, float] = {}
        for _, node_lat, node_bw in fresh:
            for axis, value in node_lat.items():
                worst_lat[axis] = max(worst_lat.get(axis, 0.0), value)
            for axis, value in node_bw.items():
                worst_bw[axis] = (
                    value if axis not in worst_bw
                    else min(worst_bw[axis], value)
                )
        for axis, value in worst_lat.items():
            self.add(f"job.comm.{axis}.lat_us", value, ts)
        for axis, value in worst_bw.items():
            self.add(f"job.comm.{axis}.gbps", value, ts)

    def _record_mem(self, node_id: int, digest: Dict[str, float],
                    ts: float) -> None:
        """Memory-observatory digest keys (``mm_*``/``mms_*`` from
        ``observability/memscope.py``) -> per-node ``node<N>.mem.*``
        series + worst-case job rollups: the job is as close to OOM as
        its most squeezed chip, so ``job.mem.headroom`` is the MIN
        headroom fraction and ``job.mem.used_b`` the MAX in-use bytes
        across fresh nodes — the series the mem-pressure sentinel
        watches."""
        from dlrover_tpu_torch.observability.memscope import (
            DIGEST_PREFIX,
            DIGEST_SUB,
        )

        scalars = {
            key[len(DIGEST_PREFIX):]: float(value)
            for key, value in digest.items()
            if key.startswith(DIGEST_PREFIX)
            and not key.startswith(DIGEST_SUB)
        }
        subs = {
            key[len(DIGEST_SUB):]: float(value)
            for key, value in digest.items()
            if key.startswith(DIGEST_SUB)
        }
        if not scalars and not subs:
            return
        # the SAMPLE timestamp (mm_ts): heartbeats between samples
        # re-ship the same account, and re-stamping it at every
        # heartbeat would zero the leak slope the sentinel watches —
        # slope math anchors to when the bytes were measured
        sample_ts = float(scalars.pop("ts", 0.0) or 0.0)
        if 0 < sample_ts <= ts:
            ts = sample_ts
        used = scalars.get("used_b", 0.0)
        limit = scalars.get("limit_b", 0.0)
        headroom_frac = None
        if limit > 0:
            headroom_frac = max(0.0, min(1.0, (limit - used) / limit))
        for name in ("used_b", "peak_b", "rss_b", "shm_b"):
            if name in scalars:
                self.add(f"node{node_id}.mem.{name}", scalars[name], ts)
        if headroom_frac is not None:
            self.add(
                f"node{node_id}.mem.headroom_frac", headroom_frac, ts
            )
        for name, value in subs.items():
            self.add(f"node{node_id}.mem.sub.{name}", value, ts)
        cutoff = ts - FRESH_S
        entry = {
            "ts": ts, "used_b": used, "limit_b": limit,
            "peak_b": scalars.get("peak_b", 0.0),
            "rss_b": scalars.get("rss_b", 0.0),
            "shm_b": scalars.get("shm_b", 0.0),
            "headroom_frac": headroom_frac,
            "subsystems": subs,
        }
        with self._mu:
            self._mem_latest[node_id] = entry
            fresh = [
                e for e in self._mem_latest.values()
                if e["ts"] >= cutoff
            ]
        if fresh:
            self.add(
                "job.mem.used_b", max(e["used_b"] for e in fresh), ts
            )
            headrooms = [
                e["headroom_frac"] for e in fresh
                if e["headroom_frac"] is not None
            ]
            if headrooms:
                self.add("job.mem.headroom", min(headrooms), ts)
            worst_subs: Dict[str, float] = {}
            for e in fresh:
                for name, value in (e.get("subsystems") or {}).items():
                    worst_subs[name] = max(
                        worst_subs.get(name, 0.0), value
                    )
            for name, value in worst_subs.items():
                self.add(f"job.mem.sub.{name}", value, ts)

    def _record_compile(self, node_id: int, digest: Dict[str, float],
                        ts: float) -> None:
        """Compile-observatory digest keys (``js_*`` from
        ``observability/jitscope.py``, cumulative) -> per-node
        ``node<N>.compile.*`` series + worst-case job rollups.

        The counters only move when a compile EVENT lands (``js_seq``
        advances), so differentiation keys on the sequence — guarded
        by the ``js_boot`` marker: a seq advance within the SAME boot
        plots the window deltas; a newer boot (or, for older digests
        without the marker, a seq/event-ts that moved backward under a
        newer event timestamp) is a process restart — its fresh
        cumulative account IS that boot's compile burst (exactly the
        cost an elastic restart pays), plotted whole, then
        re-baselined.  Without the boot marker a restart whose event
        count EXCEEDED the dead boot's would be differentiated across
        two unrelated boots (the gp_seq/mm_ts bug class).  Heartbeats
        between events plot nothing."""
        vals = {
            key[3:]: float(value) for key, value in digest.items()
            if key.startswith("js_")
        }
        if not vals:
            return
        seq = vals.get("seq", 0.0)
        event_ts = vals.get("ts", 0.0)
        boot = vals.get("boot", 0.0)
        plot_ts = event_ts if 0 < event_ts <= ts else ts
        with self._mu:
            prev = self._js_last.get(node_id)
            self._js_last[node_id] = (event_ts, seq, vals)
        window: Optional[Dict[str, float]] = None
        if prev is not None:
            prev_ts, prev_seq, prev_vals = prev
            prev_boot = prev_vals.get("boot", 0.0)
            restarted = (
                boot > prev_boot + 1e-6 if boot and prev_boot
                else (event_ts > prev_ts + 1e-6 and seq <= prev_seq)
            )
            if restarted:
                # a restarted process's first events: cumulative = the
                # boot's own compile account (a partial multi-rank
                # restart may overstate one window; it re-baselines on
                # the next advance and the storm sentinel needs
                # consecutive breaches)
                window = {
                    key: max(0.0, vals.get(key, 0.0))
                    for key in ("compile_s", "hits", "misses", "stalls")
                }
            elif seq > prev_seq:
                window = {
                    key: max(0.0, vals.get(key, 0.0)
                             - prev_vals.get(key, 0.0))
                    for key in ("compile_s", "hits", "misses", "stalls")
                }
        if window is None:
            # an eventless heartbeat re-ships the same account: plot
            # nothing and KEEP the node's last event snapshot (with
            # its differentiated window) — overwriting it with a
            # window-less copy would strip the windowed ratio the
            # cache-cold sentinel reads and re-expose the cumulative
            # fallback on every re-ship
            with self._mu:
                if node_id in self._js_latest:
                    return
        if window is not None:
            self.add(
                f"node{node_id}.compile.s", window["compile_s"], plot_ts
            )
            self.add(
                f"node{node_id}.compile.misses", window["misses"],
                plot_ts,
            )
            looked_up = window["hits"] + window["misses"]
            if looked_up > 0:
                self.add(
                    f"node{node_id}.compile.hit_ratio",
                    window["hits"] / looked_up, plot_ts,
                )
        entry = {
            "ts": plot_ts,
            "seq": seq,
            "compile_s": vals.get("compile_s", 0.0),
            "hits": vals.get("hits", 0.0),
            "misses": vals.get("misses", 0.0),
            "stalls": vals.get("stalls", 0.0),
            "warm_expected": vals.get("warm", 0.0) > 0,
            "cache_enabled": vals.get("cache", 0.0) > 0,
            "window": window,
        }
        looked_up = entry["hits"] + entry["misses"]
        entry["hit_ratio"] = (
            entry["hits"] / looked_up if looked_up > 0 else None
        )
        # the WINDOWED ratio feeds the job rollup: a long healthy run
        # must not dilute a fresh cold streak (nor one expected cold
        # first-trace miss permanently depress a perfect cache)
        window_lookups = (
            window["hits"] + window["misses"]
            if window is not None else 0.0
        )
        entry["window_hit_ratio"] = (
            window["hits"] / window_lookups
            if window is not None and window_lookups > 0 else None
        )
        with self._mu:
            self._js_latest[node_id] = entry
        if window is not None:
            # only THIS node's freshly differentiated window joins the
            # job series: re-recording other nodes' stale last windows
            # would double-count a single large compile into several
            # rollup buckets (and could fabricate a storm).  Concurrent
            # windows from other nodes land as their own points; the
            # ring buckets aggregate mean/max/min across them.
            self.add("job.compile.s", window["compile_s"], plot_ts)
            if entry["window_hit_ratio"] is not None:
                self.add(
                    "job.compile.hit_ratio",
                    entry["window_hit_ratio"], plot_ts,
                )

    def record_recovery(self, report: Dict[str, Any],
                        ts: Optional[float] = None) -> None:
        """One finished recovery (``comm.RecoveryReport`` payload) ->
        ``job.recovery.*`` series + the bounded last-recoveries list the
        MTTR sentinel reads.  MTTR and peer bandwidth become curves so
        a recovery-latency drift is visible in /timeseries, not just in
        the incident that fires once the budget is blown."""
        ts = time.time() if ts is None else float(ts)
        mttr = float(report.get("mttr_s", 0.0) or 0.0)
        if mttr > 0:
            self.add("job.recovery.mttr_s", mttr, ts)
        gbps = float(report.get("peer_read_gbps", 0.0) or 0.0)
        if gbps > 0:
            self.add("job.recovery.peer_read_gbps", gbps, ts)
        entry = dict(report, ts=ts)
        with self._mu:
            self._recoveries.append(entry)
            del self._recoveries[:-32]

    def recoveries(self) -> List[Dict[str, Any]]:
        """Recent recovery reports, oldest first (the MTTR sentinel's
        input and part of the ``/recovery`` dashboard view)."""
        with self._mu:
            return [dict(r) for r in self._recoveries]

    def compile_nodes(self) -> Dict[int, Dict[str, Any]]:
        """Latest per-node compile sample (the ``/compile`` dashboard
        source and the cache-cold sentinel's input): cumulative compile
        seconds / hits / misses / stalls, the warm-expected and
        cache-enabled flags, and the last differentiated window."""
        with self._mu:
            out = {
                node_id: dict(entry)
                for node_id, entry in self._js_latest.items()
            }
        for entry in out.values():
            if entry.get("window") is not None:
                entry["window"] = dict(entry["window"])
        return out

    def mem_nodes(self) -> Dict[int, Dict[str, Any]]:
        """Latest per-node memory sample (the ``/mem`` dashboard source
        and the mem-pressure sentinel's culprit/slope input)."""
        with self._mu:
            entries = {
                node_id: dict(entry)
                for node_id, entry in self._mem_latest.items()
            }
        for entry in entries.values():
            entry["subsystems"] = dict(entry.get("subsystems") or {})
        return entries

    def comm_nodes(self) -> Dict[int, Dict[str, Any]]:
        """Latest per-node fabric sample (the ``/comm`` dashboard
        source): node -> {ts, axes: {axis: {lat_us, gbps}}}."""
        with self._mu:
            entries = dict(self._comm_latest)
        out: Dict[int, Dict[str, Any]] = {}
        for node_id, (ts, lat, bw) in entries.items():
            axes: Dict[str, Dict[str, float]] = {}
            for axis, value in lat.items():
                axes.setdefault(axis, {})["lat_us"] = round(value, 3)
            for axis, value in bw.items():
                axes.setdefault(axis, {})["gbps"] = round(value, 6)
            out[node_id] = {"ts": round(ts, 3), "axes": axes}
        return out

    def _roll_job(self, ts: float) -> None:
        """Fresh-node means become the job series (the sentinel's
        input): ``job.goodput``, ``job.share.<phase>``,
        ``job.step_p50_s``."""
        cutoff = ts - FRESH_S
        with self._mu:
            fresh = [
                entry for entry in self._node_latest.values()
                if entry["ts"] >= cutoff
            ]
        if not fresh:
            return
        goodputs = [
            e["goodput"] for e in fresh if e.get("goodput") is not None
        ]
        if goodputs:
            self.add("job.goodput", sum(goodputs) / len(goodputs), ts)
        phases: Dict[str, List[float]] = {}
        for entry in fresh:
            for phase, share in (entry.get("shares") or {}).items():
                phases.setdefault(phase, []).append(share)
        for phase, values in phases.items():
            self.add(
                f"job.share.{phase}", sum(values) / len(values), ts
            )
        steps = [
            e["step_p50_s"] for e in fresh
            if e.get("step_p50_s", 0.0) > 0
        ]
        if steps:
            # the job runs at the slowest host's pace
            self.add("job.step_p50_s", max(steps), ts)

    def evict_node(self, node_id: int) -> None:
        """Forget a dead/relaunched node's cumulative baseline and
        freshness entry (its node.* series age out on their own)."""
        with self._mu:
            self._gp_last.pop(node_id, None)
            self._node_latest.pop(node_id, None)
            self._comm_latest.pop(node_id, None)
            self._mem_latest.pop(node_id, None)
            self._js_last.pop(node_id, None)
            self._js_latest.pop(node_id, None)

    # -- reads --------------------------------------------------------------

    def names(self) -> List[str]:
        with self._mu:
            return sorted(self._series)

    def series(self, name: str, res: float = 10.0) -> List[Dict[str, Any]]:
        """Buckets of one series at the ring whose resolution is
        closest to ``res``, oldest first."""
        with self._mu:
            rings = self._series.get(name)
            if not rings:
                return []
            ring = rings[min(rings, key=lambda r: abs(r - res))]
            points = ring.points()
        return [
            {
                "ts": p[0], "mean": round(p[1], 6), "min": round(p[2], 6),
                "max": round(p[3], 6), "count": int(p[4]),
                "last": round(p[5], 6),
            }
            for p in points
        ]

    def latest(self, name: str) -> Optional[float]:
        """Most recent raw value of a series (finest ring's live
        bucket), or None."""
        with self._mu:
            rings = self._series.get(name)
            if not rings:
                return None
            ring = rings[RESOLUTIONS[0]]
            if not ring._points:
                return None
            return float(ring._points[-1][5])

    def snapshot(self, res: float = 10.0,
                 prefix: str = "") -> Dict[str, Any]:
        """The ``/timeseries`` JSON body: every series (optionally
        prefix-filtered) at one resolution."""
        return {
            "resolution_s": float(
                min(RESOLUTIONS, key=lambda r: abs(r - res))
            ),
            "resolutions_s": list(RESOLUTIONS),
            "series": {
                name: self.series(name, res)
                for name in self.names()
                if name.startswith(prefix)
            },
        }

    def export_counters(
        self, prefix: str = "job.", res: float = 1.0
    ) -> List[Dict[str, Any]]:
        """Perfetto counter-track records (``{"ts","name","value"}``)
        the timeline assembler merges (``timeline.assemble
        (counter_files=...)``), so incident spans land ON the goodput/
        step-time curves."""
        out: List[Dict[str, Any]] = []
        for name in self.names():
            if not name.startswith(prefix):
                continue
            for point in self.series(name, res):
                out.append(
                    {
                        "ts": point["ts"], "name": name,
                        "value": point["mean"],
                    }
                )
        out.sort(key=lambda r: (r["ts"], r["name"]))
        return out

    def register_pull_gauges(self) -> None:
        """Expose the job rollups on the ``/metrics`` registry as
        collect-on-read gauges (zero cost per heartbeat)."""
        from dlrover_tpu_torch.observability import goodput as gp
        from dlrover_tpu_torch.observability import metrics as obs_metrics

        reg = obs_metrics.registry()

        def _latest(name: str):
            def read():
                value = self.latest(name)
                if value is None:
                    raise LookupError(name)  # no series yet: no sample
                return value

            return read

        reg.gauge_fn(
            "dlrover_tpu_goodput_ledger", _latest("job.goodput"),
            help="ledger-derived job goodput (fresh-node mean of the "
            "recent compute share)",
        )
        reg.gauge_fn(
            "dlrover_tpu_step_p50_seconds", _latest("job.step_p50_s"),
            help="job p50 step time (slowest fresh host)",
        )
        for phase in gp.ALL_PHASES:
            reg.gauge_fn(
                "dlrover_tpu_goodput_phase_share",
                _latest(f"job.share.{phase}"),
                help="recent wall-clock share per ledger phase "
                "(fresh-node mean)",
                phase=phase,
            )
        from dlrover_tpu_torch.observability import memscope

        reg.gauge_fn(
            "dlrover_tpu_mem_used_bytes", _latest("job.mem.used_b"),
            help=obs_metrics._help("dlrover_tpu_mem_used_bytes"),
        )
        reg.gauge_fn(
            "dlrover_tpu_mem_headroom", _latest("job.mem.headroom"),
            help=obs_metrics._help("dlrover_tpu_mem_headroom"),
        )
        for subsystem in memscope.SUBSYSTEMS:
            reg.gauge_fn(
                "dlrover_tpu_mem_subsystem_bytes",
                _latest(f"job.mem.sub.{subsystem}"),
                help=obs_metrics._help(
                    "dlrover_tpu_mem_subsystem_bytes"
                ),
                subsystem=subsystem,
            )
        reg.gauge_fn(
            "dlrover_tpu_compile_recent_seconds",
            _latest("job.compile.s"),
            help=obs_metrics._help("dlrover_tpu_compile_recent_seconds"),
        )
        reg.gauge_fn(
            "dlrover_tpu_compile_cache_hit_ratio",
            _latest("job.compile.hit_ratio"),
            help=obs_metrics._help(
                "dlrover_tpu_compile_cache_hit_ratio"
            ),
        )

    def register_data_gauges(self, telemetry: Any) -> None:
        """Expose the datascope shard telemetry on ``/metrics`` as
        collect-on-read gauges (live reads of the ``ShardTelemetry``
        aggregate — not the flushed series, so a scrape between
        flushes still sees current backlog)."""
        from dlrover_tpu_torch.observability import metrics as obs_metrics

        reg = obs_metrics.registry()

        def _gauge(key: str):
            def read():
                return telemetry.gauges()[key]

            return read

        reg.gauge_fn(
            "dlrover_tpu_data_backlog", _gauge("backlog"),
            help=obs_metrics._help("dlrover_tpu_data_backlog"),
        )
        reg.gauge_fn(
            "dlrover_tpu_data_shards_per_second", _gauge("shards_per_s"),
            help=obs_metrics._help("dlrover_tpu_data_shards_per_second"),
        )
        reg.gauge_fn(
            "dlrover_tpu_data_lease_p99_ms", _gauge("lease_p99_ms"),
            help=obs_metrics._help("dlrover_tpu_data_lease_p99_ms"),
        )
