"""Incident engine: detection -> coordinated evidence -> verdict, automated.

Copy of ``dlrover_tpu/observability/incidents.py``: the same verdict
(:func:`classify`), the same ``INCIDENT.json`` keys and the same
lifecycle (open, add_dump, finalize, cooldown, grace, eviction, the
open-incidents gauge).  The local master builds one and attaches it to
its diagnosis manager and its servicer, and attaches the servicer's
time-series store (``set_timeseries``): a memory incident embeds the
culprit's ``mem.*`` series and the timeline carries the job's counter
tracks.

The diagnosticians (``diagnosis/``) *detect* — a hang, a
straggler, a checkpoint stall, an overload storm.  This module closes
the loop the paper's runtime-diagnosis pitch implies: the moment a
master-side diagnostician fires, the master

1. **opens an incident** — a directory under
   ``DLROVER_TPU_INCIDENT_DIR`` plus a broadcast ``flight_dump`` action
   on the existing heartbeat/action channel,
2. **collects evidence** — every agent snapshots its flight recorder
   (recent spans/events/steps/log tail + all-thread stacks, see
   ``flight_recorder.py``) and reports it back over the normal report
   RPC (``comm.IncidentDumpReport``); the master dumps its own recorder
   immediately,
3. **renders a verdict** — :func:`classify` names the culprit rank, the
   phase it stalled in (rpc / kv / rendezvous / ckpt / heartbeat /
   admission / collective), the stuck operation, and — when chaos is
   armed — the exact injected fault, joined through the trace/span ids
   the chaos engine already stamps.  The dumps merge through
   ``timeline.assemble`` into ONE Perfetto incident file whose
   ``span_forest`` connectivity is part of the verdict.

``INCIDENT.json`` is the artifact an operator (or the chaos drill's
regression gate) reads; the drill's scenarios each assert their
expected classification (``diagnosis/chaos_drill.py``), making the
diagnosis itself a regression-gated surface.

Incidents are bounded (``DLROVER_TPU_INCIDENT_MAX`` kept on disk) and
deduplicated (one incident per kind per
``DLROVER_TPU_INCIDENT_COOLDOWN_S`` window) so a flapping detector
cannot fill a disk or spam dumps through the fleet.
"""

import json
import os
import shutil
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.observability import metrics as obs_metrics

#: chaos injection point prefix -> the phase the fault wounds.  Ordered:
#: first match wins (checked with str.startswith).
PHASE_BY_POINT = (
    ("master_client.transport", "rpc"),
    ("master_client.barrier", "rpc"),
    ("unified_rpc.", "rpc"),
    ("kv_store.", "kv"),
    ("kv_server.", "kv"),
    ("rdzv.", "rendezvous"),
    ("agent.heartbeat", "heartbeat"),
    ("servicer.admission", "admission"),
    # the peer-restore fast path (serve endpoint + shard fetch) wounds
    # the recovery subsystem, not the checkpoint it is routing around
    ("peer.", "recovery"),
    ("snapshot.", "ckpt"),
    ("storage.", "ckpt"),
    ("flash.", "ckpt"),
    # the distributed-commit phase points (host phase-1 report, master
    # phase-2 seal) wound the checkpoint subsystem
    ("ckpt.", "ckpt"),
    # the comm observatory's injected per-axis link latency (the
    # simulated DCN slice boundary) wounds the fabric
    ("comm.", "comm"),
    # the memory observatory's injected stats inflation (the synthetic
    # leak) wounds the memory subsystem
    ("mem.", "mem"),
    # the compile observatory's injected compile delay (the synthetic
    # recompile storm) wounds the compile subsystem
    ("jitscope.", "compile"),
    # the data observatory's injected lease/fetch faults (a stalled or
    # dropped shard dispatch) wound the data pipeline
    ("data.", "data"),
)

#: open/stuck span name prefix -> phase (the no-chaos fallback: in
#: production the stuck operation IS the never-finished span).
PHASE_BY_SPAN = (
    # peer_restore.* spans (ladder rungs, cache prewarm) price the
    # recovery window; check before flash./ckpt so the manifest rung's
    # wrapped reads stay classified as recovery
    ("peer_restore.", "recovery"),
    ("flash.", "ckpt"),
    ("ckpt", "ckpt"),
    ("kv.", "kv"),
    ("kv_server.", "kv"),
    ("barrier", "kv"),
    ("rdzv", "rendezvous"),
    ("rpc.", "rpc"),
    ("master.", "rpc"),
    ("role_rpc.", "rpc"),
    ("trainer.step", "collective"),
    # comm.probe.<axis> / comm.bucket<i> spans: a probe or bucket
    # exchange that never finished is a wedged fabric link
    ("comm.", "comm"),
    # mem.sample spans: a sampler stuck reading device stats is a
    # wedged runtime, classified with the memory subsystem
    ("mem.", "mem"),
    # jitscope.compile / jitscope.dispatch_stall spans: the job's wall
    # clock went into XLA compilation
    ("jitscope.", "compile"),
    # data.fetch / data.consume spans: a worker wedged waiting on the
    # input pipeline (an unbounded fetch is a starved dispatch)
    ("data.", "data"),
)


def _phase_of_point(point: str) -> str:
    for prefix, phase in PHASE_BY_POINT:
        if point.startswith(prefix):
            return phase
    return ""


def _phase_of_span(name: str) -> str:
    for prefix, phase in PHASE_BY_SPAN:
        if name.startswith(prefix):
            return phase
    return ""


def _chaos_evidence(dumps: Dict[str, Dict[str, Any]],
                    chaos_records: Optional[List[Dict]]) -> List[Dict]:
    """Chaos fault records from explicit args + every dump's event ring
    (the engine mirrors each fired fault into the recorder)."""
    records = list(chaos_records or [])
    for dump in dumps.values():
        for event in dump.get("events") or []:
            if event.get("type") == "CHAOS":
                records.append(event)
    return records


def _longest_open_span(dumps: Dict[str, Dict[str, Any]],
                       prefer: str = "") -> Optional[Dict[str, Any]]:
    """The open span that has been running longest — the stuck
    operation.  ``prefer`` names a dump tag searched first (the culprit
    node's evidence outranks a healthy peer's)."""
    best: Optional[Dict[str, Any]] = None
    tags = list(dumps)
    if prefer in dumps:
        tags.remove(prefer)
        tags.insert(0, prefer)
    for tag in tags:
        for span in dumps[tag].get("open_spans") or []:
            if best is None or span.get("open_for_s", 0.0) > best.get(
                "open_for_s", 0.0
            ):
                best = dict(span, dump=tag)
        if best is not None and prefer and tag == prefer:
            # culprit evidence found: do not let a peer's longer-lived
            # housekeeping span (a heartbeat loop's wait) outvote it
            break
    return best


def classify(
    kind: str = "",
    detail: str = "",
    culprit: int = -1,
    phase_hint: str = "",
    dumps: Optional[Dict[str, Dict[str, Any]]] = None,
    chaos_records: Optional[List[Dict]] = None,
) -> Dict[str, Any]:
    """Root-cause verdict from the collected evidence.

    Phase priority: an explicit ``phase_hint`` from the firing
    diagnostician wins; else the dominant armed chaos fault names the
    wounded subsystem; else the longest open span (the operation that
    never finished); else ``unknown``.  ``kind`` falls back to
    ``<phase>_fault`` when the opener did not name one (manual/drill
    captures)."""
    dumps = dumps or {}
    chaos_evidence = _chaos_evidence(dumps, chaos_records)
    dominant: Optional[Dict[str, Any]] = None
    if chaos_evidence:
        counts: Dict[str, int] = {}
        for record in chaos_evidence:
            counts[record.get("point", "")] = counts.get(
                record.get("point", ""), 0
            ) + 1
        point = max(counts, key=lambda p: (counts[p], p))
        first = next(
            r for r in chaos_evidence if r.get("point", "") == point
        )
        dominant = {
            "point": point,
            "kind": first.get("kind", ""),
            "fired": counts[point],
            "attributed": sum(
                1 for r in chaos_evidence
                if r.get("point") == point and r.get("span_id")
            ),
        }
    stuck = _longest_open_span(
        dumps, prefer=f"node_{culprit}" if culprit >= 0 else ""
    )
    phase = phase_hint
    if not phase and dominant is not None:
        phase = _phase_of_point(dominant["point"])
    if not phase and stuck is not None:
        phase = _phase_of_span(str(stuck.get("name", "")))
    if not phase:
        phase = "unknown"
    if culprit < 0 and stuck is not None:
        # the dump holding the stuck operation names the stalled rank
        tag = str(stuck.get("dump", ""))
        if tag.startswith("node_"):
            try:
                culprit = int(tag.split("_", 1)[1])
            except ValueError:
                pass
    return {
        "kind": kind or f"{phase}_fault",
        "phase": phase,
        "culprit_node": culprit,
        "stuck_op": (stuck or {}).get("name", ""),
        "stuck_for_s": round(float((stuck or {}).get("open_for_s", 0.0)), 3),
        "chaos": dominant,
        "detail": detail,
    }


class IncidentManager:
    """Master-side incident lifecycle: open -> collect -> finalize."""

    def __init__(self, root: str = "", job_context: Any = None):
        self._root = root or envs.get_str("DLROVER_TPU_INCIDENT_DIR")
        self._job_context = job_context
        self._timeseries = None
        self._mu = threading.Lock()
        # incident_id -> meta dict (insertion-ordered)
        self._incidents: Dict[str, Dict[str, Any]] = {}
        self._last_by_kind: Dict[str, float] = {}
        reg = obs_metrics.registry()
        reg.gauge_fn(
            "dlrover_tpu_incidents_open",
            self._open_count,
            help="incidents opened but not yet finalized",
        )

    def _open_count(self) -> int:
        with self._mu:
            return sum(
                1 for m in self._incidents.values() if not m.get("final")
            )

    def set_timeseries(self, timeseries: Any) -> None:
        """Attach the master time-series store
        (:class:`dlrover_tpu_torch.master.timeseries.TimeSeriesStore`): the
        incident timeline then carries the job goodput/step-time
        counter tracks, so the stuck spans land ON the perf curves
        they wounded."""
        self._timeseries = timeseries

    @property
    def root(self) -> str:
        return self._root

    def incident_dir(self, incident_id: str) -> str:
        return os.path.join(self._root, incident_id)

    # -- open ---------------------------------------------------------------

    def open(
        self,
        kind: str,
        detail: str = "",
        culprit: int = -1,
        phase_hint: str = "",
        broadcast: bool = True,
        opened_ts: Optional[float] = None,
    ) -> str:
        """Open an incident: create its directory, dump the master's own
        recorder, and (by default) broadcast a ``flight_dump`` action so
        every agent snapshots and reports.  Within the per-kind cooldown
        window the existing incident's id is returned instead — repeat
        detections of one episode are one incident.

        ``opened_ts`` backdates the recorded open timestamp (benches
        and drills running on synthetic clocks; the Brain's cost model
        compares it against series timestamps).  Cooldown/eviction
        still run on the real clock."""
        now = time.time()
        cooldown = envs.get_float("DLROVER_TPU_INCIDENT_COOLDOWN_S")
        # expected dump count BEFORE the incident becomes visible: a
        # lazy finalize (dashboard poll) racing the broadcast must not
        # see expected=0 and seal the verdict on the master dump alone
        expected = 0
        if broadcast and self._job_context is not None:
            try:
                from dlrover_tpu_torch.common.constants import NodeType

                expected = len(
                    self._job_context.alive_node_ids(NodeType.WORKER)
                )
            except Exception:  # noqa: BLE001 - grace still bounds finalize
                expected = 0
        with self._mu:
            last = self._last_by_kind.get(kind, 0.0)
            if now - last < cooldown:
                for incident_id in reversed(list(self._incidents)):
                    if self._incidents[incident_id]["kind"] == kind:
                        return incident_id
            self._last_by_kind[kind] = now
            incident_id = (
                time.strftime("%Y%m%d-%H%M%S", time.localtime(now))
                + f"-{kind.replace('/', '_').replace(':', '_')}"
                + f"-{uuid.uuid4().hex[:6]}"
            )
            meta = {
                "incident_id": incident_id,
                "kind": kind,
                "detail": detail,
                "culprit": culprit,
                "phase_hint": phase_hint,
                "opened_ts": round(
                    opened_ts if opened_ts is not None else now, 3
                ),
                # the REAL-clock open time: the dump-grace window must
                # run on it — a backdated opened_ts (synthetic-clock
                # benches) would otherwise finalize instantly, sealing
                # the verdict before any agent dump arrives
                "opened_wall_ts": round(now, 3),
                "dumps": [],
                "expected_dumps": expected,
                "final": None,
            }
            self._incidents[incident_id] = meta
            evict = list(self._incidents)[
                : max(0, len(self._incidents)
                      - max(1, envs.get_int("DLROVER_TPU_INCIDENT_MAX")))
            ]
            for old in evict:
                self._incidents.pop(old, None)
        # IO + broadcast outside the lock
        for old in evict:
            shutil.rmtree(self.incident_dir(old), ignore_errors=True)
        path = self.incident_dir(incident_id)
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f, sort_keys=True)
        try:
            from dlrover_tpu_torch.observability import flight_recorder

            flight_recorder.dump(path, "master")
            with self._mu:
                meta["dumps"].append("master")
        except Exception as e:  # noqa: BLE001 - evidence is best-effort
            logger.warning("incident %s: master dump failed: %s",
                           incident_id, e)
        if broadcast and self._job_context is not None:
            try:
                from dlrover_tpu_torch.diagnosis.diagnosis_action import (
                    FlightDumpAction,
                )

                self._job_context.enqueue_action(
                    -1, FlightDumpAction(incident_id, reason=detail).to_dict()
                )
            except Exception as e:  # noqa: BLE001
                logger.warning("incident %s: dump broadcast failed: %s",
                               incident_id, e)
        obs_metrics.registry().counter_inc(
            "dlrover_tpu_incidents_total",
            help="incidents opened by kind", kind=kind,
        )
        logger.warning(
            "incident %s opened (kind=%s culprit=%s): %s",
            incident_id, kind, culprit, detail,
        )
        return incident_id

    # -- collect ------------------------------------------------------------

    def add_dump(self, incident_id: str, node_id: int,
                 payload: str) -> bool:
        """An agent's flight-recorder snapshot arriving over the report
        RPC.  ``payload`` is the JSON snapshot; stored verbatim as
        ``dump_node_<id>.json``."""
        with self._mu:
            meta = self._incidents.get(incident_id)
        if meta is None:
            logger.warning(
                "dump for unknown incident %s from node %s dropped",
                incident_id, node_id,
            )
            return False
        try:
            snapshot = json.loads(payload)
        except ValueError as e:
            logger.warning("incident %s: bad dump payload from node %s: %s",
                           incident_id, node_id, e)
            return False
        tag = f"node_{node_id}"
        path = self.incident_dir(incident_id)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, f"dump_{tag}.json.tmp")
        with open(tmp, "w") as f:
            json.dump(snapshot, f, sort_keys=True)
        os.replace(tmp, os.path.join(path, f"dump_{tag}.json"))
        with self._mu:
            if tag not in meta["dumps"]:
                meta["dumps"].append(tag)
        return True

    # -- finalize -----------------------------------------------------------

    def _ready(self, meta: Dict[str, Any], force: bool) -> bool:
        if force:
            return True
        grace = envs.get_float("DLROVER_TPU_INCIDENT_GRACE_S")
        arrived = len([d for d in meta["dumps"] if d != "master"])
        opened = meta.get("opened_wall_ts", meta["opened_ts"])
        return (
            arrived >= meta.get("expected_dumps", 0)
            or time.time() - opened >= grace
        )

    def finalize(
        self,
        incident_id: str,
        force: bool = False,
        chaos_records: Optional[List[Dict]] = None,
    ) -> Optional[Dict[str, Any]]:
        """Merge the collected dumps into one Perfetto incident timeline
        + a classified ``INCIDENT.json``.  Returns the incident dict, or
        None while dumps are still expected (within the grace window and
        not ``force``).  Idempotent: a finalized incident returns its
        stored verdict."""
        with self._mu:
            meta = self._incidents.get(incident_id)
            if meta is None:
                return None
            if meta.get("final"):
                return meta["final"]
            if not self._ready(meta, force):
                return None
            tags = list(meta["dumps"])
            kind, detail = meta["kind"], meta["detail"]
            culprit, phase_hint = meta["culprit"], meta["phase_hint"]
            opened_ts = meta["opened_ts"]
        path = self.incident_dir(incident_id)
        dumps: Dict[str, Dict[str, Any]] = {}
        for tag in tags:
            try:
                with open(os.path.join(path, f"dump_{tag}.json")) as f:
                    dumps[tag] = json.load(f)
            except (OSError, ValueError) as e:
                logger.warning("incident %s: dump %s unreadable: %s",
                               incident_id, tag, e)
        # live engine trace: when this process armed the chaos plan the
        # JSONL file may not exist, but the in-memory trace does
        records = list(chaos_records or [])
        try:
            from dlrover_tpu_torch import chaos

            records.extend(chaos.trace())
        except Exception:  # noqa: BLE001 - chaos evidence is optional
            pass
        timeline_summary = self._merge_timeline(path, dumps)
        verdict = classify(
            kind=kind, detail=detail, culprit=culprit,
            phase_hint=phase_hint, dumps=dumps, chaos_records=records,
        )
        incident = {
            "incident_id": incident_id,
            "opened_ts": opened_ts,
            "finalized_ts": round(time.time(), 3),
            "dumps": tags,
            "timeline": timeline_summary,
            **verdict,
        }
        mem_evidence = self._mem_evidence(
            incident_id, verdict, opened_ts
        )
        if mem_evidence is not None:
            incident["mem"] = mem_evidence
        compile_evidence = self._compile_evidence(verdict, dumps)
        if compile_evidence is not None:
            incident["compile"] = compile_evidence
        tmp = os.path.join(path, "INCIDENT.json.tmp")
        with open(tmp, "w") as f:
            json.dump(incident, f, sort_keys=True, indent=1)
        os.replace(tmp, os.path.join(path, "INCIDENT.json"))
        with self._mu:
            meta["final"] = incident
        logger.warning(
            "incident %s finalized: phase=%s culprit=%s stuck_op=%r "
            "chaos=%s",
            incident_id, incident["phase"], incident["culprit_node"],
            incident["stuck_op"],
            (incident["chaos"] or {}).get("point", "-"),
        )
        return incident

    #: incident kinds that are memory verdicts — they embed the
    #: culprit's recent ``mem.*`` series + whether the forecast
    #: sentinel had already breached (predicted-vs-unpredicted OOMs)
    MEM_KINDS = ("hbm_oom", "hbm_leak", "mem_pressure")

    #: incident kinds that are compile verdicts — they embed the
    #: classified compile events from the flight dumps so the verdict
    #: names the FUNCTION that recompiled and WHY
    COMPILE_KINDS = ("recompile_storm", "cache_cold")

    def _compile_evidence(
        self, verdict: Dict[str, Any],
        dumps: Dict[str, Dict[str, Any]],
    ) -> Optional[Dict[str, Any]]:
        """For compile-classified incidents: the recent
        ``jitscope.compile`` spans from the collected dumps (each span
        carries the classified event in its attrs — function, trigger,
        cache hit/miss, compile seconds).  The culprit's dump is
        preferred; the most recent miss is surfaced as ``last_miss`` so
        ``INCIDENT.json`` names the function and trigger directly.
        None for non-compile incidents; never raises."""
        if (
            verdict.get("phase") != "compile"
            and verdict.get("kind") not in self.COMPILE_KINDS
        ):
            return None
        out: Dict[str, Any] = {"events": []}
        try:
            culprit = int(verdict.get("culprit_node", -1))
            tags = sorted(dumps)
            prefer = f"node_{culprit}"
            if prefer in dumps:
                tags.remove(prefer)
                tags.insert(0, prefer)
            events: List[Dict[str, Any]] = []
            for tag in tags:
                for span in dumps[tag].get("spans") or []:
                    if str(span.get("name", "")) != "jitscope.compile":
                        continue
                    attrs = dict(span.get("attrs") or {})
                    attrs["ts"] = span.get("ts", 0.0)
                    attrs["dump"] = tag
                    events.append(attrs)
            events.sort(key=lambda e: e.get("ts", 0.0))
            out["events"] = events[-16:]
            misses = [
                e for e in events if e.get("cache") == "miss"
            ]
            if misses:
                out["last_miss"] = misses[-1]
        except Exception as e:  # noqa: BLE001 - evidence must not
            logger.warning("compile evidence failed: %s", e)  # fail
        return out

    def _mem_evidence(self, incident_id: str, verdict: Dict[str, Any],
                      opened_ts: float) -> Optional[Dict[str, Any]]:
        """For memory-classified incidents: the culprit node's recent
        ``node<N>.mem.*`` time series (the byte account the crash
        destroyed) and whether the forecast sentinel (``hbm_leak`` /
        ``mem_pressure``) had ALREADY opened an incident — the field
        that distinguishes a predicted OOM from an unpredicted one.
        None for non-memory incidents; never raises (evidence is
        best-effort)."""
        if (
            verdict.get("phase") != "mem"
            and verdict.get("kind") not in self.MEM_KINDS
        ):
            return None
        out: Dict[str, Any] = {"series": {}, "forecast_breached": False}
        try:
            culprit = int(verdict.get("culprit_node", -1))
            store = self._timeseries
            if store is not None and culprit >= 0:
                prefix = f"node{culprit}.mem."
                for name in store.names():
                    if name.startswith(prefix):
                        out["series"][name] = store.series(name)[-24:]
            # a forecast only predicts THIS crash when it named the
            # same node (a stale node-3 leak incident must not mark a
            # node-7 OOM as predicted) and was recent enough to be the
            # same episode — twice the forecast horizon bounds how far
            # ahead the sentinel ever looks
            horizon = 2 * max(
                envs.get_float("DLROVER_TPU_MEM_FORECAST_S"), 300.0
            )
            with self._mu:
                forecasts = [
                    {
                        "incident_id": other_id,
                        "kind": meta["kind"],
                        "opened_ts": meta["opened_ts"],
                        "culprit": meta.get("culprit", -1),
                    }
                    for other_id, meta in self._incidents.items()
                    if other_id != incident_id
                    and meta["kind"] in ("hbm_leak", "mem_pressure")
                    and opened_ts - horizon
                    <= meta["opened_ts"] <= opened_ts
                    and (
                        meta.get("culprit", -1) < 0
                        or culprit < 0
                        or meta["culprit"] == culprit
                    )
                ]
            if forecasts:
                out["forecast_breached"] = True
                out["forecast_incidents"] = forecasts
        except Exception as e:  # noqa: BLE001 - evidence must not
            logger.warning(  # fail the verdict
                "incident %s: mem evidence failed: %s", incident_id, e
            )
        return out

    def _merge_timeline(self, path: str,
                        dumps: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
        """Write each dump's span/event rings as per-process JSONL and
        join them with the r10 assembler into one Perfetto file (plus
        the job perf counter tracks when a time-series store is
        attached); the summary (span counts, connected forest) becomes
        part of the verdict."""
        from dlrover_tpu_torch.observability import timeline

        counter_files: List[str] = []
        if self._timeseries is not None:
            try:
                records = self._timeseries.export_counters()
            except Exception as e:  # noqa: BLE001 - counters are
                records = []  # optional evidence
                logger.warning("incident counter export failed: %s", e)
            if records:
                counters_path = os.path.join(path, "counters.jsonl")
                with open(counters_path, "w") as f:
                    for record in records:
                        f.write(json.dumps(record, sort_keys=True) + "\n")
                counter_files.append(counters_path)
        event_files: List[str] = []
        for tag, dump in sorted(dumps.items()):
            target = dump.get("role", tag)
            pid = int(dump.get("pid", 0) or 0)
            records = []
            for record in (dump.get("spans") or []) + (
                dump.get("events") or []
            ):
                if "target" not in record:
                    record = {"target": target, "pid": pid, **record}
                records.append(record)
            if not records:
                continue
            jsonl = os.path.join(path, f"events_{tag}.jsonl")
            with open(jsonl, "w") as f:
                for record in records:
                    f.write(json.dumps(record, sort_keys=True) + "\n")
            event_files.append(jsonl)
        if not event_files and not counter_files:
            return {"spans": 0, "traces": 0, "connected_traces": 0,
                    "forest_ok": False}
        merged = timeline.assemble(
            event_files=event_files, counter_files=counter_files
        )
        summary = merged.pop("summary")
        out = os.path.join(path, "incident_timeline.json")
        with open(out, "w") as f:
            json.dump(merged, f, sort_keys=True)
        forest = summary.pop("span_forest", {})
        summary["forest_ok"] = bool(forest) and all(
            t["connected"] for t in forest.values()
        )
        summary["orphan_spans"] = sum(
            len(t["orphans"]) for t in forest.values()
        )
        return summary

    # -- queries (dashboard) ------------------------------------------------

    def get(self, incident_id: str) -> Optional[Dict[str, Any]]:
        self.finalize(incident_id)  # lazy: grace may have elapsed
        with self._mu:
            meta = self._incidents.get(incident_id)
            return dict(meta) if meta else None

    def annotate(self, incident_id: str, key: str, value: Any) -> bool:
        """Attach a structured annotation to an incident (e.g. the
        Brain's priced restart-vs-ride-out decision) and persist it into
        ``meta.json``; annotations ride :meth:`list_incidents` entries,
        so "this incident was deliberately ridden out" is a queryable
        verdict, not a silent non-action."""
        with self._mu:
            meta = self._incidents.get(incident_id)
            if meta is None:
                return False
            meta.setdefault("annotations", {})[key] = value
            snapshot = dict(meta)
        try:
            path = self.incident_dir(incident_id)
            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, "meta.json"), "w") as f:
                json.dump(snapshot, f, sort_keys=True, default=str)
        except OSError as e:
            logger.warning(
                "incident %s: annotation persist failed: %s",
                incident_id, e,
            )
        return True

    def list_incidents(self) -> List[Dict[str, Any]]:
        """Newest-first incident summaries; lazily finalizes any
        incident whose grace window elapsed."""
        with self._mu:
            ids = list(self._incidents)
        for incident_id in ids:
            self.finalize(incident_id)
        out = []
        with self._mu:
            for incident_id in reversed(ids):
                meta = self._incidents.get(incident_id)
                if meta is None:
                    continue
                entry = {
                    "incident_id": incident_id,
                    "kind": meta["kind"],
                    "opened_ts": meta["opened_ts"],
                    "detail": meta["detail"],
                    "dumps": list(meta["dumps"]),
                    "dir": self.incident_dir(incident_id),
                }
                if meta.get("annotations"):
                    entry["annotations"] = dict(meta["annotations"])
                final = meta.get("final")
                if final:
                    entry.update(
                        {
                            "phase": final["phase"],
                            "culprit_node": final["culprit_node"],
                            "stuck_op": final["stuck_op"],
                            "chaos": final["chaos"],
                            "finalized_ts": final["finalized_ts"],
                        }
                    )
                out.append(entry)
        return out
