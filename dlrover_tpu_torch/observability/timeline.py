"""Timeline assembler: ONE merged Perfetto file for the whole job.

Copy of ``dlrover_tpu/observability/timeline.py`` (stdlib only): the
incident engine merges its flight dumps through :func:`assemble`, and the
CLI merges per-process span/event files by hand.

Joins the per-process observability artifacts —

* training-event / span JSONL files (``events_<pid>.jsonl``, now
  carrying ``SPAN`` records and trace-id stamps, see
  ``training_event/emitter.py`` and ``observability/trace.py``),
* per-process timer Chrome traces (``timer.dump_timeline``),
* the chaos fault-trace JSONL (``DLROVER_TPU_CHAOS_TRACE_FILE``),

into a single Chrome-trace JSON (open in Perfetto / chrome://tracing)
where every process is a lane on a shared wall clock and **flow arrows
follow trace ids across processes**: a client RPC span in the agent
lane points at the server span it caused in the master lane, so "why
was step 4812 slow" is one connected picture instead of N uncorrelated
files.

Chaos entries are placed by *attribution*: a fault record carrying a
``span_id`` lands as an instant inside that span's slice (timestamped
by the matching ``chaos.fault`` event the engine attached to the live
span); unattributed faults fall into a dedicated ``chaos`` lane so they
are never silently dropped.

Usage::

    python -m dlrover_tpu_torch.observability.timeline \
        --events /tmp/dlrover_tpu/events/events_*.jsonl \
        --timer /tmp/timeline_*.json \
        --chaos /tmp/chaos_trace.jsonl \
        -o merged_timeline.json

Output is deterministic for identical inputs (stable sorting + sorted
JSON keys), so a seeded drill produces a byte-stable timeline.
"""

import argparse
import json
import sys
from typing import Any, Dict, Iterable, List, Optional, Tuple

_US = 1e6


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                continue  # half-written tail of a live file
    return records


def span_forest(span_records: Iterable[Dict[str, Any]]) -> Dict[str, Dict]:
    """Group SPAN records into per-trace trees.

    Returns ``{trace_id: {"spans": n, "roots": [span_id...],
    "orphans": [span_id...], "connected": bool}}`` where an *orphan*
    has a parent_span_id that matches no span in the same trace (a lost
    file, a crashed process) and *connected* means every span is
    reachable from a root.
    """
    by_trace: Dict[str, Dict[str, Dict]] = {}
    for record in span_records:
        if record.get("type") != "SPAN":
            continue
        trace_id = record.get("trace_id", "")
        span_id = record.get("span_id", "")
        if not trace_id or not span_id:
            continue
        by_trace.setdefault(trace_id, {})[span_id] = record
    out: Dict[str, Dict] = {}
    for trace_id, spans in by_trace.items():
        roots, orphans = [], []
        children: Dict[str, List[str]] = {}
        for span_id, record in spans.items():
            parent = record.get("parent_span_id", "")
            if not parent:
                roots.append(span_id)
            elif parent in spans:
                children.setdefault(parent, []).append(span_id)
            else:
                orphans.append(span_id)
        reachable = set()
        stack = list(roots)
        while stack:
            span_id = stack.pop()
            if span_id in reachable:
                continue
            reachable.add(span_id)
            stack.extend(children.get(span_id, []))
        out[trace_id] = {
            "spans": len(spans),
            "roots": sorted(roots),
            "orphans": sorted(orphans),
            "connected": bool(roots) and len(reachable) == len(spans),
        }
    return out


class _Lanes:
    """Deterministic (target, pid) -> chrome pid mapping with
    process_name metadata."""

    def __init__(self):
        self._lanes: Dict[Tuple[str, int], int] = {}
        self.metadata: List[Dict[str, Any]] = []

    def lane(self, target: str, pid: int) -> int:
        key = (target, pid)
        if key not in self._lanes:
            self._lanes[key] = len(self._lanes)
            self.metadata.append(
                {
                    "name": "process_name", "ph": "M",
                    "pid": self._lanes[key],
                    "args": {"name": f"{target}:{pid}"},
                }
            )
        return self._lanes[key]


def assemble(
    event_files: Iterable[str] = (),
    timer_files: Iterable[str] = (),
    chaos_files: Iterable[str] = (),
    counter_files: Iterable[str] = (),
) -> Dict[str, Any]:
    """Join the artifacts; returns ``{"traceEvents": [...],
    "summary": {...}}`` (the summary key is dropped on --output for
    strict chrome-trace readers when empty)."""
    records: List[Dict[str, Any]] = []
    for path in sorted(event_files):
        records.extend(read_jsonl(path))
    # deterministic processing order regardless of file interleaving
    records.sort(
        key=lambda r: (
            r.get("ts", 0.0), str(r.get("target", "")), r.get("pid", 0),
            str(r.get("name", "")),
        )
    )
    lanes = _Lanes()
    trace: List[Dict[str, Any]] = []
    span_records: List[Dict[str, Any]] = []
    # span_id -> (lane, record) for flow arrows + chaos attribution
    span_index: Dict[str, Tuple[int, Dict[str, Any]]] = {}
    open_spans: Dict[Tuple[int, str], Tuple[str, float, Dict]] = {}

    for record in records:
        target = str(record.get("target", "?"))
        pid = int(record.get("pid", 0) or 0)
        lane = lanes.lane(target, pid)
        ts_us = float(record.get("ts", 0.0)) * _US
        kind = record.get("type")
        name = str(record.get("name", "?"))
        if kind == "SPAN":
            span_records.append(record)
            span_id = record.get("span_id", "")
            if span_id:
                span_index[span_id] = (lane, record)
            args = {
                "trace_id": record.get("trace_id", ""),
                "span_id": span_id,
                "parent_span_id": record.get("parent_span_id", ""),
                "kind": record.get("kind", ""),
                "status": record.get("status", ""),
                **(record.get("attrs") or {}),
            }
            if record.get("error"):
                args["error"] = record["error"]
            trace.append(
                {
                    "name": name, "ph": "X", "ts": ts_us,
                    "dur": max(0.0, float(record.get("dur", 0.0)) * _US),
                    "pid": lane, "tid": 0, "cat": "span", "args": args,
                }
            )
            for event in record.get("events") or []:
                trace.append(
                    {
                        "name": str(event.get("name", "event")),
                        "ph": "i",
                        "ts": float(event.get("ts", record.get("ts", 0.0)))
                        * _US,
                        "pid": lane, "tid": 0, "s": "t",
                        "cat": "span_event",
                        "args": {
                            "span_id": span_id,
                            **(event.get("attrs") or {}),
                        },
                    }
                )
        elif kind == "BEGIN":
            open_spans[(lane, record.get("span"))] = (name, ts_us, record)
        elif kind == "END":
            begun = open_spans.pop((lane, record.get("span")), None)
            if begun is None:
                continue
            bname, bts, brecord = begun
            trace.append(
                {
                    "name": bname, "ph": "X", "ts": bts,
                    "dur": max(0.0, ts_us - bts), "pid": lane, "tid": 1,
                    "cat": "event",
                    "args": {**(brecord.get("content") or {}),
                             **(record.get("content") or {})},
                }
            )
        else:  # INSTANT
            trace.append(
                {
                    "name": name, "ph": "i", "ts": ts_us, "pid": lane,
                    "tid": 1, "s": "p", "cat": "event",
                    "args": record.get("content") or {},
                }
            )
    # duration spans left open (crash/hang) are the interesting ones
    for (lane, _), (name, ts_us, brecord) in sorted(
        open_spans.items(), key=lambda kv: (kv[0][0], kv[1][1], kv[1][0])
    ):
        trace.append(
            {
                "name": f"{name} (never ended)", "ph": "i", "ts": ts_us,
                "pid": lane, "tid": 1, "s": "p", "cat": "event",
                "args": brecord.get("content") or {},
            }
        )

    # -- flow arrows: child span in one process, parent in another ----------
    flows = 0
    for span_id, (lane, record) in sorted(span_index.items()):
        parent_id = record.get("parent_span_id", "")
        parent = span_index.get(parent_id)
        if parent is None:
            continue
        parent_lane, parent_record = parent
        if parent_lane == lane:
            continue  # same-process parentage is visible as nesting
        child_ts = float(record.get("ts", 0.0)) * _US
        parent_ts = float(parent_record.get("ts", 0.0)) * _US
        parent_end = parent_ts + float(parent_record.get("dur", 0.0)) * _US
        # the flow must START inside the parent slice to bind to it
        start_ts = min(max(child_ts, parent_ts), parent_end)
        common = {"cat": "trace", "id": span_id, "name": "trace"}
        trace.append(
            {**common, "ph": "s", "ts": start_ts, "pid": parent_lane,
             "tid": 0}
        )
        trace.append(
            {**common, "ph": "f", "bp": "e", "ts": child_ts, "pid": lane,
             "tid": 0}
        )
        flows += 1

    # -- timer chrome traces: one extra lane per dump -----------------------
    for path in sorted(timer_files):
        with open(path) as f:
            timer_trace = json.load(f)
        label = path.rsplit("/", 1)[-1]
        lane = lanes.lane("timer", len(lanes.metadata))
        lanes.metadata[-1]["args"]["name"] = f"timer:{label}"
        for event in timer_trace.get("traceEvents", []):
            event = dict(event)
            event["pid"] = lane
            trace.append(event)

    # -- chaos trace: attribute to spans where possible ---------------------
    chaos_total = chaos_attributed = 0
    chaos_lane: Optional[int] = None
    for path in sorted(chaos_files):
        for record in read_jsonl(path):
            chaos_total += 1
            span_id = record.get("span_id", "")
            owner = span_index.get(span_id) if span_id else None
            args = {
                "point": record.get("point", ""),
                "kind": record.get("kind", ""),
                "seq": record.get("seq", -1),
                "call": record.get("call", -1),
                "trace_id": record.get("trace_id", ""),
                "span_id": span_id,
            }
            if owner is not None:
                lane, span_record = owner
                chaos_attributed += 1
                # timestamp from the chaos.fault event the engine put on
                # the live span (joined by global fire seq)
                ts = None
                for event in span_record.get("events") or []:
                    if (
                        event.get("name") == "chaos.fault"
                        and (event.get("attrs") or {}).get("seq")
                        == record.get("seq")
                    ):
                        ts = float(event["ts"]) * _US
                        break
                if ts is None:
                    ts = float(span_record.get("ts", 0.0)) * _US
                trace.append(
                    {
                        "name": f"chaos:{record.get('point', '?')}",
                        "ph": "i", "ts": ts, "pid": lane, "tid": 0,
                        "s": "t", "cat": "chaos", "args": args,
                    }
                )
            else:
                if chaos_lane is None:
                    chaos_lane = lanes.lane("chaos", 0)
                # no wall clock in the chaos record: order by fire seq
                trace.append(
                    {
                        "name": f"chaos:{record.get('point', '?')}",
                        "ph": "i",
                        "ts": float(record.get("seq", 0)),
                        "pid": chaos_lane, "tid": 0, "s": "p",
                        "cat": "chaos", "args": args,
                    }
                )

    # -- counter tracks (master time-series exports): each series is a
    # Perfetto "C" counter in a dedicated lane, so incidents/faults land
    # visually ON the goodput / step-time curve ------------------------------
    counters = 0
    counter_lane: Optional[int] = None
    for path in sorted(counter_files):
        for record in read_jsonl(path):
            name = str(record.get("name", ""))
            if not name or "value" not in record:
                continue
            if counter_lane is None:
                counter_lane = lanes.lane("counters", 0)
            counters += 1
            trace.append(
                {
                    "name": name, "ph": "C",
                    "ts": float(record.get("ts", 0.0)) * _US,
                    "pid": counter_lane, "tid": 0, "cat": "counter",
                    "args": {"value": float(record["value"])},
                }
            )

    trace.sort(
        key=lambda e: (
            e.get("ts", 0.0), e.get("pid", 0), e.get("tid", 0),
            str(e.get("ph", "")), str(e.get("name", "")),
        )
    )
    forest = span_forest(span_records)
    return {
        "traceEvents": lanes.metadata + trace,
        "summary": {
            "lanes": len(lanes.metadata),
            "spans": len(span_records),
            "traces": len(forest),
            "connected_traces": sum(
                1 for t in forest.values() if t["connected"]
            ),
            "flows": flows,
            "chaos_faults": chaos_total,
            "chaos_attributed": chaos_attributed,
            "counters": counters,
            "span_forest": forest,
        },
    }


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        "python -m dlrover_tpu_torch.observability.timeline",
        description="merge per-process events/spans + timer traces + "
        "chaos traces into one Perfetto timeline",
    )
    parser.add_argument(
        "--events", nargs="*", default=[],
        help="training-event/span JSONL files (events_<pid>.jsonl)",
    )
    parser.add_argument(
        "--timer", nargs="*", default=[],
        help="timer Chrome-trace JSON dumps",
    )
    parser.add_argument(
        "--chaos", nargs="*", default=[],
        help="chaos fault-trace JSONL files",
    )
    parser.add_argument(
        "--counters", nargs="*", default=[],
        help="counter-track JSONL files ({ts,name,value} records, e.g. "
        "the master time-series export) rendered as Perfetto counters",
    )
    parser.add_argument("-o", "--output", default="merged_timeline.json")
    parser.add_argument(
        "--summary", action="store_true",
        help="print the join summary as JSON on stdout",
    )
    args = parser.parse_args(argv)
    if not (args.events or args.timer or args.chaos or args.counters):
        parser.error(
            "nothing to merge: pass --events/--timer/--chaos/--counters"
        )
    merged = assemble(
        event_files=args.events, timer_files=args.timer,
        chaos_files=args.chaos, counter_files=args.counters,
    )
    summary = merged.pop("summary")
    with open(args.output, "w") as f:
        json.dump(merged, f, sort_keys=True)
    if args.summary:
        print(json.dumps(summary, sort_keys=True))
    else:
        print(
            f"merged {summary['lanes']} lane(s), {summary['spans']} "
            f"span(s) across {summary['traces']} trace(s) "
            f"({summary['connected_traces']} connected), "
            f"{summary['flows']} cross-process flow(s), "
            f"{summary['chaos_attributed']}/{summary['chaos_faults']} "
            f"chaos fault(s) attributed -> {args.output}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
