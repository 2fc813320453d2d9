"""The port's incident engine and timeline against the JAX package.

``classify`` gives the reference's verdict on the reference's evidence
dicts; the same dumps give the same ``INCIDENT.json`` verdict keys and the
same spans the same timeline forest; the manager's lifecycle (cooldown,
grace, eviction, the open-incidents gauge) holds; the servicer routes an
agent's ``IncidentDumpReport`` into its incident; the local master builds
the engine, and a hang it fires queues the ``flight_dump`` broadcast
ahead of the restart."""

import json
import os

import pytest

from dlrover_tpu.observability import incidents as jincidents
from dlrover_tpu.observability import timeline as jtimeline
from dlrover_tpu_torch.common.global_context import Context
from dlrover_tpu_torch.master.job_context import JobContext
from dlrover_tpu_torch.observability import (
    flight_recorder,
    incidents,
    metrics,
    timeline,
    trace,
)
from dlrover_tpu_torch.observability.incidents import IncidentManager


@pytest.fixture(autouse=True)
def _isolate(monkeypatch, tmp_path):
    monkeypatch.setenv("DLROVER_TPU_INCIDENT_DIR",
                       str(tmp_path / "incidents"))
    monkeypatch.setenv("DLROVER_TPU_INCIDENT_COOLDOWN_S", "0")
    monkeypatch.setenv("DLROVER_TPU_INCIDENT_GRACE_S", "0")
    from dlrover_tpu.observability import flight_recorder as jrecorder

    rec = flight_recorder.FlightRecorder(attach_log_handler=False)
    monkeypatch.setattr(flight_recorder, "_RECORDER", rec)
    # the reference's master dump reads its own process recorder: a fresh
    # one, so both packages' dumps hold this test's spans only
    monkeypatch.setattr(jrecorder, "_RECORDER",
                        jrecorder.FlightRecorder(attach_log_handler=False))
    metrics.registry().reset()
    trace.seed_ids(55)
    JobContext.reset()
    Context.reset()
    yield rec
    trace.seed_ids(0)
    metrics.registry().reset()
    JobContext.reset()


# the evidence of the reference's classification cases
# (tests/test_incidents.py TestClassify)
EVIDENCE = {
    "phase_hint_outranks_all_evidence": dict(
        kind="hang", phase_hint="collective",
        chaos_records=[{"point": "storage.write", "kind": "delay"}],
        dumps={"node_0": {"open_spans": [
            {"name": "kv.wait/x", "open_for_s": 9.0}]}},
    ),
    "dominant_fault_wins_and_attribution_counted": dict(
        chaos_records=(
            [{"point": "storage.write", "kind": "delay",
              "span_id": "ab"}] * 3
            + [{"point": "rdzv.join", "kind": "flap"}]
        ),
    ),
    "open_span_fallback_names_phase_and_culprit": dict(dumps={
        "node_2": {"open_spans": [
            {"name": "rdzv.join/training", "open_for_s": 42.0}]},
    }),
    "culprit_dump_outranks_longer_peer_span": dict(culprit=1, dumps={
        "node_0": {"open_spans": [
            {"name": "kv.wait/heartbeat-loop", "open_for_s": 500.0}]},
        "node_1": {"open_spans": [
            {"name": "flash.save", "open_for_s": 5.0}]},
    }),
    "chaos_evidence_harvested_from_dump_rings": dict(dumps={
        "node_0": {"events": [
            {"type": "CHAOS", "point": "agent.heartbeat", "kind": "drop"},
            {"type": "INSTANT", "name": "not-chaos"},
        ]},
    }),
    "no_evidence_is_unknown": dict(detail="manual capture"),
}
for _point in ("master_client.transport", "kv_store.wait", "kv_server.get",
               "rdzv.join", "agent.heartbeat", "servicer.admission",
               "snapshot.stream_chunk", "storage.write_chunk", "flash.save",
               "unified_rpc.call", "ckpt.phase1_report", "peer.serve",
               "mem.pressure", "comm.axis_delay.dp", "jitscope.compile",
               "data.lease"):
    EVIDENCE[f"chaos_point:{_point}"] = dict(
        chaos_records=[{"point": _point, "kind": "exception"}])


@pytest.mark.parametrize("case", sorted(EVIDENCE))
def test_classify_matches_reference(case):
    got = incidents.classify(**EVIDENCE[case])
    assert got == jincidents.classify(**EVIDENCE[case])
    assert got["phase"]


def test_phase_tables_are_the_reference_tables():
    assert incidents.PHASE_BY_POINT == jincidents.PHASE_BY_POINT
    assert incidents.PHASE_BY_SPAN == jincidents.PHASE_BY_SPAN


VERDICT_KEYS = ("kind", "phase", "culprit_node", "stuck_op", "stuck_for_s",
                "chaos", "detail", "dumps", "timeline")

DUMPS = {
    3: {"role": "agent", "pid": 11,
        "open_spans": [{"name": "kv.wait/barrier", "open_for_s": 33.0}],
        "events": [{"type": "CHAOS", "point": "kv_store.wait",
                    "kind": "drop", "span_id": "s1", "ts": 2.0}],
        "spans": [
            {"type": "SPAN", "name": "kv.wait", "trace_id": "t1",
             "span_id": "s1", "parent_span_id": "", "ts": 1.0, "dur": 3.0,
             "events": [{"name": "chaos.fault", "ts": 2.0,
                         "attrs": {"seq": 0}}]},
            {"type": "SPAN", "name": "rpc.attempt/KeyValuePair",
             "trace_id": "t1", "span_id": "s2", "parent_span_id": "s1",
             "ts": 1.5, "dur": 0.5},
        ]},
    5: {"role": "agent", "pid": 12,
        "spans": [{"type": "SPAN", "name": "flash.save", "trace_id": "t2",
                   "span_id": "s9", "parent_span_id": "gone", "ts": 1.2,
                   "dur": 0.1}]},
}


@pytest.mark.parametrize("culprit", [-1, 5])
def test_same_dumps_give_the_same_incident_verdict(tmp_path, monkeypatch,
                                                   culprit):
    out = []
    for mod in (incidents, jincidents):
        monkeypatch.setenv("DLROVER_TPU_INCIDENT_DIR",
                           str(tmp_path / mod.__name__))
        manager = mod.IncidentManager()
        incident_id = manager.open("hang", detail="d", culprit=culprit,
                                   broadcast=False)
        for node, dump in DUMPS.items():
            assert manager.add_dump(incident_id, node, json.dumps(dump))
        incident = manager.finalize(incident_id, force=True,
                                    chaos_records=[])
        path = os.path.join(manager.incident_dir(incident_id),
                            "INCIDENT.json")
        with open(path) as f:
            on_disk = json.load(f)
        assert set(on_disk) == set(incident)
        verdict = {k: on_disk[k] for k in VERDICT_KEYS}
        # the master's own dump holds this process's live spans: count
        # only the agents' part of the timeline
        verdict["timeline"] = {k: v for k, v in verdict["timeline"].items()
                               if k in ("orphan_spans",)}
        out.append(verdict)
    assert out[0] == out[1]
    # the dominant chaos fault names the phase whoever the culprit is
    assert out[0]["phase"] == "kv"
    assert out[0]["stuck_op"] == "kv.wait/barrier"
    assert out[0]["timeline"]["orphan_spans"] == 1


def _span_files(tmp_path):
    records = [
        {"type": "SPAN", "target": "agent", "pid": 1, "name": "rpc.report",
         "trace_id": "t1", "span_id": "a", "parent_span_id": "", "ts": 1.0,
         "dur": 2.0, "attrs": {"node_id": 0},
         "events": [{"name": "chaos.fault", "ts": 1.5,
                     "attrs": {"seq": 0, "point": "x"}}]},
        {"type": "SPAN", "target": "master", "pid": 2, "name": "master.report",
         "trace_id": "t1", "span_id": "b", "parent_span_id": "a", "ts": 1.2,
         "dur": 0.5},
        {"type": "SPAN", "target": "master", "pid": 2, "name": "kv_server.get",
         "trace_id": "t1", "span_id": "c", "parent_span_id": "b", "ts": 1.3,
         "dur": 0.1},
        {"type": "SPAN", "target": "agent", "pid": 1, "name": "orphan",
         "trace_id": "t2", "span_id": "d", "parent_span_id": "zz", "ts": 3.0,
         "dur": 0.1},
        {"type": "BEGIN", "target": "agent", "pid": 1, "name": "save",
         "span": 7, "ts": 0.5},
        {"type": "END", "target": "agent", "pid": 1, "name": "save",
         "span": 7, "ts": 0.9},
        {"type": "BEGIN", "target": "agent", "pid": 1, "name": "stuck",
         "span": 8, "ts": 4.0},
        {"type": "INSTANT", "target": "master", "pid": 2, "name": "ping",
         "ts": 0.1},
    ]
    events = tmp_path / "events.jsonl"
    events.write_text("".join(json.dumps(r) + "\n" for r in records))
    chaos_file = tmp_path / "chaos.jsonl"
    chaos_file.write_text(
        json.dumps({"seq": 0, "point": "x", "kind": "drop", "call": 0,
                    "trace_id": "t1", "span_id": "a"}) + "\n"
        + json.dumps({"seq": 1, "point": "y", "kind": "drop", "call": 0,
                      "trace_id": "", "span_id": ""}) + "\n")
    counters = tmp_path / "counters.jsonl"
    counters.write_text(json.dumps({"name": "job.goodput", "ts": 1.0,
                                    "value": 0.5}) + "\n")
    return [str(events)], [str(chaos_file)], [str(counters)]


def test_same_spans_give_the_same_timeline_forest(tmp_path):
    events, chaos_files, counters = _span_files(tmp_path)
    got = timeline.assemble(event_files=events, chaos_files=chaos_files,
                            counter_files=counters)
    want = jtimeline.assemble(event_files=events, chaos_files=chaos_files,
                              counter_files=counters)
    assert got == want
    forest = got["summary"]["span_forest"]
    assert forest["t1"]["connected"] and not forest["t2"]["connected"]
    assert got["summary"]["flows"] == 1
    assert got["summary"]["chaos_attributed"] == 1


def test_timeline_cli_writes_the_merged_file(tmp_path, capsys):
    events, chaos_files, _ = _span_files(tmp_path)
    out = tmp_path / "merged.json"
    assert timeline.main(["--events", *events, "--chaos", *chaos_files,
                          "-o", str(out), "--summary"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["spans"] == 4
    assert json.loads(out.read_text())["traceEvents"]


class TestLifecycle:
    def test_open_creates_dir_meta_and_master_dump(self):
        manager = IncidentManager()
        incident_id = manager.open("hang", detail="d", broadcast=False)
        path = manager.incident_dir(incident_id)
        with open(os.path.join(path, "meta.json")) as f:
            assert json.load(f)["kind"] == "hang"
        with open(os.path.join(path, "dump_master.json")) as f:
            dump = json.load(f)
        assert {"spans", "events", "open_spans", "stacks",
                "metrics"} <= set(dump)

    def test_cooldown_joins_repeat_detections(self, monkeypatch):
        monkeypatch.setenv("DLROVER_TPU_INCIDENT_COOLDOWN_S", "300")
        manager = IncidentManager()
        first = manager.open("hang", broadcast=False)
        assert manager.open("hang", broadcast=False) == first
        assert manager.open("ckpt_stall", broadcast=False) != first

    def test_finalize_waits_for_expected_dumps_within_grace(
            self, monkeypatch):
        monkeypatch.setenv("DLROVER_TPU_INCIDENT_GRACE_S", "600")
        manager = IncidentManager()
        incident_id = manager.open("hang", broadcast=False)
        with manager._mu:
            manager._incidents[incident_id]["expected_dumps"] = 2
        assert manager.finalize(incident_id) is None
        manager.add_dump(incident_id, 0, "{}")
        manager.add_dump(incident_id, 1, "{}")
        assert manager.finalize(incident_id) is not None

    def test_grace_elapsed_finalizes_with_partial_evidence(self):
        manager = IncidentManager()
        incident_id = manager.open("hang", broadcast=False)
        with manager._mu:
            manager._incidents[incident_id]["expected_dumps"] = 5
        assert manager.finalize(incident_id) is not None

    def test_eviction_bounds_disk(self, monkeypatch):
        monkeypatch.setenv("DLROVER_TPU_INCIDENT_MAX", "2")
        manager = IncidentManager()
        ids = [manager.open(f"kind_{i}", broadcast=False) for i in range(4)]
        kept = manager.list_incidents()
        assert {i["incident_id"] for i in kept} == set(ids[2:])
        for old in ids[:2]:
            assert not os.path.exists(manager.incident_dir(old))

    def test_open_incidents_gauge(self, monkeypatch):
        monkeypatch.setenv("DLROVER_TPU_INCIDENT_GRACE_S", "600")
        manager = IncidentManager()
        manager.open("hang", broadcast=False)
        with manager._mu:
            for meta in manager._incidents.values():
                meta["expected_dumps"] = 9
        reg = metrics.registry()
        assert reg.gauge_value("dlrover_tpu_incidents_open") == 1.0
        assert reg.counter_total("dlrover_tpu_incidents_total") == 1.0

    def test_unknown_incident_and_bad_payload_are_refused(self):
        manager = IncidentManager()
        assert not manager.add_dump("nope", 0, "{}")
        incident_id = manager.open("hang", broadcast=False)
        assert not manager.add_dump(incident_id, 0, "not json{")

    def test_annotate_rides_the_listing(self):
        manager = IncidentManager()
        incident_id = manager.open("hang", broadcast=False)
        assert manager.annotate(incident_id, "brain", {"ride_out": True})
        assert manager.list_incidents()[0]["annotations"] == {
            "brain": {"ride_out": True}}

    def test_set_timeseries_is_kept_unset(self):
        manager = IncidentManager()
        assert manager._timeseries is None
        manager.set_timeseries(None)
        incident_id = manager.open("hbm_oom", culprit=0, phase_hint="mem",
                                   broadcast=False)
        incident = manager.finalize(incident_id, force=True)
        assert incident["mem"] == {"series": {}, "forecast_breached": False}


def _client_and_servicer(manager, node_id=0):
    from dlrover_tpu_torch.agent.master_client import LocalMasterClient
    from dlrover_tpu_torch.master.servicer import MasterServicer

    servicer = MasterServicer(incident_manager=manager)
    return LocalMasterClient(servicer, node_id=node_id), servicer


def test_servicer_routes_an_agent_dump_into_its_incident():
    manager = IncidentManager()
    incident_id = manager.open("hang", broadcast=False)
    client, _ = _client_and_servicer(manager, node_id=3)
    snap = flight_recorder.recorder().snapshot()
    assert client.report_incident_dump(incident_id, json.dumps(snap))
    path = os.path.join(manager.incident_dir(incident_id), "dump_node_3.json")
    assert os.path.exists(path)
    incident = manager.finalize(incident_id, force=True)
    assert "node_3" in incident["dumps"]


def test_the_agent_answers_a_flight_dump_action():
    from dlrover_tpu_torch.agent.elastic_agent import (
        ElasticAgent,
        ElasticLaunchConfig,
    )
    from dlrover_tpu_torch.diagnosis.diagnosis_action import (
        FlightDumpAction,
    )

    manager = IncidentManager()
    incident_id = manager.open("hang", broadcast=False)
    client, _ = _client_and_servicer(manager, node_id=2)
    agent = ElasticAgent(client, ElasticLaunchConfig())
    agent._handle_flight_dump(FlightDumpAction(incident_id).to_dict())
    assert os.path.exists(os.path.join(manager.incident_dir(incident_id),
                                       "dump_node_2.json"))


def test_local_master_builds_the_incident_engine():
    from dlrover_tpu_torch.master.local_master import LocalJobMaster

    master = LocalJobMaster(port=0, node_num=1)
    try:
        assert isinstance(master.incident_manager, IncidentManager)
        assert master.diagnosis_manager._incident_manager is \
            master.incident_manager
        assert master.servicer._incident_manager is master.incident_manager
    finally:
        master.stop()


def test_a_fired_hang_broadcasts_the_dump_before_the_restart(monkeypatch):
    import time

    from dlrover_tpu_torch.master.local_master import LocalJobMaster

    monkeypatch.setenv("DLROVER_TPU_HANG_DETECTION", "1")
    monkeypatch.setenv("DLROVER_TPU_HANG_DOWNTIME", "1")
    Context.reset()
    master = LocalJobMaster(port=0, node_num=1)
    try:
        master.perf_monitor.collect_global_step(5, time.time() - 30)
        actions = master.diagnosis_manager.diagnose_once()
        assert [a.action_type for a in actions] == ["restart_worker"]
        queued = [b["action"] for b in
                  master._job_context.pending_action_summary()["broadcasts"]]
        assert [a["action"] for a in queued] == [
            "flight_dump", "restart_worker"]
        incident_id = queued[0]["extra"]["incident_id"]
        incident = master.incident_manager.finalize(incident_id, force=True)
        assert incident["kind"] == "hang"
        assert os.path.exists(os.path.join(
            master.incident_manager.incident_dir(incident_id),
            "INCIDENT.json"))
    finally:
        master.stop()


def test_an_hbm_oom_failure_report_opens_its_incident():
    from dlrover_tpu_torch.common import comm
    from dlrover_tpu_torch.diagnosis.diagnostician import DiagnosisManager

    manager = IncidentManager()
    diagnosis = DiagnosisManager(sink=lambda action: None)
    diagnosis.set_incident_manager(manager)
    diagnosis.report_failure(comm.NodeFailureRequest(
        node_id=4, error_data="worker died: signature=hbm_oom"))
    listed = manager.list_incidents()
    assert [i["kind"] for i in listed] == ["hbm_oom"]
    assert listed[0]["phase"] == "mem" and listed[0]["culprit_node"] == 4
