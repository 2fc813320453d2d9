"""The port's job dashboard (master/dashboard.py) against the JAX
package's, on the CPU.

Each package assembles a master of its own real components (job context,
perf monitor, rendezvous manager, servicer with its task manager, metric
context, time-series store, shard telemetry, checkpoint coordinator and
peer broker, incident engine, diagnosis manager, stats reporter, event
ring) and feeds it the same script: node and step reports, a dataset
leased and completed, heartbeat digests, a recovery report, an incident.
Every JSON route of the port's ``DashboardServer``, read over HTTP, must
equal the reference's apart from timestamps and host paths, and the HTML
page must be the reference's.  ``python -m dlrover_tpu_torch.master.main
--enable_dashboard --dashboard_port 0`` serves ``/status``, and ``stop()``
leaves no listener behind."""

import json
import os
import re
import socket
import subprocess
import sys
import time
import types
import urllib.request

import pytest

from dlrover_tpu.agent import master_client as jmc
from dlrover_tpu.common import comm as jcomm
from dlrover_tpu.common import constants as jconst
from dlrover_tpu.common import metric as jmetric
from dlrover_tpu.common import node as jnode
from dlrover_tpu.diagnosis import diagnostician as jdiag
from dlrover_tpu.master import dashboard as jdashboard
from dlrover_tpu.master import job_context as jjc
from dlrover_tpu.master import perf_monitor as jperf
from dlrover_tpu.master import rdzv_manager as jrdzv
from dlrover_tpu.master import servicer as jservicer
from dlrover_tpu.master import stats as jstats
from dlrover_tpu.observability import incidents as jincidents
from dlrover_tpu.training_event import emitter as jemitter
from dlrover_tpu_torch.agent import master_client as pmc
from dlrover_tpu_torch.common import comm as pcomm
from dlrover_tpu_torch.common import constants as pconst
from dlrover_tpu_torch.common import metric as pmetric
from dlrover_tpu_torch.common import node as pnode
from dlrover_tpu_torch.diagnosis import diagnostician as pdiag
from dlrover_tpu_torch.master import dashboard as pdashboard
from dlrover_tpu_torch.master import job_context as pjc
from dlrover_tpu_torch.master import perf_monitor as pperf
from dlrover_tpu_torch.master import rdzv_manager as prdzv
from dlrover_tpu_torch.master import servicer as pservicer
from dlrover_tpu_torch.master import stats as pstats
from dlrover_tpu_torch.observability import incidents as pincidents
from dlrover_tpu_torch.training_event import emitter as pemitter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKG = {
    "port": types.SimpleNamespace(
        mc=pmc, comm=pcomm, const=pconst, metric=pmetric, node=pnode,
        diag=pdiag, dashboard=pdashboard, jc=pjc, perf=pperf, rdzv=prdzv,
        servicer=pservicer, stats=pstats, incidents=pincidents,
        emitter=pemitter),
    "ref": types.SimpleNamespace(
        mc=jmc, comm=jcomm, const=jconst, metric=jmetric, node=jnode,
        diag=jdiag, dashboard=jdashboard, jc=jjc, perf=jperf, rdzv=jrdzv,
        servicer=jservicer, stats=jstats, incidents=jincidents,
        emitter=jemitter),
}

ROUTES = ("status", "nodes", "node?id=0", "node?id=99", "rendezvous",
          "datasets", "stats", "events", "diagnosis", "incidents", "ckpt",
          "recovery", "comm", "mem", "compile", "data",
          "timeseries?name=job.&res=1", "timeseries?name=node0.", "brain")

# keys whose values are wall-clock readings (timestamps, ages, rates of
# the host clock, the shard telemetry's measured latencies), ids drawn at
# random, or this host's paths: compared as present, not by value
_VOLATILE = re.compile(
    r"(^|_)(ts|age|time|timestamp|root|dir|path|pid|ms)$|^incident_id$|"
    r"trace_id|span_id|speed|goodput|shards_per_s")


def _normalize(value, key=""):
    if isinstance(value, dict):
        return {k: _normalize(v, k) for k, v in value.items()}
    if isinstance(value, list):
        return [_normalize(v, key) for v in value]
    if isinstance(value, float) and (_VOLATILE.search(key)
                                     or 1e9 < value < 1e10):
        return "<volatile>"  # a keyed reading, or an epoch timestamp
    if isinstance(value, str) and _VOLATILE.search(key):
        return "<volatile>"
    return value


def _master(p, tmp_path, name):
    """A master of ``p``'s real components, fed the script."""
    p.jc.JobContext.reset()
    context = p.jc.get_job_context()
    context.job_name = "dash-job"
    node = p.node.Node(p.const.NodeType.WORKER, 0,
                       status=p.const.NodeStatus.RUNNING)
    node.heartbeat_time = time.time()
    context.update_job_node(node)
    perf = p.perf.PerfMonitor()
    perf.set_worker_num(1)
    now = time.time()
    perf.collect_global_step(10, now - 1)
    perf.collect_global_step(12, now)
    rdzv = p.rdzv.ElasticTrainingRendezvousManager()
    rdzv.update_rdzv_params(min_nodes=1, max_nodes=2, waiting_timeout=1,
                            node_unit=1)
    rdzv.add_alive_node(0)
    diagnosis = p.diag.DiagnosisManager()
    servicer = p.servicer.MasterServicer(
        rdzv_managers={p.const.RendezvousName.TRAINING: rdzv},
        perf_monitor=perf, diagnosis_manager=diagnosis)
    incident_manager = p.incidents.IncidentManager(
        root=str(tmp_path / name / "incidents"))
    servicer.set_incident_manager(incident_manager)
    client = p.mc.LocalMasterClient(servicer, 0)

    # a dataset: one shard completed, one leased
    servicer.task_manager.new_dataset(batch_size=2, dataset_size=20,
                                      dataset_name="train")
    servicer.shard_telemetry.flush()
    task = servicer.task_manager.get_dataset_task(0, "train")
    servicer.task_manager.report_dataset_task("train", task.task_id, True)
    servicer.task_manager.get_dataset_task(0, "train")
    # node metrics and device series
    metric_ctx = servicer.metric_context
    metric_ctx.record_step(0, 12)
    metric_ctx.record_resource(0, 55.0, 2048)

    def chips(duty, used):
        return [p.metric.TpuChipMetric(
            chip_id=i, hbm_used_mb=used, hbm_total_mb=16000.0,
            duty_cycle_pct=duty).to_dict() for i in range(4)]

    metric_ctx.record_device(0, chips(92.0, 8000.0))
    metric_ctx.record_device(1, chips(25.0, 15600.0))
    # heartbeat digests into the store (goodput shares, fabric, memory,
    # compile)
    for i in range(3):
        client.report_heart_beat(digest={
            "step_p50_s": 0.4 + 0.01 * i, "step_max_s": 0.5,
            "last_step": 10.0 + i, "gp_wall": 10.0 * (i + 1),
            "gp_compute": 8.0 * (i + 1), "gp_input_starved": 1.0 * i,
            "fxl_dp": 120.0 + i, "fxb_dp": 1.5,
            "mm_ts": time.time(), "mm_used_b": 1e9 + i,
            "mm_limit_b": 8e9, "mm_peak_b": 2e9,
            "js_ts": time.time(), "js_seq": float(i),
            "js_compile_s": 2.0, "js_hits": 3.0, "js_misses": 1.0,
        })
    client.report_recovery(p.comm.RecoveryReport(
        scope="s", process_id=0, step=6, rung="peer_shm", mttr_s=12.5,
        peer_read_gbps=3.25, bytes_peer=1 << 20))
    incident_manager.open("slow_link", detail="dp link slow",
                          broadcast=False)
    reporter = p.stats.LocalStatsReporter()
    reporter.report({"ts": time.time(), "speed": 1.5, "goodput": 0.9})
    ring = p.emitter.RingExporter()
    p.emitter.Process("master", ring).instant(
        p.emitter.MasterEvents.JOB_START, {"job": "dash-job"})
    return types.SimpleNamespace(
        _job_context=context, perf_monitor=perf,
        rdzv_managers={p.const.RendezvousName.TRAINING: rdzv},
        task_manager=servicer.task_manager, servicer=servicer,
        stats_reporter=reporter, event_ring=ring,
        incident_manager=incident_manager, diagnosis_manager=diagnosis)


def _get(port, route):
    url = f"http://127.0.0.1:{port}/{route}"
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.headers.get("Content-Type"), resp.read()


@pytest.fixture(scope="module")
def pages(tmp_path_factory):
    from dlrover_tpu import chaos as jchaos
    from dlrover_tpu.observability import flight_recorder as jrecorder
    from dlrover_tpu_torch import chaos
    from dlrover_tpu_torch.observability import flight_recorder

    # an incident's evidence is the process's flight recorder: faults an
    # earlier test mirrored there must not land in this one's
    for engine, recorder in ((chaos, flight_recorder),
                             (jchaos, jrecorder)):
        engine.clear()
        recorder.recorder().reset()
    tmp_path = tmp_path_factory.mktemp("dash")
    out = {}
    for name, p in PKG.items():
        master = _master(p, tmp_path, name)
        server = p.dashboard.DashboardServer(master, port=0)
        server.start()
        try:
            out[name] = {route: _get(server.port, route)
                         for route in ROUTES + ("", "metrics")}
        finally:
            server.stop()
        out[name + "_server"] = server
    for p in PKG.values():
        p.jc.JobContext.reset()
    return out


@pytest.mark.parametrize("route", ROUTES)
def test_json_route_matches_the_reference(pages, route):
    ctype, body = pages["port"][route]
    ref_ctype, ref_body = pages["ref"][route]
    assert ctype == ref_ctype == "application/json"
    port, ref = json.loads(body), json.loads(ref_body)
    assert _normalize(port) == _normalize(ref)


def test_routes_carry_the_script(pages):
    status = json.loads(pages["port"]["status"][1])
    assert status["job"] == "dash-job" and status["step"] == 12
    assert status["duty_laggards"] == [1]
    assert status["hbm_pressure"]["1"] == pytest.approx(0.975)
    datasets = json.loads(pages["port"]["datasets"][1])
    assert datasets["train"]["completed"] == 1
    assert datasets["train"]["doing"] == 1
    data = json.loads(pages["port"]["data"][1])
    assert data["summary"]["completions"] == 1
    assert "job.data.backlog" in data["series"]
    recovery = json.loads(pages["port"]["recovery"][1])
    assert recovery["job"]["mttr_s"] == 12.5
    assert recovery["recoveries"][0]["rung"] == "peer_shm"
    incidents = json.loads(pages["port"]["incidents"][1])
    assert [i["kind"] for i in incidents["incidents"]] == ["slow_link"]
    comm = json.loads(pages["port"]["comm"][1])
    assert comm["slow_link_incidents"][0]["kind"] == "slow_link"
    series = json.loads(pages["port"]["timeseries?name=job.&res=1"][1])
    assert "job.share.input_starved" in series["series"]
    assert json.loads(pages["port"]["brain"][1]) == {"enabled": False}
    assert json.loads(pages["port"]["node?id=99"][1]) == {
        "resource": [], "steps": [], "hang": [], "device": [],
        "digests": []}


def test_html_page_is_the_reference(pages):
    ctype, body = pages["port"][""]
    assert ctype == "text/html"
    assert body == pages["ref"][""][1]
    assert b"dlrover-tpu job" in body and b"recovery" in body


def test_metrics_page_serves_the_red_registry(pages):
    ctype, body = pages["port"]["metrics"]
    assert ctype == pages["ref"]["metrics"][0] == "text/plain; version=0.0.4"
    text = body.decode()
    for name in ("dlrover_tpu_goodput", "dlrover_tpu_global_step",
                 "dlrover_tpu_alive_workers", "dlrover_tpu_data_backlog",
                 "dlrover_tpu_data_lease_p99_ms"):
        assert re.search(rf"^{name}(\{{.*\}})? ", text, re.M), name


def test_stop_leaves_no_listener(pages):
    server = pages["port_server"]
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", server.port), timeout=1)
    assert server._thread is None  # noqa: SLF001 - joined


def test_stop_of_a_server_never_started_returns():
    server = pdashboard.DashboardServer(types.SimpleNamespace(), port=0)
    server.stop()
    assert server.data() == {"summary": {}, "series": {}}
    assert server.brain() == {"enabled": False}


def test_master_main_serves_the_dashboard(tmp_path):
    """``--enable_dashboard`` no longer raises: the master logs the
    dashboard's port and serves ``/status`` on it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["DLROVER_TPU_INCIDENT_DIR"] = str(tmp_path / "incidents")
    port_file = tmp_path / "port"
    proc = subprocess.Popen(
        [sys.executable, "-m", "dlrover_tpu_torch.master.main",
         "--platform", "local", "--port", "0", "--service_type", "http",
         "--enable_dashboard", "--dashboard_port", "0",
         "--job_name", "dash-main", "--port_file", str(port_file)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        dash_port = None
        deadline = time.time() + 60
        lines = []
        while dash_port is None and time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            match = re.search(r"dashboard at http://localhost:(\d+)/", line)
            if match:
                dash_port = int(match.group(1))
        assert dash_port, "".join(lines)
        ctype, body = _get(dash_port, "status")
        status = json.loads(body)
        assert ctype == "application/json"
        assert status["job"] == "dash-main"
        assert status["stage"]
        _, body = _get(dash_port, "data")
        assert json.loads(body)["summary"]["backlog"] == 0
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_stats_reporter_keeps_the_reference_records():
    got = []
    for p in PKG.values():
        reporter = p.stats.LocalStatsReporter(max_records=3)
        for i in range(5):
            reporter.report({"ts": float(i), "speed": 0.5 * i})
        got.append(reporter.records())
    assert got[0] == got[1] == [{"ts": float(i), "speed": 0.5 * i}
                                for i in (2, 3, 4)]
