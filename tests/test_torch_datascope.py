"""The port's datascope against the JAX package's, on the CPU.

The cases of ``tests/test_datascope.py`` run on the port, each beside the
JAX package on the same script: the shard telemetry's summary and
percentiles, its series flushed under a patched clock, its gauges; the
task manager's hooks (lease, complete, backlog, the queue/service split of
a long-poll, a dropped lease), exactly-once completion under worker
churn; the sharding client's ``data.fetch``/``data.consume`` spans, the
scope's wait/process counters, the ``input_starved`` charge and the kill
switch; the long-poll's exclusion from the RPC duration histogram; the two
data sentinels on the same series; the servicer's wiring (telemetry,
pull gauges) and the dashboard's ``/data``."""

import threading
import time
import types

import pytest

from dlrover_tpu import chaos as jchaos
from dlrover_tpu.agent import master_client as jmc
from dlrover_tpu.agent import sharding as jsharding
from dlrover_tpu.master import dashboard as jdashboard
from dlrover_tpu.master import servicer as jservicer
from dlrover_tpu.master import task_manager as jtm
from dlrover_tpu.master import timeseries as jts
from dlrover_tpu.observability import datascope as jdatascope
from dlrover_tpu.observability import goodput as jgoodput
from dlrover_tpu.observability import metrics as jmetrics
from dlrover_tpu.observability import sentinel as jsentinel
from dlrover_tpu.observability import trace as jtrace
from dlrover_tpu_torch import chaos
from dlrover_tpu_torch.agent import master_client as pmc
from dlrover_tpu_torch.agent import sharding as psharding
from dlrover_tpu_torch.diagnosis.diagnostician import DiagnosisManager
from dlrover_tpu_torch.master import dashboard
from dlrover_tpu_torch.master import servicer as pservicer
from dlrover_tpu_torch.master import task_manager as tm
from dlrover_tpu_torch.master import timeseries as ts
from dlrover_tpu_torch.observability import datascope, goodput, metrics
from dlrover_tpu_torch.observability import sentinel, trace

PKG = {
    "port": types.SimpleNamespace(
        chaos=chaos, mc=pmc, sharding=psharding, dashboard=dashboard,
        servicer=pservicer, tm=tm, ts=ts, datascope=datascope,
        goodput=goodput, metrics=metrics, sentinel=sentinel, trace=trace),
    "ref": types.SimpleNamespace(
        chaos=jchaos, mc=jmc, sharding=jsharding, dashboard=jdashboard,
        servicer=jservicer, tm=jtm, ts=jts, datascope=jdatascope,
        goodput=jgoodput, metrics=jmetrics, sentinel=jsentinel,
        trace=jtrace),
}


def _both(fn):
    """``fn`` on each package: (port's result, reference's result)."""
    return fn(PKG["port"]), fn(PKG["ref"])


@pytest.fixture()
def _isolate():
    records = {name: [] for name in PKG}
    for name, p in PKG.items():
        p.trace.set_span_sink(records[name].append)
        p.trace.seed_ids(1234)
        p.datascope.reset_scope()
        p.goodput.reset_ledger()
    yield records
    for p in PKG.values():
        p.trace.set_span_sink(None)
        p.trace.seed_ids(0)
        p.chaos.clear()
        p.datascope.reset_scope()
        p.goodput.reset_ledger()


def _new_dataset(manager, name="ds", size=4, num_epochs=1):
    manager.new_dataset(
        batch_size=1, dataset_size=size, dataset_name=name,
        num_epochs=num_epochs, num_minibatches_per_shard=1,
    )


class _Recorder:
    """Telemetry hook recorder for the task-manager wiring; the measured
    seconds are kept as whether they are positive."""

    def __init__(self):
        self.leases = []
        self.completes = []
        self.backlogs = []

    def on_lease(self, dataset, count, queue_wait_s, service_s,
                 backlog, epoch):
        self.leases.append((dataset, count, queue_wait_s > 0,
                            service_s >= 0, backlog, epoch))

    def on_complete(self, dataset, latency_s, backlog, epoch):
        self.completes.append((dataset, latency_s >= 0, backlog, epoch))

    def on_backlog(self, dataset, backlog, epoch):
        self.backlogs.append((dataset, backlog, epoch))


class _Clock:
    """A patched ``time.time`` for both packages' datascope."""

    def __init__(self, monkeypatch, t0=1_700_000_000.0):
        self.t = t0
        for p in PKG.values():
            monkeypatch.setattr(p.datascope.time, "time", self.now)

    def now(self):
        return self.t


# -- ShardTelemetry -----------------------------------------------------------


def test_summary_counts_and_percentiles_match():
    def run(p):
        t = p.datascope.ShardTelemetry(None)
        for service_ms in (1.0, 2.0, 100.0, 7.5, 0.25):
            t.on_lease("ds", 1, 0.0, service_ms / 1000.0, 5, 1)
        t.on_lease("other", 2, 0.02, 0.003, 9, 2)
        t.on_complete("ds", 0.25, 4, 1)
        t.on_complete("ds", 0.35, 3, 1)
        t.on_backlog("other", 7, 2)
        return t.summary(), t.gauges()

    port, ref = _both(run)
    assert port == ref
    summary = port[0]
    assert summary["leases"] == 6 and summary["completions"] == 2
    assert summary["backlog"] == 10 and summary["peak_backlog"] == 9
    assert summary["lease_p99_ms"] == pytest.approx(100.0, rel=0.01)
    assert summary["datasets"]["ds"]["complete_p99_ms"] == pytest.approx(
        350.0, rel=0.01)


def test_flush_writes_the_same_series(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_DATA_FLUSH_S", "5")
    clock = _Clock(monkeypatch)

    def run(p):
        clock.t = 1_700_000_000.0
        store = p.ts.TimeSeriesStore()
        t = p.datascope.ShardTelemetry(store)
        script = [("lease", "train", 2, 0.01, 0.05, 7, 1),
                  ("complete", "train", 0.4, 6, 1),
                  ("lease", "eval", 1, 0.0, 0.002, 3, 1),
                  ("complete", "train", 0.5, 5, 1),
                  ("backlog", "eval", 2, 2),
                  ("complete", "eval", 0.1, 1, 2)]
        for i, step in enumerate(script):
            clock.t += 2.0  # every other hook crosses the flush period
            getattr(t, "on_" + step[0])(*step[1:])
        clock.t += 1.0
        t.flush()
        return store.snapshot(res=1.0), t.summary()

    port, ref = _both(run)
    assert port == ref
    series = port[0]["series"]
    assert {"job.data.backlog", "job.data.lease_p99_ms",
            "job.data.queue_p99_ms", "job.data.shards_per_s",
            "data.train.backlog", "data.eval.epoch"} <= set(series)
    assert max(pt["max"] for pt in series["job.data.shards_per_s"]) > 0


def test_broken_store_never_raises():
    class _Broken:
        def add(self, *a, **k):
            raise RuntimeError("store down")

    def run(p):
        t = p.datascope.ShardTelemetry(_Broken())
        t.on_lease("ds", 1, 0.0, 0.01, 1, 1)
        t.flush()  # must swallow, not propagate into the dispatcher
        return t.summary()["leases"]

    assert _both(run) == (1, 1)


def test_gauges_keys_match():
    port, ref = _both(lambda p: set(p.datascope.ShardTelemetry().gauges()))
    assert port == ref == {"backlog", "shards_per_s", "lease_p99_ms"}


def test_data_knobs_match_the_reference():
    from dlrover_tpu.common import envs as jenvs
    from dlrover_tpu_torch.common import envs

    for name in ("DLROVER_TPU_DATASCOPE", "DLROVER_TPU_DATA_FLUSH_S",
                 "DLROVER_TPU_DATA_WINDOW", "DLROVER_TPU_DATA_STARVED_MIN_S",
                 "DLROVER_TPU_DATA_STARVED_SHARE",
                 "DLROVER_TPU_SHARD_LEASE_BATCH", "DLROVER_TPU_SHARD_WAIT_S"):
        assert envs.DEFAULTS[name] == jenvs._REGISTRY[name].default, name


def test_window_bounds_the_samples(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_DATA_WINDOW", "16")

    def run(p):
        t = p.datascope.ShardTelemetry(None)
        for i in range(40):
            t.on_lease("ds", 1, 0.0, (100.0 if i < 24 else 1.0) / 1e3, 0, 1)
        return t.summary()

    port, ref = _both(run)
    assert port == ref
    # only the last 16 samples (all 1 ms) remain
    assert port["lease_p99_ms"] == pytest.approx(1.0)


# -- TaskManager -> telemetry ------------------------------------------------


def test_lease_and_complete_hooks_match():
    def run(p):
        manager = p.tm.TaskManager()
        rec = _Recorder()
        manager.set_telemetry(rec)
        _new_dataset(manager, size=4)
        tasks, finished = manager.lease_dataset_tasks(0, "ds", count=2)
        assert len(tasks) == 2 and not finished
        done = manager.report_dataset_task("ds", tasks[0].task_id, True)
        failed = manager.report_dataset_task("ds", tasks[1].task_id, False)
        return rec.leases, rec.completes, rec.backlogs, done, failed

    port, ref = _both(run)
    assert port == ref
    assert port[0][-1] == ("ds", 2, False, True, 4, 1)
    assert port[1] == [("ds", True, 3, 1)]
    assert port[3] is True


def test_wait_path_splits_queue_from_service():
    def run(p):
        manager = p.tm.TaskManager()
        rec = _Recorder()
        manager.set_telemetry(rec)
        _new_dataset(manager, size=1)
        tasks, _ = manager.lease_dataset_tasks(0, "ds", count=1)
        got = {}

        def waiter():
            got["out"] = manager.wait_dataset_tasks(1, "ds", count=1,
                                                    timeout=5.0)

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.3)
        # node 0's task fails -> re-queued -> the waiter leases it
        manager.report_dataset_task("ds", tasks[0].task_id, False)
        t.join(timeout=5)
        leased, _ = got["out"]
        assert len(leased) == 1
        return rec.leases

    port, ref = _both(run)
    # the blocked Condition wait is QUEUE time, not dispatch cost
    assert port == ref
    assert port[-1][:3] == ("ds", 1, True)


def test_chaos_drop_refuses_lease(_isolate):
    def run(p):
        manager = p.tm.TaskManager()
        _new_dataset(manager, size=2)
        p.chaos.configure(p.chaos.ChaosPlan(
            name="t", seed=1,
            faults=[p.chaos.FaultSpec(point="data.lease", kind=p.chaos.DROP,
                                      on_calls=[0], times=1)],
        ))
        first = manager.lease_dataset_tasks(0, "ds", count=2)
        second = manager.lease_dataset_tasks(0, "ds", count=2)
        trace = p.chaos.trace()
        p.chaos.clear()
        return ((len(first[0]), first[1]), (len(second[0]), second[1]),
                [(r["point"], r["kind"], r["call"]) for r in trace])

    port, ref = _both(run)
    assert port == ref == ((0, False), (2, False),
                           [("data.lease", "drop", 0)])


def test_recover_tasks_reports_backlog():
    def run(p):
        manager = p.tm.TaskManager()
        rec = _Recorder()
        manager.set_telemetry(rec)
        _new_dataset(manager, size=3)
        manager.lease_dataset_tasks(7, "ds", count=2)
        manager.recover_tasks(7)
        return rec.backlogs

    port, ref = _both(run)
    assert port == ref == [("ds", 3, 1)]


# -- exactly once under worker churn -----------------------------------------


def test_kill_and_rejoin_mid_epoch_no_loss_no_double_count():
    def run(p):
        manager = p.tm.TaskManager()
        telemetry = p.datascope.ShardTelemetry(None)
        manager.set_telemetry(telemetry)
        _new_dataset(manager, size=3, num_epochs=2)
        seen = []
        tasks, _ = manager.lease_dataset_tasks(1, "ds", count=2)
        assert manager.report_dataset_task("ds", tasks[0].task_id, True)
        seen.append((manager.get_dataset_epoch("ds"), tasks[0].shard.start))
        dead_task = tasks[1]
        manager.recover_tasks(1)  # node 1 killed mid-epoch
        # the stale completion of a revoked lease must not count
        stale = manager.report_dataset_task("ds", dead_task.task_id, True)
        while True:
            tasks, finished = manager.lease_dataset_tasks(2, "ds", count=1)
            if not tasks:
                assert finished
                break
            seen.append((manager.get_dataset_epoch("ds"),
                         tasks[0].shard.start))
            assert manager.report_dataset_task("ds", tasks[0].task_id, True)
        summary = telemetry.summary()
        return (seen, stale, manager.get_dataset("ds").completed_count,
                summary["completions"], summary["datasets"]["ds"]["epoch"],
                manager.finished())

    port, ref = _both(run)
    assert port == ref
    seen, stale, completed, completions, epoch, finished = port
    assert len(seen) == len(set(seen)) == 6
    assert not stale and completed == completions == 6
    assert epoch == 2 and finished


# -- the sharding client's spans and scope ------------------------------------


def _span_view(records):
    out = []
    for r in records:
        if r["name"] not in ("data.fetch", "data.consume"):
            continue
        attrs = dict(r["attrs"])
        for key in ("wait_s", "service_s", "process_s"):
            attrs.pop(key, None)
        out.append((r["name"], attrs, r["dur"] >= 0))
    return out


def _scope_view(scope):
    return {k: v for k, v in scope.items() if not k.endswith("_s")}


def test_fetch_and_consume_spans_with_scope(_isolate, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_SHARD_LEASE_BATCH", "1")

    def run(p):
        servicer = p.servicer.MasterServicer()
        client = p.mc.LocalMasterClient(servicer, 0)
        sc = p.sharding.ShardingClient(
            dataset_name="ds", batch_size=1, num_epochs=1,
            dataset_size=3, client=client, num_minibatches_per_shard=1,
        )
        shards = 0
        while sc.fetch_shard() is not None:
            shards += 1
            sc.report_shard_done()
        return (shards, p.datascope.scope_summary(),
                p.goodput.ledger().summary()["phases"]["input_starved"])

    port, ref = _both(run)
    assert _span_view(_isolate["port"]) == _span_view(_isolate["ref"])
    assert port[0] == ref[0] == 3
    assert _scope_view(port[1]) == _scope_view(ref[1])
    assert port[1]["fetches"] == 4 and port[1]["consumes"] == 3
    # instant leases: nothing crossed the starvation floor
    assert port[1].get("starved_fetches", 0) == 0
    assert port[2] < 0.05
    consumes = [r for r in _isolate["port"] if r["name"] == "data.consume"]
    assert len(consumes) == 3
    assert all(c["dur"] >= 0 for c in consumes)


def test_blocked_fetch_charges_input_starved(_isolate, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_SHARD_LEASE_BATCH", "1")

    def run(p):
        servicer = p.servicer.MasterServicer()
        client = p.mc.LocalMasterClient(servicer, 0)
        p.chaos.configure(p.chaos.ChaosPlan(
            name="t", seed=1,
            faults=[p.chaos.FaultSpec(point="data.lease",
                                      kind=p.chaos.DELAY, delay_s=0.3,
                                      on_calls=[0], times=1)],
        ))
        sc = p.sharding.ShardingClient(
            dataset_name="ds", batch_size=1, num_epochs=1,
            dataset_size=1, client=client, num_minibatches_per_shard=1,
        )
        assert sc.fetch_shard() is not None
        sc.report_shard_done()
        p.chaos.clear()
        return (p.datascope.scope_summary(),
                p.goodput.ledger().summary()["phases"]["input_starved"])

    port, ref = _both(run)
    assert _scope_view(port[0]) == _scope_view(ref[0])
    assert port[0]["starved_fetches"] == 1
    assert port[0]["wait_s"] >= 0.25 and port[1] >= 0.25
    assert _span_view(_isolate["port"]) == _span_view(_isolate["ref"])
    starved = [r["attrs"]["starved"] for r in _isolate["port"]
               if r["name"] == "data.fetch"]
    assert starved == [True]


def test_datascope_kill_switch(_isolate, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_DATASCOPE", "0")

    def run(p):
        p.datascope.record_fetch("ds", 1.0, 0.0, True)
        p.datascope.record_consume("ds", 1.0)
        servicer = p.servicer.MasterServicer()
        return (p.datascope.scope_summary(), p.datascope.enabled(),
                servicer.task_manager._telemetry)  # noqa: SLF001

    assert _both(run) == (({}, False, None), ({}, False, None))


def test_scope_counters_match(_isolate):
    def run(p):
        p.datascope.record_fetch("ds", 0.2, 0.01, True)
        p.datascope.record_fetch("ds", 0.0, 0.002, False)
        p.datascope.record_consume("ds", 0.5)
        out = p.datascope.scope_summary()
        p.datascope.reset_scope()
        return out, p.datascope.scope_summary()

    port, ref = _both(run)
    assert port == ref
    assert port[0]["fetches"] == 2 and port[0]["starved_s"] == 0.2
    assert port[1] == {}


# -- RED exclusion: a blocking long-poll is not a service time ---------------


def _red_counts(p):
    reg = p.metrics.registry()
    stats = reg.histogram_stats(
        "dlrover_tpu_rpc_duration_seconds",
        method="TaskBatchRequest", transport="master",
    ) or {}
    snap = reg.snapshot()["histograms"].get(
        "dlrover_tpu_longpoll_wait_seconds", {})
    waits = sum(v.get("count", 0) for labels, v in snap.items()
                if 'kind="task"' in labels)
    return stats.get("count", 0), waits


def test_blocking_wait_excluded_from_rpc_duration():
    def run(p):
        servicer = p.servicer.MasterServicer()
        client = p.mc.LocalMasterClient(servicer, 0)
        _new_dataset(servicer.task_manager, size=1)
        # lease the only task to another node: the long-poll must block
        servicer.task_manager.lease_dataset_tasks(9, "ds", count=1)
        hist0, wait0 = _red_counts(p)
        t0 = time.monotonic()
        leased, _ = client.get_task_batch("ds", count=1, wait_timeout=0.4)
        blocked = time.monotonic() - t0
        assert not leased and blocked >= 0.3
        hist1, wait1 = _red_counts(p)
        # an immediate (non-waiting) lease IS a service time
        client.get_task_batch("ds", count=1)
        hist2, _ = _red_counts(p)
        return hist1 - hist0, wait1 - wait0, hist2 - hist1

    port, ref = _both(run)
    assert port == ref == (0, 1, 1)


# -- the data sentinels -------------------------------------------------------


def _feed(store, name, values, res=1.0, t_end=None):
    t_end = time.time() if t_end is None else t_end
    t0 = t_end - (len(values) + 2) * res
    for i, v in enumerate(values):
        store.add(name, v, t0 + i * res)


SENTINEL_CASES = {
    "starvation_spike": ("DataStarvationDiagnostician",
                         "job.share.input_starved",
                         [0.0, 0.0, 0.0, 0.0, 0.6, 0.0]),
    "starvation_under_floor": ("DataStarvationDiagnostician",
                               "job.share.input_starved",
                               [0.0, 0.0, 0.0, 0.0, 0.05, 0.0]),
    "lease_p99_spike": ("ShardLatencyRegressionDiagnostician",
                        "job.data.lease_p99_ms",
                        [2.0, 2.0, 2.0, 2.0, 400.0, 2.0]),
    "lease_p99_under_floor": ("ShardLatencyRegressionDiagnostician",
                              "job.data.lease_p99_ms",
                              [2.0, 2.0, 2.0, 2.0, 22.0, 2.0]),
}


@pytest.mark.parametrize("case", sorted(SENTINEL_CASES))
def test_data_sentinels_match(case, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_SENTINEL_MIN_SAMPLES", "3")
    monkeypatch.setenv("DLROVER_TPU_SENTINEL_CONSECUTIVE", "1")
    cls, series, values = SENTINEL_CASES[case]
    t_end = float(int(time.time()))

    def run(p):
        store = p.ts.TimeSeriesStore()
        diag = getattr(p.sentinel, cls)(store, res_s=1.0)
        _feed(store, series, values, t_end=t_end)
        obs = diag.observe()
        return obs.observed, obs.extra.get("phase"), obs.detail

    port, ref = _both(run)
    assert port == ref
    assert port[0] == case.endswith("spike")
    if port[0]:
        assert port[1] == "data"


def test_data_sentinels_registered_in_the_standard_set():
    names = [type(s).__name__ for s in sentinel.register_sentinels(
        DiagnosisManager(), ts.TimeSeriesStore())]
    assert names[-2:] == ["DataStarvationDiagnostician",
                          "ShardLatencyRegressionDiagnostician"]


# -- the servicer's wiring, /metrics and /data --------------------------------


def test_servicer_attaches_telemetry_and_gauges(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_DATA_FLUSH_S", "0")

    def run(p):
        servicer = p.servicer.MasterServicer()
        attached = (servicer.task_manager._telemetry  # noqa: SLF001
                    is servicer.shard_telemetry)
        _new_dataset(servicer.task_manager, size=2)
        tasks, _ = servicer.task_manager.lease_dataset_tasks(
            0, "ds", count=1)
        servicer.task_manager.report_dataset_task(
            "ds", tasks[0].task_id, True)
        page = p.metrics.registry().render()
        lines = sorted(line for line in page.splitlines()
                       if line.startswith("dlrover_tpu_data_")
                       and "lease_p99" not in line
                       and "shards_per_second" not in line)
        return attached, lines, "dlrover_tpu_data_lease_p99_ms" in page

    port, ref = _both(run)
    assert port == ref
    assert port[0] and port[2]
    assert "dlrover_tpu_data_backlog 1" in "\n".join(port[1])
    assert metrics.METRICS["dlrover_tpu_data_backlog"] == \
        jmetrics.METRICS["dlrover_tpu_data_backlog"]


def test_dashboard_data_route_matches(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_DATA_FLUSH_S", "0")
    clock = _Clock(monkeypatch)

    def run(p):
        clock.t = 1_700_000_000.0
        servicer = p.servicer.MasterServicer()
        _new_dataset(servicer.task_manager, size=3)
        tasks, _ = servicer.task_manager.lease_dataset_tasks(
            0, "ds", count=1)
        servicer.task_manager.report_dataset_task(
            "ds", tasks[0].task_id, True)
        servicer.shard_telemetry.flush()
        server = p.dashboard.DashboardServer(
            types.SimpleNamespace(servicer=servicer), port=0)
        try:
            payload = server.data()
        finally:
            server._httpd.server_close()  # noqa: SLF001 - never started
        summary = dict(payload["summary"])
        # the lease's measured service time is the host's
        for key in ("lease_p50_ms", "lease_p99_ms", "shards_per_s"):
            summary.pop(key)
        summary["datasets"] = {
            k: {kk: vv for kk, vv in v.items()
                if kk not in ("lease_p50_ms", "lease_p99_ms",
                              "complete_p99_ms")}
            for k, v in summary["datasets"].items()}
        return summary, sorted(payload["series"])

    port, ref = _both(run)
    assert port == ref
    assert port[0]["completions"] == 1 and port[0]["backlog"] == 2
    assert "job.data.backlog" in port[1]


# -- the data smoke -----------------------------------------------------------


def test_data_smoke_is_ok_and_checks_what_the_reference_checks():
    from dlrover_tpu.observability import data_smoke as jsmoke
    from dlrover_tpu_torch.observability import data_smoke

    port = data_smoke.run_smoke()
    assert port["ok"], port["checks"]
    ref = jsmoke.run_smoke()
    assert list(port["checks"]) == list(ref["checks"])
    assert port["seed"] == ref["seed"]
