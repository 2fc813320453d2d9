"""The port's master time-series store against the JAX package's, on the
CPU.

Each case is a script of writes (``add``, ``record_digest``,
``record_recovery``, ``evict_node``) with fixed timestamps: the cases of
``tests/test_timeseries.py`` (rings, the goodput-ledger digest feed, the
counter export) and the digest channels the reference's scopes fill
(fabric ``fxl_``/``fxb_``, memory ``mm_``/``mms_``, compile ``js_``), a
recovery sequence, and a long sequence drawn from a seed.  Both stores run
the same script and must answer every read the same: ``series`` at each
resolution, ``latest``, ``names``, ``snapshot``, the per-node views,
``recoveries`` and ``export_counters``; and the pull gauges must render
the same lines.  The port's own scopes' digests feed both stores alike,
and a memory digest without a limit leaves the headroom series absent.
The servicer feeds its store from a heartbeat's digest and a
``RecoveryReport``."""

import time

import numpy as np
import pytest
import torch

from dlrover_tpu.master import timeseries as jts
from dlrover_tpu_torch.master import timeseries as ts

RESOLUTIONS = (1.0, 10.0, 300.0)


def _gp(wall, compute, ckpt=0.0, **extra):
    idle = max(0.0, wall - compute - ckpt)
    return dict({
        "gp_wall": wall, "gp_compute": compute, "gp_ckpt_stall": ckpt,
        "gp_exposed_comm": 0.0, "gp_rendezvous_restart": 0.0,
        "gp_overload_rideout": 0.0, "gp_compile": 0.0,
        "gp_idle_unknown": idle, "step_p50_s": 0.05,
    }, **extra)


def _js(seq, compile_s, hits, misses, ts_, boot, warm=1.0, cache=1.0):
    return {"js_ts": ts_, "js_boot": boot, "js_seq": float(seq),
            "js_compile_s": compile_s, "js_hits": float(hits),
            "js_misses": float(misses), "js_stalls": 0.0,
            "js_warm": warm, "js_cache": cache}


# -- the scripts: (points_per_ring, [op, ...]) built from "now" ---------------


def _downsampling(now):
    t0 = (int(now / 300) - 2) * 300.0
    return 100, [("add", "x", float(i), t0 + i) for i in range(60)]


def _bounded(now):
    return 10, [("add", "x", float(i), now - 1000 + i) for i in range(500)]


def _out_of_order(now):
    return None, [("add", "x", 1.0, now - 50), ("add", "x", 99.0, now - 90)]


def _latest(now):
    return None, [("add", "x", 1.0, now - 1), ("add", "x", 3.0, now)]


def _goodput_deltas(now):
    return None, [
        ("digest", 0, _gp(10.0, 9.0), now - 3),
        ("digest", 0, _gp(11.0, 9.9), now - 2),
        ("digest", 0, _gp(12.0, 9.9, ckpt=1.0), now - 1),
    ]


def _first_digest(now):
    return None, [("digest", 0, _gp(10.0, 9.0), now)]


def _counter_reset(now):
    return None, [
        ("digest", 0, _gp(100.0, 90.0), now - 3),
        ("digest", 0, _gp(2.0, 1.0), now - 2),
        ("digest", 0, _gp(4.0, 3.0), now - 1),
    ]


def _fresh_nodes(now):
    return None, [
        ("digest", 0, _gp(10.0, 0.0), now - 400),
        ("digest", 0, _gp(11.0, 0.0), now - 395),
        ("digest", 1, _gp(10.0, 9.0), now - 3),
        ("digest", 1, _gp(12.0, 11.0), now - 2),
        ("digest", 2, _gp(10.0, 9.0), now - 3),
        ("digest", 2, _gp(12.0, 10.0), now - 2),
    ]


def _no_gp_restamp(now):
    ops = [("digest", 0, _gp(10.0, 9.0), now - 10),
           ("digest", 0, _gp(11.0, 9.9), now - 9)]
    ops += [("digest", 0, {"step_p50_s": 0.05}, now - 8 + i)
            for i in range(5)]
    return None, ops


def _seq_gates(now):
    return None, [
        ("digest", 0, _gp(100.0, 90.0, gp_seq=1000.0), now - 60),
        ("digest", 0, _gp(115.0, 90.0, ckpt=15.0, gp_seq=1000.0), now - 45),
        ("digest", 0, _gp(175.0, 130.0, ckpt=15.0, gp_seq=1060.0), now - 5),
    ]


def _seq_regression(now):
    return None, [
        ("digest", 0, _gp(100.0, 90.0, gp_seq=1000.0), now - 9),
        ("digest", 0, _gp(101.0, 91.0, gp_seq=10.0), now - 8),
        ("digest", 0, _gp(102.0, 92.0, gp_seq=11.0), now - 7),
    ]


def _wall_jump(now):
    return None, [
        ("digest", 0, _gp(10.0, 9.0, ranks=2.0), now - 10),
        ("digest", 0, _gp(11.0, 9.9, ranks=2.0), now - 9),
        ("digest", 0, _gp(7211.0, 10.0, ranks=2.0), now - 8),
        ("digest", 0, _gp(7212.0, 11.0, ranks=2.0), now - 7),
    ]


def _evict(now):
    return None, [
        ("digest", 0, _gp(10.0, 9.0), now - 2),
        ("evict", 0),
        ("digest", 0, _gp(1.0, 1.0), now - 1),
    ]


def _export(now):
    ops = [("add", "job.goodput", 0.9, now - 10 + i) for i in range(5)]
    ops += [("add", "node0.goodput", 0.5, now)]
    return None, ops


def _comm(now):
    ops = []
    for i in range(6):
        for node, slow in ((0, 1.0), (1, 30.0 if i >= 3 else 1.0)):
            ops.append(("digest", node, {
                "fxl_dp": 100.0 * slow + i, "fxb_dp": 10.0 / slow,
                "fxl_fsdp": 50.0 + node, "fxb_fsdp": 20.0 - node,
            }, now - 20 + i))
    ops.append(("digest", 2, {"fxl_dp": 9999.0}, now - 500))  # stale
    ops.append(("digest", 0, {"fxl_dp": 101.0}, now - 1))
    return None, ops


def _mem(now):
    gib = float(2 ** 30)
    ops = []
    for i in range(8):
        used = 5 * gib + i * 0.5 * gib
        ops.append(("digest", 0, {
            "mm_ts": now - 30 + i, "mm_used_b": used, "mm_limit_b": 8 * gib,
            "mm_peak_b": used, "mm_rss_b": 1e9, "mm_shm_b": 2e9,
            "mms_params": 1e9, "mms_optimizer": 2e9, "mms_other": used - 3e9,
        }, now - 29 + i))
        # node 1 reports no limit: no headroom series for it
        ops.append(("digest", 1, {
            "mm_ts": now - 30 + i, "mm_used_b": 1e9 + i, "mm_peak_b": 2e9,
            "mm_rss_b": 1e9, "mm_shm_b": 0.0, "mms_params": 1e9,
        }, now - 29 + i))
    # a heartbeat re-shipping the same account later: anchored at mm_ts
    ops.append(("digest", 0, {"mm_ts": now - 23, "mm_used_b": 8.5 * gib,
                              "mm_limit_b": 8 * gib}, now - 2))
    return None, ops


def _compile(now):
    boot1, boot2 = now - 100.0, now - 40.0
    return None, [
        ("digest", 0, _js(1, 3.0, 0, 2, now - 99, boot1, warm=0.0), now - 98),
        ("digest", 0, _js(1, 3.0, 0, 2, now - 99, boot1, warm=0.0), now - 90),
        ("digest", 0, _js(2, 3.5, 1, 3, now - 80, boot1, warm=0.0), now - 79),
        # a restart: a new boot whose cumulative account is its window
        ("digest", 0, _js(1, 0.0, 2, 0, now - 39, boot2), now - 38),
        ("digest", 0, _js(2, 4.0, 2, 1, now - 20, boot2), now - 19),
        ("digest", 1, _js(1, 9.0, 0, 4, now - 10, now - 11), now - 9),
        # an older agent: no boot marker, the seq moves backwards
        ("digest", 2, {"js_ts": now - 8, "js_seq": 5.0, "js_compile_s": 1.0,
                       "js_hits": 1.0, "js_misses": 1.0}, now - 7),
        ("digest", 2, {"js_ts": now - 5, "js_seq": 1.0, "js_compile_s": 2.0,
                       "js_hits": 0.0, "js_misses": 1.0}, now - 4),
    ]


def _recoveries(now):
    ops = []
    for i in range(40):
        ops.append(("recovery", {
            "scope": "s", "process_id": i % 4, "step": i,
            "rung": ("peer_shm", "manifest")[i % 2],
            "mttr_s": 0.5 + 0.1 * i, "peer_read_gbps": 0.0 if i % 3 else 2.5,
            "storage_reads": i % 2, "budget_s": 60.0, "over_budget": False,
        }, now - 100 + i))
    return None, ops


def _seeded(now):
    rng = np.random.default_rng(20261018)
    ops = []
    acc = {node: {"wall": 0.0, "compute": 0.0, "ckpt": 0.0, "seq": 1.0}
           for node in range(3)}
    for i in range(120):
        node = int(rng.integers(0, 3))
        a = acc[node]
        kind = int(rng.integers(0, 5))
        t = now - 200 + i * float(rng.uniform(0.2, 2.5))
        if kind == 0:
            ops.append(("add", f"x{int(rng.integers(0, 3))}",
                        float(rng.normal()), t))
            continue
        if kind == 4 and rng.random() < 0.2:
            ops.append(("evict", node))
            continue
        dw = float(rng.uniform(0.5, 5.0))
        a["wall"] += dw
        a["compute"] += dw * float(rng.uniform(0.3, 1.0))
        a["ckpt"] += dw * float(rng.uniform(0.0, 0.1))
        if rng.random() < 0.7:
            a["seq"] += 1.0
        digest = _gp(a["wall"], a["compute"], ckpt=a["ckpt"],
                     gp_seq=a["seq"], ranks=2.0)
        digest["step_p50_s"] = float(rng.uniform(0.0, 0.2))
        digest["fxl_dp"] = float(rng.uniform(10, 500))
        digest["fxb_dp"] = float(rng.uniform(1, 50))
        digest["mm_used_b"] = float(rng.uniform(1e9, 7e9))
        digest["mm_limit_b"] = 8e9
        digest["mm_ts"] = t - float(rng.uniform(0, 1))
        digest["mms_params"] = 1e9
        ops.append(("digest", node, digest, t))
    return None, ops


CASES = {
    "downsampling_at_each_resolution": _downsampling,
    "rings_are_bounded": _bounded,
    "out_of_order_point_dropped": _out_of_order,
    "latest": _latest,
    "deltas_become_goodput_series": _goodput_deltas,
    "first_digest_only_baselines": _first_digest,
    "counter_reset_rebaselines": _counter_reset,
    "job_rollup_averages_fresh_nodes_only": _fresh_nodes,
    "digest_without_gp_does_not_restamp_stale_shares": _no_gp_restamp,
    "seq_gates_between_advance_heartbeats": _seq_gates,
    "seq_regression_rebaselines": _seq_regression,
    "implausible_wall_jump_rebaselines": _wall_jump,
    "evict_node_drops_baseline": _evict,
    "export_filters_prefix": _export,
    "fabric_digests": _comm,
    "memory_digests": _mem,
    "compile_digests": _compile,
    "recovery_reports": _recoveries,
    "seeded_heartbeats": _seeded,
}


def _apply(store, ops):
    for op in ops:
        if op[0] == "add":
            store.add(op[1], op[2], ts=op[3])
        elif op[0] == "digest":
            store.record_digest(op[1], dict(op[2]), ts=op[3])
        elif op[0] == "recovery":
            store.record_recovery(dict(op[1]), ts=op[2])
        else:
            store.evict_node(op[1])


def _view(store):
    names = store.names()
    return {
        "names": names,
        "series": {(n, r): store.series(n, res=r)
                   for n in names for r in RESOLUTIONS + (7.0, 9999.0)},
        "latest": {n: store.latest(n) for n in names + ["missing"]},
        "snapshots": [store.snapshot(res=r, prefix=p)
                      for r in (0.1, 1.0, 10.0, 300.0)
                      for p in ("", "job.", "node0.")],
        "comm": store.comm_nodes(),
        "mem": store.mem_nodes(),
        "compile": store.compile_nodes(),
        "recoveries": store.recoveries(),
        "counters": store.export_counters(),
        "counters_node": store.export_counters(prefix="node", res=10.0),
    }


def _run(case):
    now = float(int(time.time()))
    points, ops = CASES[case](now)
    port = ts.TimeSeriesStore(points_per_ring=points)
    ref = jts.TimeSeriesStore(points_per_ring=points)
    _apply(port, ops)
    _apply(ref, ops)
    return port, ref


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_store_matches_the_reference(case):
    port, ref = _run(case)
    got, want = _view(port), _view(ref)
    assert got["names"], "the script wrote no series"
    for key in want:
        assert got[key] == want[key], key


def test_resolutions_and_freshness_are_the_reference_s():
    from dlrover_tpu_torch.master.metric_context import DIGEST_FRESH_S

    assert ts.RESOLUTIONS == jts.RESOLUTIONS
    assert ts.FRESH_S == jts.FRESH_S == DIGEST_FRESH_S


def test_the_default_ring_length_is_the_knob(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_TS_POINTS", "12")
    port, ref = ts.TimeSeriesStore(), jts.TimeSeriesStore()
    for store in (port, ref):
        for i in range(40):
            store.add("x", float(i), ts=1000.0 + i)
    assert len(port.series("x", res=1.0)) == 12
    assert port.series("x", res=1.0) == ref.series("x", res=1.0)


def _gauge_lines(text):
    names = ("dlrover_tpu_goodput_ledger", "dlrover_tpu_goodput_phase_share",
             "dlrover_tpu_step_p50_seconds", "dlrover_tpu_mem_used_bytes",
             "dlrover_tpu_mem_headroom", "dlrover_tpu_mem_subsystem_bytes",
             "dlrover_tpu_compile_recent_seconds",
             "dlrover_tpu_compile_cache_hit_ratio")
    return sorted(line for line in text.splitlines()
                  if line.split("{")[0].split(" ")[0] in names)


@pytest.mark.parametrize("case", ["deltas_become_goodput_series",
                                  "memory_digests", "compile_digests",
                                  "seeded_heartbeats"])
def test_pull_gauges_render_the_reference_lines(case):
    from dlrover_tpu.observability import metrics as jmetrics
    from dlrover_tpu_torch.observability import metrics

    port, ref = _run(case)
    port.register_pull_gauges()
    ref.register_pull_gauges()
    got = _gauge_lines(metrics.registry().render())
    want = _gauge_lines(jmetrics.registry().render())
    assert got and got == want


def test_an_empty_store_renders_no_gauge_sample(monkeypatch):
    from dlrover_tpu_torch.observability import metrics

    monkeypatch.setattr(metrics, "_registry", metrics.MetricsRegistry())
    ts.TimeSeriesStore().register_pull_gauges()
    assert not [line for line in _gauge_lines(metrics.registry().render())
                if not line.startswith("#")]


def test_the_port_scopes_digests_feed_both_stores_alike():
    """The keys the store reads are the ones the port's scopes write:
    the goodput ledger, the fabric model, the memory and compile scopes.
    A memory account without a limit (the CPU with no
    ``DLROVER_TPU_MEM_CPU_LIMIT_B``) feeds no headroom series."""
    from dlrover_tpu_torch.observability import (
        commscope,
        goodput,
        jitscope,
        memscope,
    )

    now = float(int(time.time()))
    fabric = commscope.FabricModel(alpha=1.0)
    ledger = goodput.GoodputLedger()
    mem = memscope.MemScope()
    mem.bind_device("cpu")
    keep = torch.ones(1024)
    js = jitscope.JitScope(warm_expected=True, cache_enabled=True)
    port, ref = ts.TimeSeriesStore(), jts.TimeSeriesStore()
    for i in range(4):
        fabric.update("dp", 2, 1e-4 * (i + 1), 5.0)
        ledger.on_step(i, 0.01)
        mem.sample()
        js.record_compile("trainer.train_step",
                          jitscope.signature_of((torch.zeros(i + 1),), {}),
                          0.1 * i, 1, 1 if i == 0 else 0, now - 1, now, 0.2)
        digest = {}
        digest.update(ledger.digest())
        digest.update(fabric.digest())
        digest.update(mem.digest())
        digest.update(js.digest())
        digest["step_p50_s"] = 0.1
        for store in (port, ref):
            store.record_digest(0, dict(digest), ts=now - 10 + i)
    del keep
    assert _view(port) == _view(ref)
    names = port.names()
    for want in ("node0.comm.dp.lat_us", "job.comm.dp.gbps",
                 "node0.mem.used_b", "job.mem.used_b",
                 "node0.compile.s", "job.compile.hit_ratio",
                 "job.step_p50_s"):
        assert want in names, want
    assert "node0.mem.headroom_frac" not in names
    assert "job.mem.headroom" not in names
    assert port.compile_nodes()[0]["warm_expected"] is True


def test_the_servicer_feeds_its_store():
    from dlrover_tpu_torch.agent.master_client import LocalMasterClient
    from dlrover_tpu_torch.common import comm
    from dlrover_tpu_torch.master.servicer import MasterServicer

    servicer = MasterServicer()
    assert isinstance(servicer.timeseries, ts.TimeSeriesStore)
    client = LocalMasterClient(servicer, node_id=3)
    now = time.time()
    client.report_heart_beat(ts=now - 1, digest=_gp(10.0, 9.0))
    client.report_heart_beat(ts=now, digest=_gp(12.0, 10.0))
    assert servicer.timeseries.latest("node3.step_p50_s") == 0.05
    assert servicer.timeseries.latest("job.goodput") == pytest.approx(0.5)
    report = {"scope": "s", "process_id": 3, "step": 7, "rung": "peer_shm",
              "mttr_s": 1.5, "peer_read_gbps": 2.0, "bytes_peer": 10,
              "bytes_manifest": 0, "storage_reads": 0, "torn_retries": 0,
              "demoted_peers": [], "cache_prewarmed": 1, "budget_s": 60.0,
              "over_budget": False, "filled": True}
    assert client.report_recovery(dict(report))
    stored = servicer.timeseries.recoveries()
    assert [(r["rung"], r["mttr_s"], r["process_id"]) for r in stored] == [
        ("peer_shm", 1.5, 3)]
    assert servicer.timeseries.latest("job.recovery.mttr_s") == 1.5
    assert servicer.peer_broker.recoveries()[-1]["mttr_s"] == 1.5


def test_a_broken_feed_never_fails_the_heartbeat(monkeypatch):
    from dlrover_tpu_torch.agent.master_client import LocalMasterClient
    from dlrover_tpu_torch.common import comm
    from dlrover_tpu_torch.master.servicer import MasterServicer

    servicer = MasterServicer()

    def broken(*args, **kwargs):
        raise RuntimeError("boom")

    monkeypatch.setattr(servicer.timeseries, "record_digest", broken)
    monkeypatch.setattr(servicer.timeseries, "record_recovery", broken)
    client = LocalMasterClient(servicer, node_id=0)
    assert client.report_heart_beat(digest=_gp(1.0, 1.0)) == []
    assert client.report_recovery(comm.RecoveryReport(rung="peer_shm"))
