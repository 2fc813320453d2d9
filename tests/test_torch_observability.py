"""The port's rank digest (dlrover_tpu_torch/observability/ and
common/metric.py) held to the JAX package on the same inputs, in this
process on the CPU.

Every comparison here is exact (``==`` on dicts, lists and text): the
digest merges, the fabric model's EWMA, the trigger classes, the goodput
ledger, the flight recorder's step digest, the metrics registry's
Prometheus text, the metric taxonomy, ``fit_report`` and the bucket byte
accounting are the same pure-Python arithmetic in both packages.  Inputs
come from numpy seeds.  Where a value reads the clock, both packages read
one fixed clock (``time.time`` patched).

Port-only checks follow: the memory scope's CPU byte source, the compile
scope's hook on the kernel build (a hit, and a miss through a stand-in
compiler), ``MeshProbe`` pricing one slow axis alone (the reference's
version of that test injects a chaos delay; the port has no chaos module),
and the emitter's ``emit_span``.
"""

import json
import math
import os
import stat
import sys
import time
import types

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from dlrover_tpu.common import metric as jmetric  # noqa: E402
from dlrover_tpu.diagnosis import collectors as jcollectors  # noqa: E402
from dlrover_tpu.observability import commscope as jcommscope  # noqa: E402
from dlrover_tpu.observability import flight_recorder as jrecorder  # noqa: E402
from dlrover_tpu.observability import goodput as jgoodput  # noqa: E402
from dlrover_tpu.observability import jitscope as jjitscope  # noqa: E402
from dlrover_tpu.observability import memscope as jmemscope  # noqa: E402
from dlrover_tpu.observability import metrics as jmetrics  # noqa: E402
from dlrover_tpu.parallel import collectives as jcoll  # noqa: E402
from dlrover_tpu_torch.common import metric  # noqa: E402
from dlrover_tpu_torch.models.llama import LlamaConfig  # noqa: E402
from dlrover_tpu_torch.models.llama import LlamaForCausalLM  # noqa: E402
from dlrover_tpu_torch.observability import (  # noqa: E402
    commscope,
    flight_recorder,
    goodput,
    jitscope,
    memscope,
    metrics,
    trace,
)
from dlrover_tpu_torch.ops.cuda import _build  # noqa: E402
from dlrover_tpu_torch.parallel import collectives  # noqa: E402
from dlrover_tpu_torch.parallel.bucketing import BucketLayout  # noqa: E402
from dlrover_tpu_torch.training_event.emitter import (  # noqa: E402
    EventType,
    MemoryExporter,
    Process,
)

SEEDS = range(4)
AXES = ("dp", "fsdp", "tp")


@pytest.fixture
def clock(monkeypatch):
    """One fixed clock for both packages (both call ``time.time()``)."""
    now = {"t": 1_000_000.0}
    monkeypatch.setattr(time, "time", lambda: now["t"])
    return now


@pytest.fixture(autouse=True)
def fresh_scopes():
    """Each test leaves the port's process scopes as it found them."""
    yield
    memscope.reset_scope()
    commscope.reset_scope()
    jitscope.reset_scope()


# -- digest merges -------------------------------------------------------


def _rank_files(seed: int, ranks: int = 4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(ranks):
        d = {
            "ts": time.time(),
            "last_step": float(rng.integers(10, 20)),
            "step_p50_s": float(rng.uniform(0.1, 1.0)),
            "mm_ts": float(rng.uniform(1e9, 2e9)),
            "mm_used_b": float(rng.integers(1, 1 << 40)),
            "mm_peak_b": float(rng.integers(1, 1 << 40)),
            "mm_rss_b": float(rng.integers(1, 1 << 34)),
            "mm_shm_b": float(rng.integers(0, 1 << 34)),
            "js_ts": float(rng.uniform(1e9, 2e9)),
            "js_boot": float(rng.uniform(1e9, 2e9)),
            "js_seq": float(rng.integers(0, 9)),
            "js_compile_s": float(rng.uniform(0, 100)),
            "js_hits": float(rng.integers(0, 9)),
            "js_misses": float(rng.integers(0, 9)),
            "js_stalls": float(rng.integers(0, 3)),
            "js_warm": float(rng.integers(0, 2)),
            "js_cache": float(rng.integers(0, 2)),
        }
        if rng.random() < 0.75:  # a rank on a backend with no limit
            d["mm_limit_b"] = float(rng.integers(1 << 30, 1 << 40))
        for sub in memscope.SUBSYSTEMS:
            d[memscope.DIGEST_SUB + sub] = float(rng.integers(0, 1 << 36))
        for axis in AXES[:int(rng.integers(1, 4))]:
            d[commscope.DIGEST_LAT + axis] = float(rng.uniform(1, 500))
            d[commscope.DIGEST_BW + axis] = float(rng.uniform(0.1, 400))
        out.append(d)
    return out


def _port_merge(files):
    dst = {}
    for f in files:
        memscope.merge_digest(dst, f)
        jitscope.merge_digest(dst, f)
        commscope.merge_digest(dst, f)
    return dst


@pytest.mark.parametrize("seed", SEEDS)
def test_memscope_and_jitscope_merges_match_the_reference(seed):
    files = _rank_files(seed)
    port, ref = {}, {}
    for f in files:
        memscope.merge_digest(port, f)
        jitscope.merge_digest(port, f)
        jmemscope.merge_digest(ref, f)
        jjitscope.merge_digest(ref, f)
    assert port == ref
    assert memscope.DIGEST_MERGE == jmemscope.DIGEST_MERGE
    assert jitscope.DIGEST_MERGE == jjitscope.DIGEST_MERGE


@pytest.mark.parametrize("seed", SEEDS)
def test_merges_match_the_reference_agent(seed, tmp_path, monkeypatch):
    """The reference's agent folds the rank files it finds
    (``ElasticAgent._collect_digest``: the fabric merge inline, then the
    memory and compile merges); the port's three merge rules give the
    same ``fxl_``/``fxb_``/``mm_``/``mms_``/``js_`` keys."""
    from dlrover_tpu.agent.elastic_agent import ElasticAgent

    files = _rank_files(seed)
    base = tmp_path / "runtime_metrics.json"
    for rank, f in enumerate(files):
        (tmp_path / f"runtime_metrics.json.rank{rank}").write_text(
            json.dumps(f))
    monkeypatch.setenv("DLROVER_TPU_RUNTIME_METRICS_PATH", str(base))
    monkeypatch.setenv("DLROVER_TPU_GOODPUT_LEDGER", "0")
    agent = ElasticAgent._collect_digest(types.SimpleNamespace())
    prefixes = ("fxl_", "fxb_", "mm_", "mms_", "js_")
    want = {k: v for k, v in agent.items() if k.startswith(prefixes)}
    assert agent["ranks"] == len(files)
    assert _port_merge(files) == want


# -- the fabric model ------------------------------------------------------


@pytest.mark.parametrize("alpha", [None, 0.25, 1.0, 0.0, 1.5])
def test_fabric_model_matches_the_reference(alpha, clock):
    rng = np.random.default_rng(7)
    port, ref = commscope.FabricModel(alpha), jcommscope.FabricModel(alpha)
    for _ in range(30):
        axis = AXES[int(rng.integers(0, 3))]
        world = int(rng.integers(2, 9))
        lat, gbps = float(rng.uniform(-1e-6, 1e-3)), float(
            rng.uniform(-1, 400))
        port.update(axis, world, lat, gbps)
        ref.update(axis, world, lat, gbps)
        clock["t"] += 0.5
    assert port.snapshot() == ref.snapshot()
    assert port.digest() == ref.digest()
    assert port.axes() == ref.axes()
    assert commscope.digest_axes(port.digest()) == jcommscope.digest_axes(
        ref.digest())


# -- trigger classification ------------------------------------------------


def _sig(shapes=((4, 8),), dtypes=("float32",), specs=("",),
         meshes=("cpu",), static=None):
    return {"shapes": shapes, "dtypes": dtypes, "specs": specs,
            "meshes": meshes, "static": static or {"donate": True}}


# (trigger, prev, cur, missed, cache_enabled, warm_expected)
TRIGGER_CASES = [
    ("first-trace", None, _sig(), True, True, False),
    ("persistent-cache-miss", None, _sig(), True, True, True),
    ("mesh-change", _sig(), _sig(meshes=("mesh2",)), False, True, False),
    ("arg-shape-delta", _sig(), _sig(shapes=((4, 16),)), False, True, False),
    ("dtype-delta", _sig(), _sig(dtypes=("bfloat16",)), False, True, False),
    ("sharding-delta", _sig(), _sig(specs=("(Shard(dim=0),)",)), False,
     True, False),
    ("donation-mismatch", _sig(), _sig(static={"donate": False}), False,
     True, False),
    ("retrace", _sig(), _sig(), False, True, False),
]


@pytest.mark.parametrize("case", TRIGGER_CASES, ids=lambda c: c[0])
def test_classify_trigger_matches_the_reference(case):
    want, prev, cur, missed, enabled, warm = case
    assert jitscope.TRIGGERS == jjitscope.TRIGGERS
    got = jitscope.classify_trigger(prev, cur, missed, enabled, warm)
    assert got == want
    assert jjitscope.classify_trigger(prev, cur, missed, enabled,
                                      warm) == want


def test_signature_of_tensors_classifies_each_change():
    def sig(*args, **static):
        return jitscope.signature_of(args, {}, static)

    base = sig(torch.zeros(4, 8), {"ids": np.zeros((2, 3), np.int32)}, 3)
    same = sig(torch.ones(4, 8), {"ids": np.ones((2, 3), np.int32)}, 4)
    assert jitscope.classify_trigger(base, same, False, True,
                                     False) == "retrace"
    for cur, want in (
            (sig(torch.zeros(4, 9), {"ids": np.zeros((2, 3), np.int32)}, 3),
             "arg-shape-delta"),
            (sig(torch.zeros(4, 8, dtype=torch.bfloat16),
                 {"ids": np.zeros((2, 3), np.int32)}, 3), "dtype-delta"),
            (sig(torch.zeros(4, 8, device="meta"),
                 {"ids": np.zeros((2, 3), np.int32)}, 3), "mesh-change"),
            (sig(torch.zeros(4, 8), {"ids": np.zeros((2, 3), np.int32)}, 3,
                 donate=False), "donation-mismatch")):
        assert jitscope.classify_trigger(base, cur, False, True,
                                         False) == want


# -- the goodput ledger and the flight recorder ------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_goodput_ledger_matches_the_reference(seed, clock):
    rng = np.random.default_rng(seed)
    origin = clock["t"]
    port = goodput.GoodputLedger(res_s=0.5, window=32, origin_ts=origin)
    ref = jgoodput.GoodputLedger(res_s=0.5, window=32, origin_ts=origin)
    names = ["flash.save", "flash.persist", "snapshot.write", "storage.put",
             "reshard.apply", "peer_restore.fetch", "ckpt.phase1", "rdzv.join",
             "master.kv", "comm.probe.dp"]
    for _ in range(60):
        clock["t"] += float(rng.uniform(0.0, 2.0))
        kind = rng.integers(0, 4)
        if kind == 0:
            rec = {"name": names[int(rng.integers(0, len(names)))],
                   "ts": clock["t"] - float(rng.uniform(0, 3)),
                   "dur": float(rng.uniform(0, 2))}
            port.on_span(rec)
            ref.on_span(rec)
        elif kind == 1:
            dur = float(rng.uniform(0, 1.5))
            port.on_step(0, dur)
            ref.on_step(0, dur)
        elif kind == 2:
            phase = ["exposed_comm", "ckpt_stall", "compile",
                     "overload_rideout", "input_starved"][int(
                         rng.integers(0, 5))]
            dur = float(rng.uniform(0, 1))
            port.charge(phase, dur)
            ref.charge(phase, dur)
        else:
            start = clock["t"] - float(rng.uniform(0, 4))
            port.charge_interval("compute", start, clock["t"])
            ref.charge_interval("compute", start, clock["t"])
    assert port.digest() == ref.digest()
    assert port.summary() == ref.summary()


def test_compile_window_split_matches_the_reference(clock, monkeypatch):
    for mod in (goodput, jgoodput):
        monkeypatch.setattr(mod, "_LEDGER", None)
    goodput.reset_ledger(origin_ts=clock["t"] - 100)
    jgoodput.reset_ledger(origin_ts=clock["t"] - 100)
    for start, end, compile_s in ((-90, -80, 3.0), (-70, -60, None),
                                  (-50, -49, 5.0), (-40, -30, 0.0)):
        goodput.charge_compile_window(clock["t"] + start, clock["t"] + end,
                                      compile_s)
        jgoodput.charge_compile_window(clock["t"] + start, clock["t"] + end,
                                       compile_s)
    assert goodput.ledger().digest() == jgoodput.ledger().digest()


@pytest.mark.parametrize("seed", SEEDS)
def test_step_digest_matches_the_reference(seed, clock):
    rng = np.random.default_rng(seed)
    port = flight_recorder.FlightRecorder(attach_log_handler=False)
    ref = jrecorder.FlightRecorder(attach_log_handler=False)
    assert port.step_digest() == ref.step_digest() == {}
    for step in range(int(rng.integers(1, 700))):
        clock["t"] += float(rng.uniform(0.1, 1.0))
        dur = float(rng.uniform(0.01, 2.0))
        port.record_step(step, dur)
        ref.record_step(step, dur)
    assert port.step_digest() == ref.step_digest()
    assert port.total_steps == ref.total_steps


# -- the metrics registry ----------------------------------------------------


def _drive_registry(reg, seed: int):
    rng = np.random.default_rng(seed)
    for i in range(40):
        kind = rng.integers(0, 4)
        label = {"axis": AXES[int(rng.integers(0, 3))]}
        if kind == 0:
            reg.counter_inc("dlrover_tpu_comm_probes_total",
                            float(rng.integers(1, 4)), help="probes",
                            **label)
        elif kind == 1:
            reg.gauge_set("dlrover_tpu_comm_probe_latency_us",
                          float(rng.uniform(0, 100)), help="lat", **label)
        elif kind == 2:
            reg.observe("dlrover_tpu_comm_bucket_exchange_seconds",
                        float(rng.uniform(0, 400)), help="chain",
                        transport="ring_pallas_q", **label)
        else:
            reg.gauge_fn("dlrover_tpu_mem_host_rss_bytes",
                         lambda v=float(i): v, help="rss")
    reg.counter_inc("dlrover_tpu_mem_samples_total", help="samples")


@pytest.mark.parametrize("seed", SEEDS)
def test_metrics_text_matches_the_reference(seed):
    port, ref = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    _drive_registry(port, seed)
    _drive_registry(ref, seed)
    assert port.render() == ref.render()
    assert port.snapshot() == ref.snapshot()
    assert {k: jmetrics.METRICS[k] for k in metrics.METRICS} == \
        metrics.METRICS


def test_metrics_series_budget_matches_the_reference():
    port, ref = (metrics.MetricsRegistry(max_series=5),
                 jmetrics.MetricsRegistry(max_series=5))
    for reg in (port, ref):
        for i in range(9):
            reg.counter_inc("dlrover_tpu_recompile_total", fn=f"f{i}",
                            trigger="retrace")
    assert port.render() == ref.render()
    assert "dlrover_tpu_metrics_dropped_series_total 4" in port.render()


# -- the device metric taxonomy ----------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_metric_taxonomy_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    rows = []
    for chip in range(int(rng.integers(1, 9))):
        row = {"chip_id": chip}
        for key in metric.TpuMetricEnum.ALL:
            pick = rng.random()
            if pick < 0.3:
                row[key] = metric.UNKNOWN
            elif pick < 0.4:
                row[key] = 0.0
            elif pick < 0.9:
                row[key] = float(rng.uniform(0, 1e5))
        rows.append(row)
    port = metric.NodeTpuMetric.from_list(3, rows)
    ref = jmetric.NodeTpuMetric.from_list(3, rows)
    assert metric.TpuMetricEnum.ALL == jmetric.TpuMetricEnum.ALL
    assert port.to_list() == ref.to_list()
    assert metric.NodeTpuMetric.from_list(3, port.to_list()) == port
    for key in metric.TpuMetricEnum.ALL:
        assert port.avg(key) == ref.avg(key), key
    assert port.max_hbm_pressure() == ref.max_hbm_pressure()


def test_cpu_collection_reads_unknown_as_the_reference_does():
    """On the CPU both packages report the chip's memory as UNKNOWN (-1),
    never 0 (the reference has one chip per JAX CPU device, the port one
    for the CPU)."""
    port = metric.collect_node_tpu_metrics(5, device="cpu")
    ref = jmetric.collect_node_tpu_metrics(5)
    assert len(port.chips) == 1 and ref.chips
    assert port.chips[0].to_dict() == ref.chips[0].to_dict()
    for key in (metric.TpuMetricEnum.HBM_USED_MB,
                metric.TpuMetricEnum.HBM_TOTAL_MB,
                metric.TpuMetricEnum.HBM_PEAK_MB):
        assert port.avg(key) == metric.UNKNOWN == ref.avg(key)
    assert port.max_hbm_pressure() == 0.0


def test_prometheus_parse_matches_the_reference():
    text = ("# HELP x\n"
            'tpu_duty_cycle_percent{chip_id="1",name="a,b}c"} 42.5 1700\n'
            "megascale_ici_received_mbps 7\n"
            'bad{chip_id="0"}\n'
            'esc{v="q\\"uote\\\\n"} 3\n'
            "not a number\n")
    assert metric.parse_prometheus(text) == jcollectors.parse_prometheus(text)


# -- the state plan's fit check ----------------------------------------------


def _plan_leaves(seed: int):
    rng = np.random.default_rng(seed)
    return [{"path": f"leaf{i}",
             "subsystem": ("params", "optimizer", "ef_residual")[
                 int(rng.integers(0, 3))],
             "global_b": float(rng.integers(1, 1 << 30)),
             "axes": [a for a in ("dp", "fsdp", "tp")
                      if rng.random() < 0.5]}
            for i in range(int(rng.integers(1, 40)))]


FIT_PLANS = [{"mesh_axes": {"dp": 2}}, {"mesh_axes": {"dp": 1, "fsdp": 8}},
             {"mesh_axes": {}}, {}, {"mesh_axes": {"tp": 4, "cp": 2}}]


@pytest.mark.parametrize("seed", SEEDS)
def test_fit_report_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    leaves = _plan_leaves(seed)
    axes = {"dp": 4, "fsdp": 2, "tp": 2}
    port_plan = memscope.StatePlan([dict(x) for x in leaves], axes)
    ref_plan = jmemscope.StatePlan([dict(x) for x in leaves], axes)
    assert port_plan.snapshot() == ref_plan.snapshot()
    for plan in FIT_PLANS:
        kw = dict(limit_b=float(rng.choice([0.0, 8e9, 80e9, 1e12])),
                  overhead_b=float(rng.integers(0, 1 << 33)),
                  margin_frac=float(rng.choice([0.0, 0.08, 0.5, 2.0])))
        assert memscope.fit_report(plan, port_plan, **kw) == (
            jmemscope.fit_report(plan, ref_plan, **kw))
        assert port_plan.per_chip(plan.get("mesh_axes")) == (
            ref_plan.per_chip(plan.get("mesh_axes")))


def test_fit_report_without_a_plan_matches_the_reference():
    memscope.reset_scope()
    jmemscope.reset_scope()
    assert memscope.fit_report({"mesh_axes": {"dp": 2}}) == (
        jmemscope.fit_report({"mesh_axes": {"dp": 2}}))


# -- bucket byte accounting ----------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", ["int8_sharded", "int4_sharded",
                                  "blockwise_sharded", "exact_sharded",
                                  "int8"])
def test_estimate_bucket_bytes_matches_the_reference(mode, world):
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32),
                             device="cpu")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    layout = collectives.GradLayout(shapes, world)
    buckets = BucketLayout.build(layout, shapes, 64 * 1024)
    assert len(buckets) > 2
    port = collectives.estimate_bucket_bytes(
        buckets, collectives.GradSyncPolicy(mode=mode), world)
    ref = jcoll.estimate_bucket_bytes(
        buckets, jcoll.GradSyncPolicy(mode=mode), world)
    assert port == ref
    assert [r["bucket"] for r in port] == list(range(len(buckets)))


# -- the memory scope on the CPU ---------------------------------------------


def test_cpu_bytes_count_each_storage_once():
    before = memscope.device_mem_stats("cpu")[0]["used_b"]
    x = torch.zeros(1 << 20)  # 4 MiB
    views = [x[:10], x.view(1024, 1024), x[1:]]
    after = memscope.device_mem_stats("cpu")[0]
    assert after["source"] == "live_tensors"
    assert after["used_b"] - before == x.numel() * 4
    assert after["limit_b"] == 0.0 and after["peak_b"] == 0.0
    del views


def test_cpu_account_sums_to_used_and_keeps_the_cpu_limit(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_MEM_CPU_LIMIT_B", str(64 << 30))
    sc = memscope.reset_scope()
    sc.bind_device("cpu")
    sc.register_host_provider("ckpt_shm:a", lambda: 4096.0)
    sc.register_host_provider("gone", lambda: 1 / 0)
    acc = sc.sample()
    assert acc["account_ok"] and acc["account_sum_b"] == acc["used_b"]
    assert acc["limit_b"] == float(64 << 30)
    assert acc["headroom_b"] == round(acc["limit_b"] - acc["used_b"], 1)
    assert acc["host"]["shm"] == {"ckpt_shm:a": 4096.0, "gone": 0.0}
    digest = sc.digest()
    assert digest["mm_limit_b"] == float(64 << 30)
    assert digest["mms_other"] == acc["used_b"]
    sc.deregister_host_provider("gone")
    assert set(sc.sample()["host"]["shm"]) == {"ckpt_shm:a"}


def test_sample_is_guarded_and_off_when_disabled(monkeypatch):
    memscope.reset_scope(stats_reader=lambda: 1 / 0)
    acc = memscope.sample()
    assert acc is not None and acc["used_b"] == 0.0 and not acc["chips"]
    monkeypatch.setenv("DLROVER_TPU_MEM_SCOPE", "0")
    assert memscope.sample() is None


def test_a_cuda_device_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without a card")
    with pytest.raises(RuntimeError):
        memscope.device_mem_stats("cuda")
    with pytest.raises(RuntimeError):
        metric.collect_node_tpu_metrics(device="cuda")
    # the scope reads no bytes rather than the CPU's
    sc = memscope.reset_scope()
    sc.bind_device("cuda")
    assert sc.sample()["chips"] == []


# -- the compile scope's hook on the kernel build ---------------------------


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    compiler = tmp_path / "fake_nvcc"
    compiler.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "time.sleep(0.2)\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').close()\n")
    compiler.chmod(compiler.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc", lambda: str(compiler))
    jitscope.reset_scope()
    yield
    jitscope.reset_scope()


def test_a_watched_build_records_a_miss_then_a_hit(build_dir):
    assert jitscope.install()
    seen = []

    def listener(*resolved):
        seen.append(resolved)

    _build.add_listener(listener)
    try:
        step = jitscope.watch(
            lambda x: _build.build(["flash_attention"]) and x + 1,
            "trainer.train_step")
        step(torch.zeros(2))
        miss = step.last_event
        step(torch.zeros(2))  # the library exists now: a hit
        hit = step.last_event
        step(torch.zeros(3))
        shape = step.last_event
    finally:
        _build.remove_listener(listener)
    assert [s[:2] for s in seen] == [("flash_attention", False),
                                     ("flash_attention", True),
                                     ("flash_attention", True)]
    assert miss["trigger"] == "first-trace" and miss["cache"] == "miss"
    assert 0.2 <= miss["compile_s"] <= miss["dispatch_s"]
    assert hit["trigger"] == "retrace" and hit["cache"] == "hit"
    assert hit["compile_s"] == 0.0
    assert shape["trigger"] == "arg-shape-delta"
    d = jitscope.scope().digest()
    assert (d["js_seq"], d["js_hits"], d["js_misses"]) == (3.0, 2.0, 1.0)
    assert d["js_compile_s"] == miss["compile_s"] and d["js_cache"] == 1.0


def test_an_unwatched_call_and_a_disabled_scope_record_nothing(
        build_dir, monkeypatch):
    jitscope.install()
    step = jitscope.watch(lambda: _build.build(["ring_reduce_scatter"]),
                          "trainer.train_step")
    _build.build(["rdma_ring"])  # outside any watched call
    assert jitscope.scope().digest()["js_seq"] == 0.0
    monkeypatch.setenv("DLROVER_TPU_JITSCOPE", "0")
    step()
    assert step.last_event is None
    assert jitscope.scope().digest()["js_seq"] == 0.0
    assert jitscope.totals()["misses"] >= 2


# -- the kernel build directory as the persistent compile cache -------------


@pytest.fixture
def boot_state(build_dir, monkeypatch):
    """No boot state recorded yet, no knob, a first boot."""
    from dlrover_tpu_torch.trainer import bootstrap

    monkeypatch.setattr(bootstrap, "_cache_status", None)
    monkeypatch.setattr(bootstrap, "_worker_ctx", bootstrap.WorkerContext())
    monkeypatch.delenv("DLROVER_TPU_COMPILE_CACHE", raising=False)
    return bootstrap


def test_compile_cache_info_before_and_after_a_build(boot_state):
    from dlrover_tpu.trainer import bootstrap as jbootstrap

    bootstrap = boot_state
    info = bootstrap.compile_cache_info()
    assert set(info) == set(jbootstrap.compile_cache_info())
    assert info == {"enabled": True, "dir": str(_build.BUILD_DIR),
                    "reason": "not-initialized", "entries_at_boot": 0,
                    "restart": False}
    bootstrap._setup_compile_cache()  # a first boot: an empty directory
    info = bootstrap.compile_cache_info()
    assert (info["enabled"], info["dir"], info["entries_at_boot"],
            info["restart"]) == (True, str(_build.BUILD_DIR), 0, False)
    sc = jitscope.reset_scope()
    assert (sc.warm_expected, sc.cache_enabled) == (False, True)
    _build.build(["flash_attention", "rdma_ring"])
    assert len(os.listdir(_build.BUILD_DIR)) == 4  # two libraries, two logs
    bootstrap._setup_compile_cache()  # the next boot finds them
    assert bootstrap.compile_cache_info()["entries_at_boot"] == 2
    sc = jitscope.reset_scope()
    assert (sc.warm_expected, sc.cache_enabled) == (True, True)
    d = sc.digest()
    assert (d["js_warm"], d["js_cache"]) == (1.0, 1.0)


def test_compile_cache_info_under_a_restart_and_the_knob(
        boot_state, tmp_path, monkeypatch):
    bootstrap = boot_state
    monkeypatch.setattr(bootstrap, "_worker_ctx",
                        bootstrap.WorkerContext(restart_count=1))
    bootstrap._setup_compile_cache()
    info = bootstrap.compile_cache_info()
    assert info["restart"] and info["entries_at_boot"] == 0
    assert jitscope.reset_scope().warm_expected  # a restart expects warmth
    knob = tmp_path / "cache_from_knob"
    monkeypatch.setenv("DLROVER_TPU_COMPILE_CACHE", str(knob))
    assert _build.build_dir() == knob
    _build.build(["ring_reduce_scatter"])
    assert _build.library_path("ring_reduce_scatter").parent == knob
    assert _build.library_path("ring_reduce_scatter").exists()
    assert not list(_build.BUILD_DIR.glob("*.so"))
    bootstrap._setup_compile_cache()
    assert bootstrap.compile_cache_info()["dir"] == str(knob)
    assert bootstrap.compile_cache_info()["entries_at_boot"] == 1


def test_compile_cache_off_builds_into_a_directory_of_its_own(
        boot_state, monkeypatch):
    bootstrap = boot_state
    monkeypatch.setenv("DLROVER_TPU_COMPILE_CACHE", "off")
    monkeypatch.setattr(_build, "_private_dir", None)
    assert bootstrap.compile_cache_info()["enabled"] is False
    bootstrap._setup_compile_cache()
    info = bootstrap.compile_cache_info()
    assert (info["enabled"], info["reason"]) == (False, "env-off")
    assert jitscope.reset_scope().cache_enabled is False
    path = _build.build(["rdma_ring"])["rdma_ring"]
    assert path.parent != _build.BUILD_DIR and path.exists()
    assert not _build.BUILD_DIR.exists()


def test_persistent_cache_override_restores_on_exit_even_on_an_error(
        build_dir, tmp_path):
    """The override builds into its directory with an empty library memo;
    a library loaded before stays in the memo after it, untouched."""
    loaded = object()  # stands for a ctypes handle an earlier phase holds
    _build._libs["flash_attention"] = loaded
    inner = tmp_path / "override"
    try:
        with pytest.raises(RuntimeError, match="inside"):
            with jitscope.persistent_cache_override(str(inner)):
                assert _build.build_dir() == inner
                assert "flash_attention" not in _build._libs
                with jitscope.persistent_cache_override(str(tmp_path / "n")):
                    assert _build.build_dir() == tmp_path / "n"
                assert _build.build_dir() == inner
                _build.build(["flash_attention"])
                raise RuntimeError("inside")
        assert _build.build_dir() == _build.BUILD_DIR
        assert _build._libs["flash_attention"] is loaded
        assert len(list(inner.glob("libflash_attention_*.so"))) == 1
        assert not _build.BUILD_DIR.exists()
    finally:
        _build._libs.pop("flash_attention", None)


def test_a_wiped_override_directory_is_a_persistent_cache_miss(build_dir,
                                                                tmp_path):
    jitscope.install()
    cache = tmp_path / "cache"
    events = []
    with jitscope.persistent_cache_override(str(cache)):
        for warm in (False, True, True):
            if len(events) == 2:
                for path in cache.iterdir():
                    path.unlink()
            jitscope.reset_scope(warm_expected=warm, cache_enabled=True)
            step = jitscope.watch(lambda: _build.build(["flash_attention"]),
                                  "drill.step")
            step()
            events.append(step.last_event)
    assert [(e["trigger"], e["cache"]) for e in events] == [
        ("first-trace", "miss"), ("first-trace", "hit"),
        ("persistent-cache-miss", "miss")]


# -- the comm probe ----------------------------------------------------------


@pytest.mark.parametrize("slow", ["dp", "fsdp", "tp"])
def test_mesh_probe_prices_one_slow_axis_alone(slow):
    """A runner that takes 20 ms for one axis's latency probe (the slow
    link) and nothing for the rest: the model prices that axis alone
    above 20 ms a hop, and the bandwidth probes are priced by the ring
    all-reduce accounting of the actual payload."""
    def runner(axis, kind):
        if axis == slow and kind == "lat":
            time.sleep(0.02)

    model = commscope.FabricModel(alpha=1.0)
    probe = commscope.MeshProbe({"dp": 4, "fsdp": 2, "tp": 2, "cp": 1},
                                runner=runner, reps=2, bw_bytes=1000)
    samples = probe.probe_once(model)
    assert sorted(samples) == ["dp", "fsdp", "tp"]
    lat = {a: model.get(a)["lat_us"] for a in samples}
    assert lat[slow] >= 20_000
    assert all(v < 5_000 for a, v in lat.items() if a != slow), lat
    assert probe.probes_done == 1
    assert set(model.digest()) == {f"{p}{a}" for a in samples
                                   for p in ("fxl_", "fxb_")}


def test_probe_spans_and_gauges_reach_the_recorder_and_registry():
    flight_recorder.recorder().reset()
    metrics.registry().reset()
    probe = commscope.MeshProbe({"dp": 2}, runner=lambda a, k: None, reps=1)
    probe.probe_once(commscope.reset_scope().fabric)
    names = [s["name"] for s in flight_recorder.recorder().spans]
    assert "comm.probe.dp" in names
    reg = metrics.registry()
    assert reg.counter_value("dlrover_tpu_comm_probes_total", axis="dp") == 1
    assert reg.gauge_value("dlrover_tpu_comm_probe_latency_us", axis="dp") \
        == commscope.scope().fabric.snapshot()["dp"]["lat_us"]
    assert commscope.MeshProbe.for_group("dp", None) is None
    assert commscope.MeshProbe.for_mesh(None) is None


# -- spans and the emitter -----------------------------------------------------


def test_emit_span_reaches_a_memory_exporter():
    exporter = MemoryExporter()
    proc = Process("trainer", exporter)
    trace.set_span_sink(proc.emit_span)
    try:
        with trace.span("flash.save", attrs={"step": 3}) as outer:
            with trace.span("mem.sample") as inner:
                proc.instant("inside")
    finally:
        trace.set_span_sink(None)
    spans = [e for e in exporter.events if e["type"] == EventType.SPAN]
    assert [s["name"] for s in spans] == ["mem.sample", "flash.save"]
    assert spans[0]["parent_span_id"] == outer.span_id
    assert spans[0]["trace_id"] == spans[1]["trace_id"]
    assert all(s["target"] == "trainer" and s["pid"] == os.getpid()
               for s in spans)
    assert spans[1]["attrs"] == {"step": 3}
    instant = [e for e in exporter.events if e["name"] == "inside"][0]
    assert instant["span_id"] == inner.span_id
    assert flight_recorder.recorder().events[-1]["name"] == "inside"


def test_span_feeds_the_recorder_and_the_ledger(clock, monkeypatch):
    monkeypatch.setattr(goodput, "_LEDGER", None)
    ledger = goodput.reset_ledger(origin_ts=clock["t"] - 10)
    trace.set_span_sink(lambda record: None)
    try:
        with trace.span("flash.save"):
            clock["t"] += 2.0
    finally:
        trace.set_span_sink(None)
    assert flight_recorder.recorder().spans[-1]["name"] == "flash.save"
    assert ledger.summary()["phases"]["ckpt_stall"] == 2.0
    monkeypatch.setenv("DLROVER_TPU_TRACE", "0")
    with trace.span("off") as sp:
        assert sp is trace.NOOP_SPAN


def test_span_opens_a_profiler_range():
    from torch.profiler import ProfilerActivity, profile

    trace.set_span_sink(lambda record: None)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("comm.bucket7"):
                torch.ones(4).sum()
    finally:
        trace.set_span_sink(None)
    assert "comm.bucket7" in {e.name for e in prof.events()}


def test_constants_and_knobs_match_the_reference():
    from dlrover_tpu.common import envs as jenvs
    from dlrover_tpu.common.constants import ConfigPath as JConfigPath
    from dlrover_tpu_torch.common import envs
    from dlrover_tpu_torch.common.constants import ConfigPath

    assert ConfigPath.ENV_RUNTIME_METRICS == JConfigPath.ENV_RUNTIME_METRICS
    assert os.path.basename(ConfigPath.RUNTIME_METRICS) == os.path.basename(
        JConfigPath.RUNTIME_METRICS)
    for name in envs.DEFAULTS:
        if name.endswith(("_DIR", "_PATH")):
            continue  # under the process's temp dir here
        want = jenvs.knob(name).default
        assert envs.DEFAULTS[name] == want, name
    assert not math.isnan(envs.get_float("DLROVER_TPU_COMM_EWMA_ALPHA"))
