"""The port's perf-regression sentinels against the JAX package's, on the
CPU.

The same value sequences (the cases of ``tests/test_sentinel.py`` and
sequences drawn from a seed) go through both packages' EWMA+MAD detector
and must give the same breach dicts; the same series, digests and
recovery reports go into both packages' stores and each sentinel must
give the same observations (fired, detail, extra) round after round;
``compare_round`` must give the same verdicts on synthetic trajectories.
``register_sentinels`` registers the reference's ten in its order, and the
local master runs them over the servicer's store, which its incident
engine reads too: an ``hbm_oom`` incident embeds the culprit's ``mem.*``
series as the reference's does."""

import json
import os
import time

import numpy as np
import pytest

from dlrover_tpu.master import timeseries as jts
from dlrover_tpu.observability import sentinel as jsentinel
from dlrover_tpu_torch.master import timeseries as ts
from dlrover_tpu_torch.observability import sentinel

DET_KW = dict(alpha=0.25, k=4.0, min_samples=4, consecutive=1)


def _both(fn):
    return fn(sentinel), fn(jsentinel)


# -- the detector -------------------------------------------------------------


def _seeded_values(seed, n=200):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.05, 2.0)
    out = []
    for i in range(n):
        jump = 1.0 + (5.0 if rng.random() < 0.05 else 0.0)
        out.append(float(base * jump * (1.0 + 0.02 * rng.normal())))
        if rng.random() < 0.02:
            base *= float(rng.uniform(0.5, 3.0))
    return out


DETECTOR_CASES = {
    "stable": (dict(direction="up"),
               [0.05 + 0.0005 * (i % 3) for i in range(50)]),
    "up_breach": (dict(direction="up"), [0.05] * 10 + [0.5]),
    "down_breach_only_downward": (dict(direction="down"),
                                  [0.9] * 10 + [5.0, 0.2]),
    "cold": (dict(min_samples=8), [0.05, 100.0]),
    "consecutive": (dict(consecutive=3), [1.0] * 10 + [5.0] * 3),
    "streak_reset": (dict(consecutive=2), [1.0] * 10 + [5.0, 1.0, 5.0]),
    "rebaseline": ({}, [1.0] * 10 + [5.0] + [5.0] * 10 + [25.0]),
    "rel_floor": (dict(rel_floor=0.10), [1.0] * 20 + [1.05, 1.2]),
    "abs_floor": (dict(abs_floor=0.10), [0.0] * 10 + [0.05, 0.5]),
    "good_regime_change": (dict(consecutive=2),
                           [1.0] * 10 + [0.2] * 3 + [1.0] * 3),
    "seeded_up": (dict(direction="up", consecutive=2), _seeded_values(1)),
    "seeded_down": (dict(direction="down"), _seeded_values(2)),
}


@pytest.mark.parametrize("case", sorted(DETECTOR_CASES))
def test_the_detector_matches_the_reference(case):
    kw, values = DETECTOR_CASES[case]
    kw = dict(DET_KW, **kw)
    port, ref = _both(lambda m: m.EwmaMadDetector(**kw))
    got = [port.update(v) for v in values]
    want = [ref.update(v) for v in values]
    assert got == want
    assert (port.baseline, port.mad, port.samples) == (
        ref.baseline, ref.mad, ref.samples)


def test_detector_knobs_and_refusal_match(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_SENTINEL_MAD_K", "9.0")
    monkeypatch.setenv("DLROVER_TPU_SENTINEL_CONSECUTIVE", "5")
    port, ref = _both(lambda m: m.EwmaMadDetector())
    assert (port.k, port.consecutive, port.alpha, port.min_samples) == (
        ref.k, ref.consecutive, ref.alpha, ref.min_samples) == (
        9.0, 5, 0.25, 8)
    for m in (sentinel, jsentinel):
        with pytest.raises(ValueError):
            m.EwmaMadDetector(direction="sideways")


# -- the sentinels over one script of store writes -----------------------------


def _observe(diag):
    obs = diag.observe()
    return (bool(obs.observed), obs.detail, obs.extra,
            getattr(diag, "incident_kind", ""))


def _series_script(name, values, spacing=1.0):
    def build(now):
        t0 = now - len(values) * spacing - 2
        return [("add", name, v, t0 + i * spacing)
                for i, v in enumerate(values)]
    return build


SERIES_CASES = {
    "GoodputRegressionDiagnostician": _series_script(
        "job.goodput", [0.95] * 8 + [0.1, 0.1, 0.95]),
    "StepTimeRegressionDiagnostician": _series_script(
        "job.step_p50_s", [0.05] * 8 + [0.4, 0.4, 0.05]),
    "ExposedCommDiagnostician": _series_script(
        "job.share.exposed_comm", [0.02] * 8 + [0.5, 0.5, 0.02]),
    "CkptShareDiagnostician": _series_script(
        "job.share.ckpt_stall", [0.0] * 10 + [0.05, 0.0, 0.6, 0.6, 0.0]),
    "DataStarvationDiagnostician": _series_script(
        "job.share.input_starved", [0.01] * 9 + [0.4, 0.4, 0.01]),
    "ShardLatencyRegressionDiagnostician": _series_script(
        "job.data.lease_p99_ms", [3.0] * 9 + [400.0, 400.0, 3.0]),
}


@pytest.mark.parametrize("cls", sorted(SERIES_CASES))
@pytest.mark.parametrize("tuned", [False, True])
def test_series_sentinels_match_the_reference(cls, tuned):
    now = float(int(time.time()))
    ops = SERIES_CASES[cls](now)
    port_store, ref_store = ts.TimeSeriesStore(), jts.TimeSeriesStore()
    for store in (port_store, ref_store):
        for _, name, value, t in ops:
            store.add(name, value, ts=t)
    port = getattr(sentinel, cls)(port_store, res_s=1.0)
    ref = getattr(jsentinel, cls)(ref_store, res_s=1.0)
    if tuned:  # the reference test's warm-up, so the breach can fire
        port._detector = sentinel.EwmaMadDetector(
            direction=port.direction, abs_floor=port.abs_floor, **DET_KW)
        ref._detector = jsentinel.EwmaMadDetector(
            direction=ref.direction, abs_floor=ref.abs_floor, **DET_KW)
    rounds = [(_observe(port), _observe(ref)) for _ in range(3)]
    for got, want in rounds:
        assert got == want
    assert (port.name, port.incident_kind, port.series, port.direction,
            port.phase_hint, port.abs_floor) == (
        ref.name, ref.incident_kind, ref.series, ref.direction,
        ref.phase_hint, ref.abs_floor)
    if tuned and cls != "CkptShareDiagnostician":
        assert rounds[0][0][0]  # the breach fired


def _run_script(ops, make, rounds=1):
    """Apply ``ops`` to a store of each package; ``make(module, store)``
    builds the sentinel; observe after each step marked ``observe``."""
    port_store, ref_store = ts.TimeSeriesStore(), jts.TimeSeriesStore()
    port = make(sentinel, port_store)
    ref = make(jsentinel, ref_store)
    seen = []
    for op in ops:
        for store in (port_store, ref_store):
            if op[0] == "add":
                store.add(op[1], op[2], ts=op[3])
            elif op[0] == "digest":
                store.record_digest(op[1], dict(op[2]), ts=op[3])
            elif op[0] == "recovery":
                store.record_recovery(dict(op[1]), ts=op[2])
        if op[0] == "observe":
            seen.append((_observe(port), _observe(ref)))
    for _ in range(rounds):
        seen.append((_observe(port), _observe(ref)))
    return seen


def _assert_same(seen):
    assert seen
    for got, want in seen:
        assert got == want
    return [got for got, _ in seen]


def test_slow_link_matches_the_reference(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_SENTINEL_MIN_SAMPLES", "3")
    monkeypatch.setenv("DLROVER_TPU_SENTINEL_CONSECUTIVE", "1")
    now = float(int(time.time()))
    ops = []
    for i in range(12):
        for node in (0, 1, 2):
            slow = 40.0 if (node == 1 and i >= 6) else 1.0
            ops.append(("digest", node, {
                "fxl_dp": 1000.0 * slow + node, "fxb_dp": 5.0 / slow,
                "fxl_fsdp": 300.0, "fxb_fsdp": 12.0,
            }, now - 14 + i))
        ops.append(("observe",))
    seen = _assert_same(_run_script(
        ops, lambda m, store: m.SlowLinkDiagnostician(store, res_s=1.0),
        rounds=3))
    fired = [s for s in seen if s[0]]
    assert fired and fired[0][2]["culprit"] == 1
    assert fired[0][2]["axis"] == "dp"


def test_slow_link_reports_a_hook_s_answer_as_the_reference(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_SENTINEL_MIN_SAMPLES", "3")
    monkeypatch.setenv("DLROVER_TPU_SENTINEL_CONSECUTIVE", "1")
    now = float(int(time.time()))
    ops = [("add", "job.comm.slice.lat_us", 100.0 if i < 8 else 9000.0,
            now - 12 + i) for i in range(12)]
    for answer in ("int4", "action_channel", "rerouted"):
        seen = _assert_same(_run_script(
            ops, lambda m, store: m.SlowLinkDiagnostician(
                store, res_s=1.0,
                demotion_hook=lambda axis, metric, breach: answer)))
        assert seen[0][0] and seen[0][2]["dcn_demoted_to"] == answer


def test_mem_pressure_matches_the_reference(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_MEM_EWMA_ALPHA", "1.0")
    monkeypatch.setenv("DLROVER_TPU_MEM_LEAK_SLOPE_B_S", str(64 * 2 ** 20))
    gib = float(2 ** 30)
    now = float(int(time.time()))
    ops = []
    for i in range(10):
        # node 0 leaks toward its limit; node 1 sits under the floor
        ops.append(("digest", 0, {
            "mm_ts": now - 20 + i, "mm_used_b": 4 * gib + i * 0.4 * gib,
            "mm_limit_b": 8 * gib, "mms_params": gib}, now - 20 + i))
        if i < 3:
            ops.append(("digest", 1, {
                "mm_ts": now - 20 + i, "mm_used_b": 7.8 * gib,
                "mm_limit_b": 8 * gib}, now - 20 + i))
        ops.append(("observe",))
    seen = _assert_same(_run_script(
        ops, lambda m, store: m.MemPressureSentinel(store), rounds=2))
    kinds = {s[3] for s in seen if s[0]}
    assert kinds == {"hbm_leak", "mem_pressure"}


def test_compile_sentinel_matches_the_reference(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_CACHE_COLD_RATIO", "0.5")
    monkeypatch.setenv("DLROVER_TPU_SENTINEL_CONSECUTIVE", "2")
    now = float(int(time.time()))

    def js(seq, compile_s, hits, misses, t, boot, warm):
        return {"js_ts": t, "js_boot": boot, "js_seq": float(seq),
                "js_compile_s": compile_s, "js_hits": float(hits),
                "js_misses": float(misses), "js_stalls": 0.0,
                "js_warm": warm, "js_cache": 1.0}

    base = now - 400
    ops = [("add", "job.compile.s", 0.2 if i < 10 else 30.0, base + i * 10)
           for i in range(14)]
    ops += [
        ("digest", 0, js(1, 8.0, 0, 1, now - 50, now - 51, 0.0), now - 49),
        ("observe",),
        ("digest", 0, js(1, 0.0, 1, 0, now - 40, now - 41, 1.0), now - 39),
        ("observe",),
        ("digest", 0, js(1, 8.5, 0, 1, now - 30, now - 31, 1.0), now - 29),
        ("observe",),
        ("observe",),
    ]
    seen = _assert_same(_run_script(
        ops, lambda m, store: m.CompileSentinel(store), rounds=2))
    kinds = {s[3] for s in seen if s[0]}
    assert kinds == {"cache_cold", "recompile_storm"}


def test_mttr_sentinel_matches_the_reference(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_MTTR_BUDGET_S", "2.0")
    now = float(int(time.time()))
    reports = [
        {"process_id": 1, "step": 5, "rung": "peer_shm", "mttr_s": 0.5,
         "budget_s": 30.0},
        {"process_id": 2, "step": 6, "rung": "manifest", "mttr_s": 3.0},
        {"process_id": 3, "step": 7, "rung": "peer_shm", "mttr_s": 9.0,
         "budget_s": 5.0, "storage_reads": 2},
        {"process_id": 0, "step": 8, "rung": "", "mttr_s": 1.0,
         "budget_s": 0.5},
    ]
    ops = []
    for i, report in enumerate(reports):
        ops.append(("recovery", report, now - 10 + i))
        ops.append(("observe",))
    seen = _assert_same(_run_script(
        ops, lambda m, store: m.MttrSentinel(store), rounds=2))
    assert [s[0] for s in seen] == [False, True, True, True, False, False]
    monkeypatch.setenv("DLROVER_TPU_MTTR_BUDGET_S", "0")
    quiet = _assert_same(_run_script(
        ops[:4], lambda m, store: m.MttrSentinel(store)))
    assert not any(s[0] for s in quiet[:1])


# -- the bench-side gate --------------------------------------------------------


def _round(step_ms, tokens, vs=1.0, tpu_down=False, preset="default",
           **extra):
    return {"step_ms": step_ms, "tokens_per_sec": tokens,
            "vs_baseline": vs, "tpu_unavailable": tpu_down,
            "preset": preset, **extra}


def _trajectory(seed):
    rng = np.random.default_rng(seed)
    history = []
    for _ in range(12):
        history.append(_round(
            float(rng.normal(100, 2)), float(rng.normal(1000, 20)),
            recovery_mttr_s=float(rng.uniform(10, 12)),
            peer_read_gbps=float(rng.uniform(5, 6)),
            compile_s=float(rng.uniform(1, 2))))
    current = _round(float(rng.choice([101.0, 180.0])),
                     float(rng.choice([990.0, 400.0])),
                     recovery_mttr_s=float(rng.choice([11.0, 40.0])),
                     peer_read_gbps=5.5, compile_s=1.5)
    return history, current


GATE_CASES = {
    "cold": lambda: ([], _round(100, 1000)),
    "stable": lambda: ([_round(100 + i % 3, 1000 - i % 5) for i in range(10)],
                       _round(101, 999)),
    "step_regression": lambda: ([_round(100, 1000)] * 10, _round(250, 1000)),
    "throughput_drop": lambda: ([_round(100, 1000)] * 10, _round(100, 300)),
    "improvement": lambda: ([_round(100, 1000)] * 10, _round(100, 5000)),
    "incomparable": lambda: ([_round(100, 1000)] * 10,
                             _round(5000, 20, tpu_down=True, preset="tiny")),
    "own_cohort": lambda: (
        [dict(_round(5000, 20, vs=300.0, tpu_down=True, preset="tiny"),
              headline_source="watcher")] * 10,
        _round(5000, 20, vs=0.0, tpu_down=True, preset="tiny")),
    "missing_metric": lambda: ([_round(100, 1000)] * 10,
                               {"preset": "default", "tpu_unavailable": False,
                                "vs_baseline": 1.0}),
    "seeded_0": lambda: _trajectory(0),
    "seeded_1": lambda: _trajectory(1),
    "seeded_2": lambda: _trajectory(2),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_compare_round_matches_the_reference(case, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_SENTINEL_MIN_SAMPLES", "4")
    history, current = GATE_CASES[case]()
    got = sentinel.compare_round(history, current)
    want = jsentinel.compare_round(history, current)
    got.pop("ts")
    want.pop("ts")
    assert got == want
    assert sentinel.BENCH_WATCH == jsentinel.BENCH_WATCH


# -- registration and the local master -----------------------------------------


def test_register_sentinels_registers_the_reference_s_ten():
    from dlrover_tpu.diagnosis.diagnostician import (
        DiagnosisManager as JDiagnosisManager,
    )
    from dlrover_tpu_torch.diagnosis.diagnostician import DiagnosisManager

    manager = DiagnosisManager()
    got = sentinel.register_sentinels(manager, ts.TimeSeriesStore(),
                                      job_context=object())
    want = jsentinel.register_sentinels(JDiagnosisManager(),
                                        jts.TimeSeriesStore())
    assert [type(s).__name__ for s in got] == [
        type(s).__name__ for s in want]
    assert [(s.name, s.incident_kind) for s in got] == [
        (s.name, s.incident_kind) for s in want]
    assert len(got) == 10
    assert manager._diagnosticians == got
    # the slow-link sentinel has no DCN demotion hook in the port
    slow = [s for s in got if s.name == "slow_link"][0]
    assert slow._demotion_hook is None
    assert manager.diagnose_once() == []


def test_breach_counter_recorded():
    from dlrover_tpu_torch.observability import metrics

    store = ts.TimeSeriesStore()
    for op in SERIES_CASES["GoodputRegressionDiagnostician"](time.time()):
        store.add(op[1], op[2], ts=op[3])
    diag = sentinel.GoodputRegressionDiagnostician(store, res_s=1.0)
    diag._detector = sentinel.EwmaMadDetector(direction="down", **DET_KW)
    labels = dict(series="job.goodput", detector="goodput_regression")
    before = metrics.registry().counter_value(
        "dlrover_tpu_sentinel_breaches_total", **labels) or 0.0
    assert diag.observe().observed
    assert metrics.registry().counter_value(
        "dlrover_tpu_sentinel_breaches_total", **labels) == before + 1


@pytest.fixture
def incident_dir(tmp_path, monkeypatch):
    from dlrover_tpu_torch.observability import flight_recorder

    monkeypatch.setenv("DLROVER_TPU_INCIDENT_DIR", str(tmp_path / "inc"))
    monkeypatch.setenv("DLROVER_TPU_INCIDENT_COOLDOWN_S", "0")
    monkeypatch.setenv("DLROVER_TPU_INCIDENT_GRACE_S", "0")
    flight_recorder.recorder().reset()
    return tmp_path / "inc"


def test_a_fired_sentinel_opens_a_classified_incident(incident_dir):
    from dlrover_tpu_torch.diagnosis.diagnostician import DiagnosisManager
    from dlrover_tpu_torch.observability.incidents import IncidentManager

    store = ts.TimeSeriesStore()
    for op in SERIES_CASES["GoodputRegressionDiagnostician"](time.time()):
        store.add(op[1], op[2], ts=op[3])
    diag = sentinel.GoodputRegressionDiagnostician(store, res_s=1.0)
    diag._detector = sentinel.EwmaMadDetector(direction="down", **DET_KW)
    manager = DiagnosisManager()
    manager.register(diag)
    incidents = IncidentManager()
    incidents.set_timeseries(store)
    manager.set_incident_manager(incidents)
    assert [a.action_type for a in manager.diagnose_once()] == ["event"]
    listed = incidents.list_incidents()
    assert [i["kind"] for i in listed] == ["goodput_regression"]
    incident = incidents.finalize(listed[0]["incident_id"], force=True)
    # the incident timeline carries the goodput curve it landed on
    assert incident["timeline"]["counters"] > 0


def test_the_local_master_runs_the_sentinels_over_its_store():
    from dlrover_tpu_torch.diagnosis.diagnostician import DiagnosisManager
    from dlrover_tpu_torch.master.local_master import LocalJobMaster

    master = LocalJobMaster(port=0, node_num=1)
    try:
        registered = master.diagnosis_manager._diagnosticians
        names = [type(d).__name__ for d in registered]
        assert names[0] == "TrainingHangDiagnostician"
        assert names[1:] == [type(s).__name__ for s in
                             sentinel.register_sentinels(
                                 DiagnosisManager(),
                                 master.servicer.timeseries)]
        assert all(d._store is master.servicer.timeseries
                   for d in registered[1:])
        assert master.incident_manager._timeseries is \
            master.servicer.timeseries
    finally:
        master.stop()


def test_an_hbm_oom_incident_embeds_the_culprit_s_mem_series(incident_dir):
    """As the reference's: the memory evidence of an ``hbm_oom`` incident
    holds the culprit node's ``mem.*`` series from the attached store."""
    from dlrover_tpu.diagnosis.diagnostician import (
        DiagnosisManager as JDiagnosisManager,
    )
    from dlrover_tpu.observability.incidents import (
        IncidentManager as JIncidentManager,
    )
    from dlrover_tpu_torch.common import comm
    from dlrover_tpu_torch.diagnosis.diagnostician import DiagnosisManager
    from dlrover_tpu_torch.observability.incidents import IncidentManager

    gib = float(2 ** 30)
    now = float(int(time.time()))
    out = []
    for store, manager, diagnosis in (
            (ts.TimeSeriesStore(), IncidentManager(), DiagnosisManager()),
            (jts.TimeSeriesStore(), JIncidentManager(), JDiagnosisManager())):
        for i in range(6):
            store.record_digest(2, {
                "mm_ts": now - 10 + i, "mm_used_b": 6 * gib + i * gib / 4,
                "mm_limit_b": 8 * gib, "mms_params": gib}, ts=now - 10 + i)
        manager.set_timeseries(store)
        diagnosis.set_incident_manager(manager)
        diagnosis.report_failure(comm.NodeFailureRequest(
            node_id=2, error_data="worker died: signature=hbm_oom"))
        listed = manager.list_incidents()
        incident = manager.finalize(listed[0]["incident_id"], force=True)
        path = os.path.join(manager.incident_dir(listed[0]["incident_id"]),
                            "INCIDENT.json")
        with open(path) as f:
            on_disk = json.load(f)
        out.append((incident["kind"], incident["phase"],
                    on_disk["mem"]["series"]))
    assert out[0] == out[1]
    kind, phase, series = out[0]
    assert (kind, phase) == ("hbm_oom", "mem")
    assert "node2.mem.used_b" in series and "node2.mem.headroom_frac" in series
