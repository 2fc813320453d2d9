"""The port's chaos engine and its chaos points against the JAX package.

The engine (``dlrover_tpu_torch.chaos``) must make the reference's fire
decisions for the same plan, seed and call sequence: the same returned
kinds, the same raised messages, the same trace.  Every scenario plan
serializes byte-equal.  Then one case per chaos point of the ported
modules drives the site in both packages on the same inputs and
compares the effects."""

import json
import os
import threading
import time
import uuid
import zlib

import numpy as np
import pytest
import torch

from dlrover_tpu import chaos as jchaos
from dlrover_tpu_torch import chaos


@pytest.fixture(autouse=True)
def _disarmed(monkeypatch):
    for name in ("DLROVER_TPU_CHAOS", "DLROVER_TPU_CHAOS_SPEC",
                 "DLROVER_TPU_CHAOS_SEED", "DLROVER_TPU_CHAOS_TRACE_FILE"):
        monkeypatch.delenv(name, raising=False)
    chaos.clear()
    jchaos.clear()
    yield
    chaos.clear()
    jchaos.clear()


# ---------------------------------------------------------------------------
# The engine: fire decisions, kinds, messages and traces.
# ---------------------------------------------------------------------------

POINTS = ("kv_store.get", "kv_store.set", "kv_server.wait", "storage.write",
          "rdzv.join", "cb.point", "snapshot.stream_chunk")

PLANS = {
    "exception_on_calls": [dict(point="storage.write", kind="exception",
                                on_calls=[1, 3, 7], message="boom")],
    "exception_default_message": [dict(point="rdzv.join", kind="exception",
                                       after=2, times=2)],
    "delay_after_every": [dict(point="kv_store.get", kind="delay",
                               after=1, every=2, delay_s=0.0)],
    "torn_times": [dict(point="storage.write", kind="torn_write", times=2)],
    "drop_probability": [dict(point="kv_store.set", kind="drop",
                              probability=0.3)],
    "flap_count": [dict(point="rdzv.join", kind="flap", on_calls=[2],
                        flap_count=3)],
    "glob": [dict(point="kv_*.*", kind="drop", after=2, every=3),
             dict(point="*.stream_chunk", kind="exception",
                  probability=0.5, times=3)],
    "callback": [dict(point="cb.point", kind="callback", every=4)],
    "every_kind": [
        dict(point="storage.write", kind="delay", probability=0.4),
        dict(point="kv_store.get", kind="drop", on_calls=[0, 5, 9]),
        dict(point="kv_server.wait", kind="flap", after=3, flap_count=2,
             times=2),
        dict(point="rdzv.join", kind="torn_write", every=5),
        dict(point="snapshot.stream_chunk", kind="exception", after=4,
             probability=0.7, times=4),
        dict(point="cb.point", kind="callback", probability=0.5),
    ],
}


def _script(seed: int, n: int = 160):
    rng = np.random.default_rng(seed)
    return [POINTS[i] for i in rng.integers(0, len(POINTS), size=n)]


def _drive(pkg, specs, seed, calls):
    seen = []

    def on_cb(**ctx):
        seen.append(("cb", ctx.get("i")))

    faults = []
    for spec in specs:
        spec = dict(spec)
        if spec["kind"] == "callback":
            spec["callback"] = on_cb
        faults.append(pkg.FaultSpec(**spec))
    eng = pkg.ChaosEngine()
    eng.arm(pkg.ChaosPlan(name="parity", seed=seed, faults=faults))
    out = []
    for i, name in enumerate(calls):
        try:
            fault = eng.point(name, i=i)
        except Exception as e:  # noqa: BLE001 - the compared outcome
            out.append(("raise", type(e).__name__, str(e)))
            continue
        out.append(None if fault is None else (fault.kind, fault.point,
                                               fault.call_index, fault.seq))
    counts = {p: eng.call_count(p) for p in POINTS}
    return out, eng.trace(), seen, counts


@pytest.mark.parametrize("seed", [0, 1, 7, 13])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_engine_fire_decisions_match_reference(plan, seed):
    calls = _script(seed)
    got = _drive(chaos, PLANS[plan], seed, calls)
    want = _drive(jchaos, PLANS[plan], seed, calls)
    assert got[0] == want[0]  # decisions, kinds, raised messages
    assert got[1] == want[1]  # the trace records
    assert got[2] == want[2]  # callbacks with their context
    assert got[3] == want[3]  # per-point call counters
    assert any(r is not None for r in got[0]), "the plan never fired"


def test_engine_normalized_traces_match_reference():
    from dlrover_tpu.diagnosis import chaos_drill as jdrill
    from dlrover_tpu_torch.diagnosis import chaos_drill as drill
    from dlrover_tpu_torch.observability import trace

    def run(pkg, span_mod):
        pkg.configure(pkg.ChaosPlan(name="t", seed=3, faults=[
            pkg.FaultSpec(point="kv_store.get", kind="drop", every=2)]))
        try:
            for i in range(6):
                if i % 3 == 0:
                    with span_mod.span("kv.get"):
                        pkg.point("kv_store.get")
                else:
                    pkg.point("kv_store.get")
            return pkg.trace()
        finally:
            pkg.clear()

    from dlrover_tpu.observability import trace as jtrace

    got = drill.normalized_trace(run(chaos, trace))
    want = jdrill.normalized_trace(run(jchaos, jtrace))
    assert got == want
    assert [r["span_id"] for r in got] == [True, False, False]


def test_fault_becomes_an_event_on_the_live_span():
    from dlrover_tpu_torch.observability import flight_recorder, trace

    records = []
    trace.set_span_sink(records.append)
    try:
        chaos.configure(chaos.ChaosPlan(seed=0, faults=[
            chaos.FaultSpec(point="storage.write", kind="drop")]))
        with trace.span("flash.persist"):
            chaos.point("storage.write")
    finally:
        trace.set_span_sink(None)
    events = records[-1]["events"]
    assert events[0]["name"] == "chaos.fault"
    assert events[0]["attrs"]["point"] == "storage.write"
    ring = [e for e in flight_recorder.recorder().events
            if e.get("type") == "CHAOS"]
    assert ring and ring[-1]["point"] == "storage.write"


@pytest.mark.parametrize("seed", [0, 13])
def test_scenario_plans_serialize_byte_equal(seed):
    assert sorted(chaos.SCENARIOS) == sorted(jchaos.SCENARIOS)
    for name in chaos.SCENARIOS:
        assert (chaos.scenario_plan(name, seed).to_json()
                == jchaos.scenario_plan(name, seed).to_json()), name
        back = chaos.ChaosPlan.from_json(
            jchaos.scenario_plan(name, seed).to_json())
        assert back.to_json() == chaos.scenario_plan(name, seed).to_json()


def test_unknown_scenario_and_kind_raise():
    with pytest.raises(KeyError, match="unknown chaos scenario"):
        chaos.scenario_plan("nope")
    with pytest.raises(ValueError):
        chaos.FaultSpec(point="x", kind="melt")
    with pytest.raises(ValueError, match="unknown FaultSpec"):
        chaos.FaultSpec.from_dict({"point": "x", "bogus": 1})


def test_off_by_default():
    assert chaos.point("storage.write") is None
    assert not chaos.is_active()


def test_env_arming_matches_reference(monkeypatch, tmp_path):
    spec = json.dumps({"name": "d", "faults": [
        {"point": "storage.write", "kind": "exception", "probability": 0.5,
         "times": 3}]})
    monkeypatch.setenv("DLROVER_TPU_CHAOS", "1")
    monkeypatch.setenv("DLROVER_TPU_CHAOS_SPEC", spec)
    monkeypatch.setenv("DLROVER_TPU_CHAOS_SEED", "5")
    outs = []
    for pkg, tag in ((chaos, "port"), (jchaos, "ref")):
        path = tmp_path / f"{tag}.jsonl"
        monkeypatch.setenv("DLROVER_TPU_CHAOS_TRACE_FILE", str(path))
        pkg.clear()
        raised = []
        for i in range(12):
            try:
                pkg.point("storage.write")
            except pkg.ChaosError:
                raised.append(i)
        assert pkg.is_active()
        assert pkg.engine().plan.seed == 5
        outs.append((raised, path.read_text()))
        pkg.clear()
    assert outs[0] == outs[1]
    assert len(outs[0][0]) == 3


def test_env_arming_from_a_plan_file(monkeypatch, tmp_path):
    plan = tmp_path / "plan.json"
    plan.write_text(chaos.scenario_plan("heartbeat_loss", 2).to_json())
    monkeypatch.setenv("DLROVER_TPU_CHAOS", "1")
    monkeypatch.setenv("DLROVER_TPU_CHAOS_SPEC", str(plan))
    chaos.clear()
    kinds = [getattr(chaos.point("agent.heartbeat"), "kind", None)
             for _ in range(9)]
    assert kinds == [None, None] + ["drop"] * 5 + [None, None]


def test_clear_one_pattern_keeps_the_rest():
    chaos.inject(chaos.FaultSpec(point="a.x", kind="drop"))
    chaos.inject(chaos.FaultSpec(point="b.x", kind="drop"))
    chaos.clear("a.x")
    assert chaos.point("a.x") is None
    assert chaos.point("b.x").kind == "drop"
    chaos.clear("b.x")
    assert not chaos.is_active()


def test_stream_fault_shim_arms_and_clears_the_engine():
    from dlrover_tpu_torch.trainer.flash_checkpoint import snapshot

    seen = []
    snapshot.set_stream_fault(seen.append)
    assert chaos.is_active()
    chaos.point("snapshot.stream_chunk", chunk=4)
    assert seen == [4]
    snapshot.set_stream_fault(None)
    assert not chaos.is_active()


# ---------------------------------------------------------------------------
# The chaos points: one case each, the reference's effect at the port's site.
# ---------------------------------------------------------------------------


def _arm(pkg, point, kind, **kw):
    pkg.configure(pkg.ChaosPlan(name="point", seed=0, faults=[
        pkg.FaultSpec(point=point, kind=kind, **kw)]))


def _both(fn):
    """``fn(pkg, package_root_module)`` on the port then the reference.

    Every point case runs its site in both packages this way but
    ``agent.heartbeat``, whose docstring names what holds it."""
    import dlrover_tpu
    import dlrover_tpu_torch

    out = []
    for pkg, root in ((chaos, dlrover_tpu_torch), (jchaos, dlrover_tpu)):
        try:
            out.append(fn(pkg, root))
        finally:
            pkg.clear()
    return out


def _scope(tag):
    """A segment scope of this process alone: two checkouts running the
    suite at once must not meet in ``/dev/shm``."""
    return f"chaospt{tag}_{os.getpid()}_{uuid.uuid4().hex[:8]}"


def _is_ref(root):
    return root.__name__ == "dlrover_tpu"


def _imp(root, dotted):
    import importlib

    return importlib.import_module(f"{root.__name__}.{dotted}")


def point_storage_write(tmp_path):
    def run(pkg, root):
        storage = _imp(root, "common.storage").PosixDiskStorage()
        path = str(tmp_path / f"{root.__name__}.bin")
        _arm(pkg, "storage.write", "drop")
        storage.write(b"payload", path)
        dropped = os.path.exists(path)
        _arm(pkg, "storage.write", "torn_write")
        storage.write(b"payload!", path)
        with open(path, "rb") as f:
            return dropped, f.read()
    got, want = _both(run)
    assert got == want == (False, b"payl")


def point_storage_write_chunk(tmp_path):
    payload = np.random.default_rng(0).integers(
        0, 255, size=3 << 20, dtype=np.uint8).tobytes()

    def run(pkg, root):
        storage = _imp(root, "common.storage").PosixDiskStorage()
        path = str(tmp_path / f"{root.__name__}.bin")
        _arm(pkg, "storage.write_chunk", "torn_write", on_calls=[1])
        records = storage.write_chunks(payload, path, chunk_bytes=1 << 20)
        with open(path, "rb") as f:
            data = f.read()
        bad = [r["offset"] for r in records
               if zlib.crc32(data[r["offset"]:r["offset"] + r["nbytes"]])
               != r["crc32"]]
        return records, bad
    got, want = _both(run)
    assert got == want
    assert got[1] == [1 << 20]  # the torn chunk keeps its CRC record

    # and an eager restore refuses the step that holds it
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        Checkpointer,
        StorageType,
    )

    os.environ["DLROVER_TPU_VERIFY_CRC"] = "eager"
    os.environ["DLROVER_TPU_PERSIST_WRITERS"] = "1"
    os.environ["DLROVER_TPU_PERSIST_CHUNK_BYTES"] = str(1 << 20)
    try:
        ckpt_dir = str(tmp_path / "ckpt")
        state = {"w": torch.arange(1 << 19, dtype=torch.float32)}
        _arm(chaos, "storage.write_chunk", "torn_write", on_calls=[1])
        ckpt = Checkpointer(ckpt_dir, scope=_scope("ckpt"),
                            async_snapshot=False, device="cpu")
        ckpt.save_checkpoint(2, state, StorageType.DISK)
        assert ckpt.wait_latest_checkpoint(60)
        ckpt.engine.unlink_memory()
        ckpt.close()
        fresh = Checkpointer(ckpt_dir, scope=_scope("fresh"),
                             async_snapshot=False, device="cpu")
        restored, step = fresh.load_checkpoint(
            {"w": torch.zeros(1 << 19)})
        fresh.engine.unlink_memory()
        fresh.close()
        assert (restored, step) == (None, -1)
    finally:
        for name in ("DLROVER_TPU_VERIFY_CRC", "DLROVER_TPU_PERSIST_WRITERS",
                     "DLROVER_TPU_PERSIST_CHUNK_BYTES"):
            os.environ.pop(name, None)


def _state(root, **leaves):
    """``leaves`` (numpy arrays) as the package's own tensors."""
    if _is_ref(root):
        import jax.numpy as jnp

        return {k: jnp.asarray(v) for k, v in leaves.items()}
    return {k: torch.from_numpy(v) for k, v in leaves.items()}


def point_snapshot_stream_chunk(tmp_path):
    leaves = dict(a=np.ones(1024, np.float32), b=np.zeros(1024, np.float32),
                  c=np.arange(64, dtype=np.float32))

    def run(pkg, root):
        buffers = _imp(root, "common.multi_process")
        snapshot = _imp(root, "trainer.flash_checkpoint.snapshot")
        shm = buffers.SharedMemoryBuffer(_scope("stream"))
        try:
            _arm(pkg, "snapshot.stream_chunk", "exception", after=1, times=1)
            with pytest.raises(pkg.ChaosError):
                snapshot.stream_snapshot(
                    shm, 3, snapshot.plan_shards(_state(root, **leaves)))
            return snapshot.is_torn(shm), [r["call"] for r in pkg.trace()]
        finally:
            shm.unlink()
    got, want = _both(run)
    assert got == want == (True, [1])


def _engine(root, tmp_path):
    engine_mod = _imp(root, "trainer.flash_checkpoint.engine")
    ckpt_dir = str(tmp_path / f"ck_{root.__name__}")
    if _is_ref(root):
        return engine_mod.CheckpointEngine(ckpt_dir, scope=_scope("eng"))
    return engine_mod.CheckpointEngine(ckpt_dir, scope=_scope("eng"),
                                       device="cpu")


def _load(root, engine, n):
    """Restore a ``{"w": float32[n]}`` state through ``root``'s engine."""
    if _is_ref(root):
        import jax
        import jax.numpy as jnp

        sharding = jax.sharding.SingleDeviceSharding(jax.devices()[0])
        state, step = engine.load(
            {"w": jax.ShapeDtypeStruct((n,), jnp.float32)}, {"w": sharding})
    else:
        state, step = engine.load({"w": torch.zeros(n)})
    return (None if state is None else np.asarray(state["w"])), step


def point_flash_save(tmp_path):
    def run(pkg, root):
        metrics = _imp(root, "observability.metrics")
        engine = _engine(root, tmp_path)
        try:
            _arm(pkg, "flash.save", "exception")
            with pytest.raises(pkg.ChaosError):
                engine.save_to_memory(1, _state(root, w=np.ones(4, np.float32)))
            timed = bool(metrics.registry().histogram_stats(
                "dlrover_tpu_ckpt_phase_seconds", phase="save_memory"))
            return engine.latest_memory_step, timed, \
                [r["point"] for r in pkg.trace()]
        finally:
            pkg.clear()
            engine.unlink_memory()
            engine.close()
    got, want = _both(run)
    # the save is refused and still timed, the fault inside its span
    assert got == want == (-1, True, ["flash.save"])


def point_flash_restore(tmp_path):
    def run(pkg, root):
        engine = _engine(root, tmp_path)
        try:
            engine.save_to_memory(1, _state(root, w=np.ones(4, np.float32)))
            _arm(pkg, "flash.restore", "exception")
            with pytest.raises(pkg.ChaosError):
                _load(root, engine, 4)
            pkg.clear()
            w, step = _load(root, engine, 4)
            return step, w.tolist()
        finally:
            engine.unlink_memory()
            engine.close()
    got, want = _both(run)
    assert got == want == (1, [1.0] * 4)


def point_ckpt_phase1_report(tmp_path):
    def run(pkg, root):
        dist = _imp(root, "trainer.flash_checkpoint.distributed")
        client = dist.LocalCommitClient()
        manifest = {"leaves": [], "files": {}, "stats": {}}
        _arm(pkg, "ckpt.phase1_report", "drop")
        ok = dist.fire_phase1_report(client, str(tmp_path / "d"), 5, 0, 1,
                                     manifest)
        status = client.commit_status(str(tmp_path / "d"), 5)
        return ok, status["sealed"], status["reported"]
    got, want = _both(run)
    assert got == want == (False, False, 0)


def point_ckpt_phase2_commit(tmp_path):
    def run(pkg, root):
        dist = _imp(root, "trainer.flash_checkpoint.distributed")
        ckpt_dir = str(tmp_path / root.__name__)
        engine = dist.DistributedCheckpointEngine(
            ckpt_dir, process_id=0, num_processes=1,
            client=dist.LocalCommitClient())
        if root.__name__ == "dlrover_tpu":
            import jax.numpy as jnp

            state = {"w": jnp.arange(8.0)}
        else:
            state = {"w": torch.arange(8.0)}
        _arm(pkg, "ckpt.phase2_commit", "exception", on_calls=[0],
             message="chaos: coordinator killed at phase-2 commit")
        first = engine.save(3, state, wait_seal=True, timeout=2)
        status = engine._client.commit_status(ckpt_dir, 3)
        again = engine.save(3, state, wait_seal=True, timeout=10)
        return (first["sealed"], status["sealed"], bool(status["reason"]),
                again["sealed"])
    got, want = _both(run)
    assert got == want == (False, False, True, True)


def point_peer_serve(tmp_path):
    def run(pkg, root):
        peer = _imp(root, "trainer.flash_checkpoint.peer_restore")
        endpoint = peer.PeerServeEndpoint(0, scope=_scope("serve"), port=0)
        endpoint.start()
        try:
            _arm(pkg, "peer.serve", "drop")
            dropped, _, body = peer._http_fetch(
                endpoint.addr, "/peer/meta", {}, 5.0)
            pkg.clear()
            # no snapshot behind it: served, not dropped
            served, _, _ = peer._http_fetch(
                endpoint.addr, "/peer/meta", {}, 5.0)
            return dropped, body, served
        finally:
            endpoint.stop()
    got, want = _both(run)
    assert got == want
    assert got[0] == 503 and b"unavailable" in got[1] and got[2] != 503


def point_peer_fetch(tmp_path):
    def run(pkg, root):
        peer = _imp(root, "trainer.flash_checkpoint.peer_restore")
        _arm(pkg, "peer.fetch", "drop")
        with pytest.raises(OSError, match="chaos: peer fetch dropped"):
            peer._http_fetch("127.0.0.1:9", "/peer/meta", {}, 1.0)
        return [r["point"] for r in pkg.trace()]
    got, want = _both(run)
    assert got == want == ["peer.fetch"]


def point_kv_server_set(tmp_path):
    def run(pkg, root):
        kv = _imp(root, "master.kv_store").KVStoreService()
        _arm(pkg, "kv_server.set", "drop", on_calls=[0])
        kv.set("k", b"1")
        first = kv.get("k")
        kv.set("k", b"2")
        return first, kv.get("k")
    got, want = _both(run)
    assert got == want == (b"", b"2")


def point_kv_server_get(tmp_path):
    def run(pkg, root):
        kv = _imp(root, "master.kv_store").KVStoreService()
        kv.set("k", b"v")
        _arm(pkg, "kv_server.get", "drop", on_calls=[0])
        return kv.get("k"), kv.get("k")
    got, want = _both(run)
    assert got == want == (b"", b"v")  # a DROP reads the key as absent


def point_kv_server_wait(tmp_path):
    def run(pkg, root):
        kv = _imp(root, "master.kv_store").KVStoreService()
        kv.set("k", b"v")
        _arm(pkg, "kv_server.wait", "flap", on_calls=[0], flap_count=2)
        return [kv.wait("k", timeout=0.1) for _ in range(3)]
    got, want = _both(run)
    assert got == want == [b"", b"", b"v"]


def point_rdzv_join(tmp_path):
    def run(pkg, root):
        rdzv_mod = _imp(root, "master.rdzv_manager")
        rdzv = rdzv_mod.ElasticTrainingRendezvousManager()
        rdzv.update_rdzv_params(min_nodes=2, max_nodes=2,
                                waiting_timeout=0.2, node_unit=1)
        _arm(pkg, "rdzv.join", "flap", on_calls=[1], flap_count=2)
        rdzv.join_rendezvous(node_id=0, node_rank=0)
        joins, world = 1, {}
        for _ in range(200):
            rdzv.join_rendezvous(node_id=1, node_rank=1)
            joins += 1
            _, _, world = rdzv.get_comm_world(node_id=1)
            if world:
                break
            time.sleep(0.02)
        return sorted(m.node_id for m in world.values()), \
            [r["kind"] for r in pkg.trace()]
    got, want = _both(run)
    # the round seals with the flapping node in it
    assert got == want == ([0, 1], ["flap", "flap"])


def point_data_lease(tmp_path):
    def run(pkg, root):
        tm = _imp(root, "master.task_manager").TaskManager()
        tm.new_dataset(batch_size=2, dataset_size=8, dataset_name="d",
                       num_minibatches_per_shard=1)
        _arm(pkg, "data.lease", "drop", on_calls=[0, 2])
        out = [tm.lease_dataset_tasks(0, "d", count=2),
               tm.lease_dataset_tasks(0, "d", count=2),
               tm.wait_dataset_tasks(0, "d", count=2, timeout=0.1)]
        return [(len(tasks), finished) for tasks, finished in out]
    got, want = _both(run)
    assert got == want == [(0, False), (2, False), (0, False)]


def point_servicer_admission(tmp_path):
    def run(pkg, root):
        ctl = _imp(root, "master.admission").AdmissionController()
        _arm(pkg, "servicer.admission", "drop", on_calls=[0])
        first = ctl.admit("get")
        second = ctl.admit("get")
        if second is not None:
            second.release()
        return first is None, second is not None
    got, want = _both(run)
    assert got == want == (True, True)  # a forced shed, then admitted


def _local_client(root, node_id=0):
    servicer = _imp(root, "master.servicer").MasterServicer()
    client_mod = _imp(root, "agent.master_client")
    return client_mod.LocalMasterClient(servicer, node_id=node_id)


def point_master_client_transport(tmp_path, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_RPC_RETRY_BASE_S", "0.01")
    monkeypatch.setenv("DLROVER_TPU_RPC_RETRY_MAX_S", "0.02")
    monkeypatch.setenv("DLROVER_TPU_RETRY_JITTER", "0")

    def run(pkg, root):
        client = _local_client(root)
        _arm(pkg, "master_client.transport", "exception", on_calls=[0, 1],
             message="chaos: master restarting (connection refused)")
        ok = client.kv_store_set("k", b"v")
        trace = [(r["point"], r["call"], bool(r["span_id"]))
                 for r in pkg.trace()]
        return ok, trace
    got, want = _both(run)
    # the retry policy rides through, each fault inside its attempt span
    assert got == want
    assert got[0] is True and len(got[1]) == 2 and all(s for *_, s in got[1])


def point_kv_store_set(tmp_path):
    def run(pkg, root):
        client = _local_client(root)
        _arm(pkg, "kv_store.set", "drop", on_calls=[0])
        return client.kv_store_set("k", b"v"), client.kv_store_get("k")
    got, want = _both(run)
    assert got == want == (False, b"")


def point_kv_store_get(tmp_path):
    def run(pkg, root):
        client = _local_client(root)
        client.kv_store_set("k", b"v")
        _arm(pkg, "kv_store.get", "flap", on_calls=[0], flap_count=1)
        return client.kv_store_get("k"), client.kv_store_get("k")
    got, want = _both(run)
    assert got == want == (b"", b"v")


def point_kv_store_wait(tmp_path):
    def run(pkg, root):
        client = _local_client(root)
        client.kv_store_set("k", b"v")
        _arm(pkg, "kv_store.wait", "drop", times=3)
        value = client.kv_store_wait("k", timeout=10.0, poll=0.01)
        return value, len(pkg.trace())
    got, want = _both(run)
    assert got == want == (b"v", 3)  # three chunks "expire", then the key


def point_master_client_barrier(tmp_path):
    def run(pkg, root):
        client = _local_client(root)
        _arm(pkg, "master_client.barrier", "drop", on_calls=[0])
        return [pkg.trace() == [], client.barrier("b", notify=True)]
    got, want = _both(run)
    assert got == want == [True, False]


def point_agent_heartbeat(tmp_path):
    """The port's agent alone: the reference's agent runs JAX workers.
    The drill's ``heartbeat_loss`` holds this point against the reference
    (``tests/test_torch_chaos_drill.py``: the same trace and incident)."""
    from dlrover_tpu_torch.agent.elastic_agent import (
        ElasticAgent,
        ElasticLaunchConfig,
    )
    from dlrover_tpu_torch.common.global_context import Context
    from dlrover_tpu_torch.common.node import Node
    from dlrover_tpu_torch.master.job_context import get_job_context

    client = _local_client(__import__("dlrover_tpu_torch"), node_id=0)
    job_ctx = get_job_context()
    node = Node(node_id=0)
    job_ctx.update_job_node(node)
    agent = ElasticAgent(client, ElasticLaunchConfig())
    ctx = Context.singleton_instance()
    saved = ctx.heartbeat_interval_secs
    ctx.heartbeat_interval_secs = 0.02
    _arm(chaos, "agent.heartbeat", "drop")  # every heartbeat swallowed
    thread = threading.Thread(target=agent._heartbeat_loop, daemon=True)
    try:
        thread.start()
        deadline = time.time() + 10
        while chaos.engine().call_count("agent.heartbeat") < 5:
            assert time.time() < deadline
            time.sleep(0.01)
        assert not node.heartbeat_time  # the master never heard one
    finally:
        agent._stop_heartbeat.set()
        thread.join(timeout=5)
        ctx.heartbeat_interval_secs = saved
        job_ctx.remove_job_node(node.type, node.id)


def point_mem_pressure(tmp_path, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_MEM_CHAOS_INFLATE_B", "1000")
    stats = [{"device": 0, "used_b": 5000.0, "limit_b": 1e6,
              "peak_b": 5000.0, "source": "memory_stats"}]

    def run(pkg, root):
        memscope = _imp(root, "observability.memscope")
        scope = memscope.reset_scope(stats_reader=lambda: stats)
        try:
            _arm(pkg, "mem.pressure", "drop", after=1)
            return [scope.sample()["used_b"] for _ in range(4)]
        finally:
            memscope.reset_scope()
    got, want = _both(run)
    # cumulative: +1000 per fired fault from the second sample on
    assert got == want == [5000.0, 6000.0, 7000.0, 8000.0]


def point_comm_axis_delay(tmp_path):
    def run(pkg, root):
        commscope = _imp(root, "observability.commscope")
        probe = commscope.MeshProbe({"dp": 2},
                                    runner=lambda axis, kind: None, reps=1)
        _arm(pkg, "comm.axis_delay.dp", "delay", delay_s=0.05)
        out = probe.probe_once(commscope.FabricModel())
        # inside the comm.probe.dp span, and the latency is priced
        return ([(r["point"], bool(r["span_id"])) for r in pkg.trace()],
                out["dp"]["lat_s"] >= 0.05)
    got, want = _both(run)
    assert got == want == ([("comm.axis_delay.dp", True)], True)


def point_comm_probe_init(tmp_path):
    def run(pkg, root):
        commscope = _imp(root, "observability.commscope")
        _arm(pkg, "comm.probe.init", "drop")
        commscope.MeshProbe({"dp": 2}, runner=lambda axis, kind: None)
        return [r["point"] for r in pkg.trace()]
    got, want = _both(run)
    assert got == want == ["comm.probe.init"]


def point_jitscope_compile(tmp_path):
    def run(pkg, root):
        jitscope = _imp(root, "observability.jitscope")
        jitscope.reset_scope()

        def compiling(x):
            jitscope._tls.compile_s += 0.001  # a build inside the call
            return x

        watched = jitscope.watch(compiling, "drill.step")
        _arm(pkg, "jitscope.compile", "delay", delay_s=0.05)
        try:
            watched(1)
            event = watched.last_event
            # the injected compile seconds
            return ([r["point"] for r in pkg.trace()],
                    event["compile_s"] >= 0.05)
        finally:
            jitscope.reset_scope()
    got, want = _both(run)
    assert got == want == (["jitscope.compile"], True)


POINT_CASES = {
    "storage.write": point_storage_write,
    "storage.write_chunk": point_storage_write_chunk,
    "snapshot.stream_chunk": point_snapshot_stream_chunk,
    "flash.save": point_flash_save,
    "flash.restore": point_flash_restore,
    "ckpt.phase1_report": point_ckpt_phase1_report,
    "ckpt.phase2_commit": point_ckpt_phase2_commit,
    "peer.serve": point_peer_serve,
    "peer.fetch": point_peer_fetch,
    "kv_server.set": point_kv_server_set,
    "kv_server.get": point_kv_server_get,
    "kv_server.wait": point_kv_server_wait,
    "rdzv.join": point_rdzv_join,
    "data.lease": point_data_lease,
    "servicer.admission": point_servicer_admission,
    "master_client.transport": point_master_client_transport,
    "kv_store.set": point_kv_store_set,
    "kv_store.get": point_kv_store_get,
    "kv_store.wait": point_kv_store_wait,
    "master_client.barrier": point_master_client_barrier,
    "agent.heartbeat": point_agent_heartbeat,
    "mem.pressure": point_mem_pressure,
    "comm.axis_delay.<axis>": point_comm_axis_delay,
    "comm.probe.init": point_comm_probe_init,
    "jitscope.compile": point_jitscope_compile,
}


@pytest.mark.parametrize("point", sorted(POINT_CASES))
def test_chaos_point_has_the_reference_effect(point, tmp_path, monkeypatch):
    import inspect

    case = POINT_CASES[point]
    if "monkeypatch" in inspect.signature(case).parameters:
        case(tmp_path, monkeypatch)
    else:
        case(tmp_path)


def test_no_chaos_point_is_left_as_a_comment():
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "dlrover_tpu_torch"
    for path in root.rglob("*.py"):
        text = path.read_text()
        assert "# chaos point \"" not in text, path
        assert "would fire" not in text, path
        assert "no chaos engine" not in text, path
