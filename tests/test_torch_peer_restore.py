"""The port's peer restore (dlrover_tpu_torch/trainer/flash_checkpoint/
peer_restore.py, master/ckpt_coordinator.py ``PeerRestoreBroker``, the
engine's hook and ``bench.peer_recovery_bench``) against the JAX package's.

- The reference's cases (tests/test_peer_restore.py:151-760) on the port:
  the torn-read protocol (a dropped or torn fetch injected by
  monkeypatching ``_http_fetch``, where the reference arms ``chaos``), step
  consistency, the fallback ladder, the serve endpoint, the engine hook,
  the replica group (from every rank's layout), the broker's order.  The
  compile-cache and MTTR-sentinel cases are left out with what they test.
- Across the packages: the reference's ``PeerServeEndpoint`` serves
  segments the port wrote and the port's endpoint serves the reference's
  clients; in both directions both packages' ``recover`` fill a segment
  byte-equal to the donor's and file reports that agree; the manifest rung
  reads a commit the reference's ``DistributedCheckpointEngine`` sealed;
  ``PeerRestoreBroker.assign`` equals the reference's on the same
  announcements.
- ``StorePeerClient`` over 3 gloo ranks (tests/torch_replica_checks.py
  ``store_client_worker``).
- The engine over 2 gloo ranks with ``DLROVER_TPU_PEER_RESTORE=1``: rank
  1 loses its segment, is refilled from rank 0's endpoint through the
  broker over the world's store, and restores ``torch.equal``; rank 0
  fetches nothing; the step after is the uninterrupted one bitwise and the
  JAX Trainer's within 1e-6.
- ``peer_recovery_bench`` at 1 MB: the reference's keys, bit-exact, rung
  ``peer_shm``.
"""

import contextlib
import json
import os
import struct
import types
import uuid
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.common.multi_process import SharedMemoryBuffer
from dlrover_tpu_torch.master.ckpt_coordinator import PeerRestoreBroker
from dlrover_tpu_torch.parallel import dp_workers, process_group
from dlrover_tpu_torch.trainer.flash_checkpoint import (
    bench,
    distributed,
    peer_restore,
    snapshot,
)
from dlrover_tpu_torch.trainer.flash_checkpoint.engine import shm_name

from torch_replica_checks import (
    LOSS_RTOL,
    STEPS,
    jax_losses,
    lose_spec,
    store_client_worker,
)

SPAWN_TIMEOUT_S = 180.0
# the report keys both packages must agree on
AGREED = ("rung", "bytes_peer", "bytes_manifest", "storage_reads",
          "torn_retries", "demoted_peers", "filled")


@pytest.fixture(autouse=True)
def _clean():
    peer_restore.clear_context()
    yield
    peer_restore.clear_context()


@pytest.fixture
def ref():
    """The JAX package's side of the comparisons."""
    pytest.importorskip("jax")
    from dlrover_tpu import chaos
    from dlrover_tpu.common.multi_process import (
        SharedMemoryBuffer as RefShm,
    )
    from dlrover_tpu.master.ckpt_coordinator import (
        PeerRestoreBroker as RefBroker,
    )
    from dlrover_tpu.trainer.flash_checkpoint import distributed as rdist
    from dlrover_tpu.trainer.flash_checkpoint import peer_restore as rpeer
    from dlrover_tpu.trainer.flash_checkpoint import snapshot as rsnap

    chaos.clear()
    rpeer.clear_context()
    yield types.SimpleNamespace(peer=rpeer, snapshot=rsnap, Shm=RefShm,
                                Broker=RefBroker, dist=rdist)
    chaos.clear()
    rpeer.clear_context()


def _arrays(step: int):
    rng = np.random.default_rng(step)
    return {
        "w": rng.standard_normal(2048).astype(np.float32),
        "b": rng.standard_normal(256).astype(np.float32),
        "step": np.asarray(step, np.int32),
    }


def _state(step: int):
    return {k: torch.from_numpy(v) for k, v in _arrays(step).items()}


def _crc_headers(body: bytes, **extra) -> dict:
    return {"x-peer-crc32": str(zlib.crc32(body)),
            **{k.lower(): str(v) for k, v in extra.items()}}


class _Fleet:
    """N local hosts: committed segments (written by the port), serve
    endpoints (the port's, or ``endpoint_cls``) and a broker in this
    process."""

    def __init__(self, scope: str, step: int = 5, nprocs: int = 4,
                 endpoint_cls=None):
        self.scope = scope
        self.step = step
        self.nprocs = nprocs
        self.state = _state(step)
        self.leaves = snapshot.plan_shards(self.state)
        self.broker = PeerRestoreBroker()
        self.endpoint_cls = endpoint_cls or peer_restore.PeerServeEndpoint
        self.shms = {}
        self.endpoints = {}

    def up(self, pids):
        client = peer_restore.LocalPeerClient(self.broker)
        for pid in pids:
            shm = SharedMemoryBuffer(shm_name(pid, self.scope))
            snapshot.write_snapshot(shm, self.step, self.leaves, {})
            self.shms[pid] = shm
            endpoint = self.endpoint_cls(pid, scope=self.scope).start()
            self.endpoints[pid] = endpoint
            client.report_peer_announce(self.scope, self.step, endpoint.addr,
                                        num_processes=self.nprocs,
                                        process_id=pid)
        return self

    def donors(self, pids=None):
        pids = list(self.endpoints) if pids is None else pids
        return [(pid, self.endpoints[pid].addr) for pid in pids]

    def assignment(self, pids=None):
        return {"step": self.step,
                "donors": {str(p): a for p, a in self.donors(pids)}}

    def tear(self, pid):
        """Leave pid's segment mid-write forever (odd generation)."""
        buf = self.shms[pid].buf
        (gen,) = struct.unpack(">Q", bytes(buf[8:16]))
        if gen % 2 == 0:
            buf[8:16] = struct.pack(">Q", gen + 1)

    def new_shm(self, pid):
        shm = SharedMemoryBuffer(shm_name(pid, self.scope))
        self.shms[pid] = shm
        return shm

    def reference_payload(self, donor_pid):
        shm = self.shms[donor_pid]
        meta = snapshot.read_snapshot_meta(shm)
        return (snapshot.read_meta_bytes(shm),
                snapshot.read_payload_range(shm, 0, meta["payload_bytes"]))

    def down(self):
        for endpoint in self.endpoints.values():
            endpoint.stop()
        for shm in self.shms.values():
            with contextlib.suppress(Exception):
                if shm.attach():
                    shm.unlink()


@pytest.fixture
def fleet():
    made = []

    def build(**kwargs):
        f = _Fleet(f"tpr{uuid.uuid4().hex[:8]}", **kwargs)
        made.append(f)
        return f

    yield build
    for f in made:
        f.down()


def _recovered(shm, reference) -> bool:
    meta_bytes, payload = reference
    return (snapshot.read_meta_bytes(shm) == meta_bytes
            and snapshot.read_payload_range(shm, 0, len(payload)) == payload)


def _seal_manifest(tmp_path, state, step):
    ckpt_dir = str(tmp_path / "ckpt")
    stats = distributed.DistributedCheckpointEngine(
        ckpt_dir, process_id=0, num_processes=1,
        client=distributed.LocalCommitClient(),
    ).save(step, state, wait_seal=True, timeout=30)
    assert stats["sealed"]
    return ckpt_dir


def _plan(shm):
    meta = snapshot.read_snapshot_meta(shm)
    return [dict(leaf, shards=[dict(s) for s in leaf["shards"]])
            for leaf in meta["leaves"]]


# ---------------------------------------------------------------------------
# The torn-read protocol: retry once, then demote.
# ---------------------------------------------------------------------------


def _scripted_restorer(monkeypatch, script):
    """A restorer whose transport replays ``script``: each entry is
    ("ok", body) | ("torn", body) | ("nocrc", body) | ("409",) | ("500",)
    | ("err",).  The call log pins the retry/demote order."""
    calls = []
    replies = iter(script)

    def fake_fetch(addr, route, params, timeout_s):
        calls.append((addr, route))
        kind, *rest = next(replies)
        if kind == "err":
            raise OSError("unreachable")
        if kind == "409":
            return 409, {}, b'{"torn": true}'
        if kind == "500":
            return 500, {}, b""
        body = rest[0]
        headers = _crc_headers(body, **{"X-Peer-Gen": "2"})
        if kind == "torn":
            headers["x-peer-crc32"] = str(zlib.crc32(body) ^ 1)
        if kind == "nocrc":
            del headers["x-peer-crc32"]
        return 200, headers, body

    monkeypatch.setattr(peer_restore, "_http_fetch", fake_fetch)
    restorer = peer_restore.PeerRestorer([(0, "hostA:1"), (2, "hostB:1")],
                                         timeout_s=1.0)
    return restorer, calls


def test_single_torn_read_retries_same_peer_and_succeeds(monkeypatch):
    restorer, calls = _scripted_restorer(
        monkeypatch, [("torn", b"x"), ("ok", b"payload")])
    got = restorer._request(0, "hostA:1", "/peer/shard", {})
    assert got is not None and got[1] == b"payload"
    assert calls == [("hostA:1", "/peer/shard")] * 2
    assert restorer.torn_retries == 1
    assert restorer.demoted == []


def test_second_torn_read_demotes_after_the_retry(monkeypatch):
    restorer, calls = _scripted_restorer(monkeypatch, [("409",), ("409",)])
    assert restorer._request(0, "hostA:1", "/peer/meta", {}) is None
    assert calls == [("hostA:1", "/peer/meta")] * 2
    assert restorer.torn_retries == 1
    assert restorer.demoted == [0]
    assert restorer._request(0, "hostA:1", "/peer/meta", {}) is None
    assert len(calls) == 2  # sticky: no further transport calls
    assert restorer.healthy_donors() == [(2, "hostB:1")]


def test_crc_mismatch_counts_as_torn(monkeypatch):
    restorer, _ = _scripted_restorer(
        monkeypatch, [("torn", b"bad"), ("torn", b"bad")])
    assert restorer._request(0, "hostA:1", "/peer/shard", {}) is None
    assert restorer.torn_retries == 1
    assert restorer.demoted == [0]


def test_missing_crc_header_on_200_is_torn_not_validated(monkeypatch):
    restorer, _ = _scripted_restorer(
        monkeypatch, [("nocrc", b"x"), ("ok", b"payload")])
    got = restorer._request(0, "hostA:1", "/peer/shard", {})
    assert got is not None and got[1] == b"payload"
    assert restorer.torn_retries == 1
    restorer, _ = _scripted_restorer(
        monkeypatch, [("nocrc", b"x"), ("nocrc", b"x")])
    assert restorer._request(0, "hostA:1", "/peer/shard", {}) is None
    assert restorer.demoted == [0]


@pytest.mark.parametrize("kind", ["err", "500"])
def test_transport_or_hard_error_demotes_immediately(monkeypatch, kind):
    restorer, calls = _scripted_restorer(monkeypatch, [(kind,)])
    assert restorer._request(0, "hostA:1", "/peer/meta", {}) is None
    assert len(calls) == 1  # no retry: an unreachable peer won't heal
    assert restorer.torn_retries == 0
    assert restorer.demoted == [0]


def test_torn_shm_generation_end_to_end(fleet):
    f = fleet(step=5).up([0, 2])
    f.tear(0)
    restorer = peer_restore.PeerRestorer(f.donors([0, 2]))
    leaf = f.leaves[0]
    data = leaf["shards"][0]["data"]
    raw = restorer.fetch_shard(leaf["path"], leaf["shards"][0]["index"],
                               data.numel() * data.element_size())
    assert raw is not None
    assert restorer.torn_retries == 1
    assert restorer.demoted == [0]
    assert torch.equal(torch.from_numpy(raw.copy()).view(data.dtype), data)


# ---------------------------------------------------------------------------
# Step consistency: a donor on another step never serves bytes.
# ---------------------------------------------------------------------------


def _advance(f, pid, new_step):
    """Donor ``pid`` commits ``new_step`` after the broker handed out its
    announcement of ``f.step``."""
    snapshot.write_snapshot(f.shms[pid], new_step,
                            snapshot.plan_shards(_state(new_step)), {})


def test_donor_advanced_past_target_step_is_demoted(fleet):
    f = fleet(step=5).up([0, 2])
    _advance(f, 0, 6)
    restorer = peer_restore.PeerRestorer(f.donors([0, 2]), step=5)
    leaf = f.leaves[0]
    data = leaf["shards"][0]["data"]
    nbytes = data.numel() * data.element_size()
    raw = restorer.fetch_shard(leaf["path"], leaf["shards"][0]["index"],
                               nbytes)
    assert raw is not None and restorer.demoted == [0]
    assert torch.equal(torch.from_numpy(raw.copy()).view(data.dtype), data)
    assert restorer.bytes_peer == nbytes  # donor 2's only


def test_recover_stays_bit_exact_with_an_advanced_donor(fleet):
    f = fleet(step=5).up([0, 2])
    reference = f.reference_payload(2)
    _advance(f, 0, 6)
    shm_new = f.new_shm(9)
    report = peer_restore.recover(
        scope=f.scope, process_id=9, num_processes=f.nprocs, shm=shm_new,
        checkpoint_dir="/nonexistent/ckpt", assignment=f.assignment())
    assert report["filled"] and report["rung"] == "peer_shm"
    assert report["step"] == f.step and 0 in report["demoted_peers"]
    assert report["storage_reads"] == 0
    assert _recovered(shm_new, reference)


def test_no_step_matched_donor_commits_nothing(fleet):
    f = fleet(step=5).up([0, 2])
    _advance(f, 0, 6)
    _advance(f, 2, 7)
    shm_new = f.new_shm(9)
    report = peer_restore.recover(
        scope=f.scope, process_id=9, num_processes=f.nprocs, shm=shm_new,
        checkpoint_dir="/nonexistent/ckpt", assignment=f.assignment())
    assert not report["filled"] and report["rung"] == "storage"
    assert sorted(report["demoted_peers"]) == [0, 2]
    assert snapshot.read_snapshot_meta(shm_new) is None


# ---------------------------------------------------------------------------
# The fallback ladder: bit-exact at every rung.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_random_failures_restore_bit_exact_at_some_rung(fleet, tmp_path,
                                                        seed):
    """Whatever random subset of donors is dead or torn, the ladder lands
    byte-equal and reports its rung; with a sealed manifest on disk the
    only unfilled outcome is no plan at all."""
    rng = np.random.default_rng(seed)
    f = fleet(step=5).up([0, 2, 3])
    ckpt_dir = _seal_manifest(tmp_path, f.state, f.step)
    reference = f.reference_payload(0)
    dead = [pid for pid in (0, 2, 3) if rng.random() < 0.4]
    torn = [pid for pid in (0, 2, 3)
            if pid not in dead and rng.random() < 0.3]
    for pid in dead:
        f.endpoints[pid].stop()
    for pid in torn:
        f.tear(pid)
    shm_new = f.new_shm(9)
    report = peer_restore.recover(
        scope=f.scope, process_id=9, num_processes=f.nprocs, shm=shm_new,
        checkpoint_dir=ckpt_dir, assignment=f.assignment())
    healthy = [p for p in (0, 2, 3) if p not in dead and p not in torn]
    if report["filled"]:
        assert report["rung"] in ("peer_shm", "manifest")
        assert _recovered(shm_new, reference)
        assert (report["storage_reads"] == 0) == (report["rung"]
                                                  == "peer_shm")
    else:
        assert not healthy
        assert report["rung"] == "storage"
        assert snapshot.read_snapshot_meta(shm_new) is None


def test_all_peers_dead_falls_to_manifest_rung_with_plan(fleet, tmp_path):
    f = fleet(step=5).up([0])
    ckpt_dir = _seal_manifest(tmp_path, f.state, f.step)
    reference = f.reference_payload(0)
    shm_new = f.new_shm(9)
    report = peer_restore.recover(
        scope=f.scope, process_id=9, num_processes=f.nprocs, shm=shm_new,
        checkpoint_dir=ckpt_dir,
        assignment={"step": f.step, "donors": {}}, plan=_plan(f.shms[0]))
    assert report["filled"] and report["rung"] == "manifest"
    assert report["storage_reads"] > 0
    assert _recovered(shm_new, reference)


def test_storage_rung_reports_unfilled_and_commits_nothing(fleet):
    f = fleet(step=5).up([0])
    f.endpoints[0].stop()
    shm_new = f.new_shm(9)
    report = peer_restore.recover(
        scope=f.scope, process_id=9, num_processes=f.nprocs, shm=shm_new,
        checkpoint_dir="/nonexistent/ckpt", assignment=f.assignment())
    assert not report["filled"] and report["rung"] == "storage"
    assert report["step"] == -1
    assert snapshot.read_snapshot_meta(shm_new) is None


def test_dropped_fetches_fall_to_manifest_rung(fleet, tmp_path,
                                               monkeypatch):
    """Every peer fetch dropped (the reference arms a chaos DROP on
    ``peer.fetch``): the donors are demoted and the sealed manifest
    serves every shard."""
    f = fleet(step=5).up([0, 2])
    ckpt_dir = _seal_manifest(tmp_path, f.state, f.step)
    reference = f.reference_payload(0)

    def dropped(addr, route, params, timeout_s):
        raise OSError(f"peer fetch dropped ({addr}{route})")

    monkeypatch.setattr(peer_restore, "_http_fetch", dropped)
    shm_new = f.new_shm(9)
    report = peer_restore.recover(
        scope=f.scope, process_id=9, num_processes=f.nprocs, shm=shm_new,
        checkpoint_dir=ckpt_dir, assignment=f.assignment(),
        plan=_plan(f.shms[0]))
    assert report["filled"] and report["rung"] == "manifest"
    assert sorted(report["demoted_peers"]) == [0, 2]
    assert report["bytes_peer"] == 0
    assert _recovered(shm_new, reference)


def test_bf16_leaves_recover_byte_equal(fleet):
    """bf16 leaves go through ``tensor_from_bytes`` (no numpy bf16)."""
    f = fleet(step=5)
    f.state = {"w": torch.randn(64, 8).to(torch.bfloat16),
               "m": torch.randn(8).to(torch.bfloat16), "step": 5}
    f.leaves = snapshot.plan_shards(f.state)
    f.up([0])
    shm_new = f.new_shm(9)
    report = peer_restore.recover(
        scope=f.scope, process_id=9, num_processes=f.nprocs, shm=shm_new,
        checkpoint_dir="/nonexistent/ckpt", assignment=f.assignment())
    assert report["filled"] and report["rung"] == "peer_shm"
    assert _recovered(shm_new, f.reference_payload(0))


# ---------------------------------------------------------------------------
# The serve endpoint's contracts.
# ---------------------------------------------------------------------------


def test_meta_404_without_snapshot(fleet):
    f = fleet(step=5)
    endpoint = peer_restore.PeerServeEndpoint(31, scope=f.scope).start()
    f.endpoints[31] = endpoint
    status, _, _ = peer_restore._http_fetch(endpoint.addr, "/peer/meta", {},
                                            5.0)
    assert status == 404


def test_generation_pinning_rejects_moved_gen(fleet):
    f = fleet(step=5).up([0])
    gen, meta = peer_restore.PeerRestorer(f.donors()).donor_meta(
        0, f.endpoints[0].addr)
    shard = meta["leaves"][0]["shards"][0]
    status, _, _ = peer_restore._http_fetch(
        f.endpoints[0].addr, "/peer/shard",
        {"offset": shard["offset"], "nbytes": shard["nbytes"],
         "gen": gen + 2}, 5.0)
    assert status == 409


@pytest.mark.parametrize("query,want", [
    ({}, 400), ({"offset": 0}, 400), ({"offset": 1 << 40, "nbytes": 4}, 409),
])
def test_shard_route_refuses_bad_queries(fleet, query, want):
    """No offset or size: 400; a range past the segment reads as no
    committed range (409, as the reference's)."""
    f = fleet(step=5).up([0])
    status, _, _ = peer_restore._http_fetch(f.endpoints[0].addr,
                                            "/peer/shard", query, 5.0)
    assert status == want


def test_unported_cache_routes_are_not_served(fleet):
    """An endpoint given no compile cache lists no entry and serves none
    (the routes exist since the compile cache came; the reference's
    endpoint with no ``cache_dir`` answers alike)."""
    f = fleet(step=5).up([0])
    status, headers, body = peer_restore._http_fetch(
        f.endpoints[0].addr, "/peer/cache_list", {}, 5.0)
    assert status == 200 and json.loads(body) == {"entries": []}
    assert peer_restore._crc_ok(headers, body)
    status, _, _ = peer_restore._http_fetch(
        f.endpoints[0].addr, "/peer/cache", {"name": "x"}, 5.0)
    assert status == 404


def test_binds_advertise_host_not_all_interfaces(fleet, monkeypatch):
    f = fleet(step=5).up([0])
    assert f.endpoints[0]._httpd.server_address[0] == "127.0.0.1"
    monkeypatch.setenv("DLROVER_TPU_PEER_BIND_HOST", "0.0.0.0")
    wide = peer_restore.PeerServeEndpoint(32, scope=f.scope)
    try:
        assert wide._httpd.server_address[0] == "0.0.0.0"
        assert wide.addr.startswith("127.0.0.1:")
    finally:
        wide.stop()


def test_meta_carries_step_and_crc(fleet):
    f = fleet(step=5).up([0])
    status, headers, body = peer_restore._http_fetch(
        f.endpoints[0].addr, "/peer/meta", {}, 5.0)
    assert status == 200
    assert int(headers["x-peer-step"]) == 5
    assert int(headers["x-peer-crc32"]) == zlib.crc32(body)
    assert json.loads(body)["step"] == 5
    assert body == snapshot.read_meta_bytes(f.shms[0])


# ---------------------------------------------------------------------------
# The engine hook and the broker.
# ---------------------------------------------------------------------------


class _FakeEngine:
    def __init__(self, scope, shm, checkpoint_dir, process_id=1,
                 num_processes=4):
        self._scope = scope
        self._shm = shm
        self.checkpoint_dir = checkpoint_dir
        self.process_id = process_id
        self.num_processes = num_processes
        self._storage = None

    @contextlib.contextmanager
    def _buffer_write_lock(self, timeout):
        yield True


def test_replacement_pulls_and_survivor_skips(fleet, tmp_path):
    f = fleet(step=5).up([0, 2, 3])
    client = peer_restore.LocalPeerClient(f.broker, process_id=1)
    peer_restore.register_context(client=client, scope=f.scope,
                                  process_id=1, num_processes=4)
    shm_new = f.new_shm(1)
    engine = _FakeEngine(f.scope, shm_new, str(tmp_path / "ckpt"))
    assert peer_restore.try_engine_recover(engine, None) is True
    meta = snapshot.read_snapshot_meta(shm_new)
    assert meta is not None and meta["step"] == f.step
    assert engine.last_recovery["rung"] == "peer_shm"
    # a survivor now: its segment holds the brokered step
    assert peer_restore.try_engine_recover(engine, None) is False
    recoveries = f.broker.recoveries()
    assert len(recoveries) == 1
    assert recoveries[0]["rung"] == "peer_shm"
    assert recoveries[0]["storage_reads"] == 0
    assert set(recoveries[0]) == set(peer_restore.RECOVERY_REPORT_KEYS) | {
        "ts"}


def test_no_context_client_is_a_noop(fleet, tmp_path):
    f = fleet(step=5)
    engine = _FakeEngine(f.scope, f.new_shm(1), str(tmp_path / "ckpt"))
    assert peer_restore.try_engine_recover(engine, None) is False


def _dp2_sharded_layouts():
    """4 processes, dp=2 x shard=2: {0,1} hold rows [0:4) of an 8-row
    leaf, {2,3} rows [4:8)."""
    return [{"w": ([8], [[0, 4]])}, {"w": ([8], [[0, 4]])},
            {"w": ([8], [[4, 8]])}, {"w": ([8], [[4, 8]])}]


def test_group_narrows_to_shard_holding_processes():
    target = {"w": torch.zeros(4)}
    layouts = _dp2_sharded_layouts()
    assert peer_restore._replica_group(target, layouts, 1, 4) == [0]
    assert peer_restore._replica_group(target, layouts, 2, 4) == [3]
    # a leaf no layout names is whole on every process
    target["step"] = 3
    assert peer_restore._replica_group(target, layouts, 1, 4) == [0, 2, 3]


def test_group_falls_back_to_everyone_without_layouts():
    assert peer_restore._replica_group(None, None, 1, 4) == [0, 2, 3]
    assert peer_restore._replica_group({"w": torch.zeros(4)}, None, 1,
                                       4) == [0, 2, 3]


def test_group_equals_the_references_from_shardings(ref):
    """The same boxes as the reference's shardings give the same group."""
    class Dev:
        def __init__(self, process_index):
            self.process_index = process_index

    class Sharding:
        def devices_indices_map(self, shape):
            return {Dev(0): (slice(0, 4),), Dev(1): (slice(0, 4),),
                    Dev(2): (slice(4, 8),), Dev(3): (slice(4, 8),)}

    state = {"w": np.zeros((8,), np.float32)}
    for pid in range(4):
        assert peer_restore._replica_group(
            {"w": torch.zeros(4)}, _dp2_sharded_layouts(), pid, 4
        ) == ref.peer._replica_group(state, {"w": Sharding()}, pid, 4)


def test_engine_hook_passes_the_replica_group_to_the_broker(fleet,
                                                            tmp_path):
    f = fleet(step=5)
    captured = {}

    class _CapturingClient:
        def get_peer_assignment(self, scope, step=-1, group=None,
                                process_id=None):
            captured["group"] = list(group or [])
            return peer_restore.PeerAssignment()

    peer_restore.register_context(client=_CapturingClient(), scope=f.scope,
                                  process_id=1, num_processes=4)
    engine = _FakeEngine(f.scope, None, str(tmp_path / "ckpt"))
    assert peer_restore.try_engine_recover(
        engine, {"w": torch.zeros(4)}, _dp2_sharded_layouts()) is False
    assert captured["group"] == [0]


def test_assignment_orders_replica_group_first():
    broker = PeerRestoreBroker()
    for pid in (0, 2, 3, 5):
        broker.announce("s", pid, 8, 7, f"h{pid}:1")
    got = broker.assign("s", 1, step=-1, group=[0, 2, 3])
    assert got["step"] == 7
    assert list(got["donors"]) == ["0", "2", "3", "5"]


@pytest.mark.parametrize("seed", range(4))
def test_assign_equals_the_references(ref, seed):
    """Random announcements (stale steps, re-announcements, evictions),
    the same questions to both brokers."""
    rng = np.random.default_rng(seed)
    ours, theirs = PeerRestoreBroker(), ref.Broker()
    for _ in range(12):
        pid, step = int(rng.integers(0, 6)), int(rng.integers(3, 6))
        for broker in (ours, theirs):
            broker.announce("s", pid, 6, step, f"h{pid}:{step}")
    evicted = int(rng.integers(0, 6))
    for broker in (ours, theirs):
        broker.evict("s", evicted)
    for pid in range(6):
        group = sorted(int(g) for g in rng.choice(6, 2, replace=False))
        for step in (-1, 3, 4, 5, 9):
            got = ours.assign("s", pid, step=step, group=group)
            want = theirs.assign("s", pid, step=step, group=group)
            assert got == want
            assert list(got["donors"]) == list(want["donors"])
    assert ours.assign("other", 0) == theirs.assign("other", 0)


# ---------------------------------------------------------------------------
# Across the packages.
# ---------------------------------------------------------------------------


def _both_recover(ref, f, shm_port, shm_ref, pid_port, pid_ref, **kw):
    """The same recovery through each package's ``recover``."""
    ours = peer_restore.recover(
        scope=f.scope, process_id=pid_port, num_processes=f.nprocs,
        shm=shm_port, **kw)
    theirs = ref.peer.recover(
        scope=f.scope, process_id=pid_ref, num_processes=f.nprocs,
        shm=shm_ref, **kw)
    return ours, theirs


@pytest.mark.parametrize("server", ["reference", "port"])
@pytest.mark.parametrize("scenario", ["clean", "torn_donor", "dead_donor"])
def test_each_package_recovers_from_the_others_endpoint(ref, fleet,
                                                        server, scenario):
    """The donors' segments are the port's; ``server`` says whose
    endpoints serve them.  Both packages' ``recover`` fill a segment
    byte-equal to the donor's, and their reports agree."""
    cls = (ref.peer.PeerServeEndpoint if server == "reference"
           else peer_restore.PeerServeEndpoint)
    f = fleet(step=5, endpoint_cls=cls).up([0, 2])
    reference = f.reference_payload(2)
    if scenario == "torn_donor":
        f.tear(0)
    elif scenario == "dead_donor":
        f.endpoints[0].stop()
    shm_port = f.new_shm(8)
    shm_ref = ref.Shm(shm_name(9, f.scope))
    f.shms[9] = shm_ref
    ours, theirs = _both_recover(
        ref, f, shm_port, shm_ref, 8, 9,
        checkpoint_dir="/nonexistent/ckpt", assignment=f.assignment())
    assert ours["filled"] and ours["rung"] == "peer_shm"
    assert {k: ours[k] for k in AGREED} == {k: theirs[k] for k in AGREED}
    assert set(ours) == set(theirs)
    assert _recovered(shm_port, reference)
    assert (ref.snapshot.read_meta_bytes(shm_ref), ref.snapshot
            .read_payload_range(shm_ref, 0, len(reference[1]))) == reference


def test_manifest_rung_reads_the_references_sealed_commit(ref, fleet,
                                                          tmp_path):
    """A commit the reference's ``DistributedCheckpointEngine`` sealed:
    both packages' donorless recoveries read it, byte-equal to the
    donor's segment, with the same bytes and reads."""
    f = fleet(step=5).up([0])
    ckpt_dir = str(tmp_path / "refckpt")
    stats = ref.dist.DistributedCheckpointEngine(
        ckpt_dir, process_id=0, num_processes=1,
        client=ref.dist.LocalCommitClient(),
    ).save(f.step, _arrays(f.step), wait_seal=True, timeout=30)
    assert stats["sealed"]
    reference = f.reference_payload(0)
    shm_port = f.new_shm(8)
    shm_ref = ref.Shm(shm_name(9, f.scope))
    f.shms[9] = shm_ref
    ours, theirs = _both_recover(
        ref, f, shm_port, shm_ref, 8, 9, checkpoint_dir=ckpt_dir,
        assignment={"step": f.step, "donors": {}}, plan=_plan(f.shms[0]))
    assert ours["rung"] == "manifest" and ours["filled"]
    assert ours["bytes_manifest"] == sum(
        a.nbytes for a in _arrays(f.step).values())
    assert {k: ours[k] for k in AGREED} == {k: theirs[k] for k in AGREED}
    assert _recovered(shm_port, reference)
    assert ref.snapshot.read_payload_range(
        shm_ref, 0, len(reference[1])) == reference[1]


# ---------------------------------------------------------------------------
# Over gloo ranks: the store client and the engine.
# ---------------------------------------------------------------------------


STORE_SPEC = dict(
    announce=[[5, "h0:1"], [4, "h1:1"], [5, "h2:1"]],
    groups=[[2], [2], [0]],
    pinned=4,
)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``store_client_worker`` on 3 ranks and the engine's dp=2 run under
    ``DLROVER_TPU_PEER_RESTORE=1``, in the background, while the JAX
    Trainer runs here."""
    jax = pytest.importorskip("jax")
    spec, init = lose_spec(tmp_path_factory, ["peer"])
    store_spec = dict(STORE_SPEC, scope=f"st{uuid.uuid4().hex[:8]}")
    with ThreadPoolExecutor(2) as pool:
        store = pool.submit(process_group.spawn, store_client_worker, 3,
                            (store_spec,), device="cpu",
                            timeout_s=SPAWN_TIMEOUT_S)
        engine = pool.submit(process_group.spawn, dp_workers.train_worker,
                             2, (spec,), device="cpu",
                             timeout_s=SPAWN_TIMEOUT_S)
        jax_init, losses = jax_losses(jax, STEPS + 1)
        store = store.result()
        engine = [r["runs"]["peer"] for r in engine.result()]
    for a, b in zip(jax.tree.leaves(init), jax.tree.leaves(jax_init)):
        np.testing.assert_array_equal(a, b)
    return dict(store=store, engine=engine, jax_loss=losses)


def test_store_client_assigns_as_the_broker(ranks):
    """Every rank's assignment over the store is the broker's on the same
    announcements: the newest step, the requester excluded, its group
    first."""
    got = [r["assignment"] for r in ranks["store"]]
    assert [r["broker"] for r in ranks["store"]] == got
    assert got == [
        {"step": 5, "donors": {"2": "h2:1"}},
        {"step": 5, "donors": {"2": "h2:1", "0": "h0:1"}},
        {"step": 5, "donors": {"0": "h0:1"}},
    ]
    assert [list(r["assignment"]["donors"]) for r in ranks["store"]] == [
        ["2"], ["2", "0"], ["0"]]
    assert [r["pinned"] for r in ranks["store"]] == [
        {"1": "h1:1"}, {}, {"1": "h1:1"}]


def test_store_client_reports_and_evictions_reach_every_rank(ranks):
    for r in ranks["store"]:
        assert r["world"] == 3
        assert [(x["process_id"], x["rung"]) for x in r["recoveries"]] == [
            (1, "peer_shm")]
        assert "filled" not in r["recoveries"][0]
    assert [r["after_evict"] for r in ranks["store"]] == [
        {"2": "h2:1"}, {"2": "h2:1"}, {"1": "h1:1"}]


def test_engine_refills_the_lost_rank_from_its_peer(ranks):
    """Rank 1 lost its segment; its fresh engine's load agreed on nothing,
    asked the broker over the store and refilled the segment from rank
    0's endpoint (rung peer_shm, the whole segment's payload); rank 0
    fetched nothing; both restored the saved step ``torch.equal`` and
    the next step is the uninterrupted one bitwise."""
    payload = None
    for rank, run in enumerate(ranks["engine"]):
        rec = run["lost"]
        assert rec["lost"] is (rank == 1)
        assert rec["restored_step"] == STEPS and rec["equal"] is True
        assert rec["restored"]["loss"] == rec["next"]["loss"]
        assert rec["exchange"] == {}
        if rank == 0:
            assert rec["recovery"] == {}
        else:
            report = rec["recovery"]
            assert report["rung"] == "peer_shm" and report["filled"]
            assert report["step"] == STEPS
            assert report["storage_reads"] == 0
            assert report["demoted_peers"] == []
            payload = report["bytes_peer"]
    assert payload and payload > 0


def test_peer_run_matches_the_jax_trainer(ranks):
    want = ranks["jax_loss"]
    for run in ranks["engine"]:
        np.testing.assert_allclose(run["loss"], want[:STEPS],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(run["lost"]["restored"]["loss"],
                                   want[STEPS:], rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# The bench.
# ---------------------------------------------------------------------------


BENCH_KEYS = {"recovery_mttr_s", "peer_read_gbps", "bytes_peer", "rung",
              "storage_reads", "manifest_restore_s", "manifest_bytes",
              "state_mb", "hosts", "bit_exact", "recoveries_recorded"}


def test_peer_recovery_bench_small(ref):
    got = bench.peer_recovery_bench(size_mb=1.0)
    assert set(got) == BENCH_KEYS
    assert got["bit_exact"] is True and got["rung"] == "peer_shm"
    assert got["storage_reads"] == 0 and got["hosts"] == 4
    n = (1 << 20) // 4
    assert got["bytes_peer"] == 4 * n + 4  # w and the int32 step
    assert got["manifest_bytes"] == got["bytes_peer"]
    assert got["recoveries_recorded"] == 2
    assert got["recovery_mttr_s"] > 0 and got["peer_read_gbps"] > 0
    # the reference's bench returns the same keys
    from dlrover_tpu.trainer.flash_checkpoint import bench as rbench
    import inspect

    src = inspect.getsource(rbench.peer_recovery_bench)
    assert all(f'"{key}"' in src for key in BENCH_KEYS)


def test_no_segment_is_left_behind():
    """Every test above unlinked the segments it made."""
    leftovers = [n for n in os.listdir("/dev/shm") if "_tpr" in n]
    assert leftovers == []


# ---------------------------------------------------------------------------
# The compile-cache prewarm: the kernel build directory's entries.
# ---------------------------------------------------------------------------


def _cache_dir(root, entries):
    root.mkdir(parents=True, exist_ok=True)
    for name, blob in entries.items():
        path = root / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(blob)
    return str(root)


ENTRIES = {
    "libflash_attention_0123456789abcdef.so": bytes(range(256)) * 8,
    "libflash_attention_0123456789abcdef.so.log": b"ptxas info\n",
    "librdma_ring_fedcba9876543210.so": bytes(reversed(range(256))) * 4,
}


def _serve_cache(endpoint_cls, tmp_path, entries=ENTRIES):
    cache = _cache_dir(tmp_path / f"survivor_{endpoint_cls.__module__}",
                       entries)
    return endpoint_cls(0, scope="cache", cache_dir=cache).start(), cache


@pytest.mark.parametrize("name", ["../escape", "/etc/passwd", "",
                                  "a/../../b", "missing.so"])
def test_cache_route_refuses_an_escaping_name_as_the_reference(
        ref, tmp_path, name):
    statuses = []
    for cls in (peer_restore.PeerServeEndpoint, ref.peer.PeerServeEndpoint):
        endpoint, _ = _serve_cache(cls, tmp_path)
        try:
            status, _, body = peer_restore._http_fetch(
                endpoint.addr, "/peer/cache", {"name": name}, 5.0)
            statuses.append((status, body))
        finally:
            endpoint.stop()
    assert statuses[0] == statuses[1]
    assert statuses[0][0] == (404 if name == "missing.so" else 400)


def test_cache_list_and_entries_match_the_reference(ref, tmp_path):
    entries = dict(ENTRIES, **{"sub/libnested_00000000000000aa.so": b"n"})
    got = []
    for cls in (peer_restore.PeerServeEndpoint, ref.peer.PeerServeEndpoint):
        endpoint, _ = _serve_cache(cls, tmp_path, entries)
        try:
            status, headers, body = peer_restore._http_fetch(
                endpoint.addr, "/peer/cache_list", {}, 5.0)
            listing = sorted(json.loads(body)["entries"],
                             key=lambda e: e["name"])
            blobs = {e["name"]: peer_restore._http_fetch(
                endpoint.addr, "/peer/cache", {"name": e["name"]}, 5.0)[2]
                for e in listing}
            got.append((status, peer_restore._crc_ok(headers, body),
                        listing, blobs))
        finally:
            endpoint.stop()
    assert got[0] == got[1]
    assert got[0][3] == entries


@pytest.mark.parametrize("server", ["port", "reference"])
@pytest.mark.parametrize("client", ["port", "reference"])
def test_a_prewarm_pulls_exactly_the_missing_entries(ref, tmp_path, server,
                                                     client):
    cls = (peer_restore.PeerServeEndpoint if server == "port"
           else ref.peer.PeerServeEndpoint)
    endpoint, _ = _serve_cache(cls, tmp_path)
    have = "libflash_attention_0123456789abcdef.so"
    dst = _cache_dir(tmp_path / "replacement", {have: ENTRIES[have]})
    module = peer_restore if client == "port" else ref.peer
    try:
        out = module.prewarm_compile_cache(dst, [(0, endpoint.addr)])
    finally:
        endpoint.stop()
    assert out == {"fetched": 2, "present": 1, "donor": 0,
                   "bytes": sum(len(ENTRIES[n]) for n in ENTRIES
                                if n != have)}
    assert sorted(os.listdir(dst)) == sorted(ENTRIES)  # no *.tmp debris
    for name, blob in ENTRIES.items():
        with open(os.path.join(dst, name), "rb") as f:
            assert f.read() == blob


def test_a_prewarm_rejects_a_donor_listing_that_escapes(tmp_path,
                                                        monkeypatch):
    dst = tmp_path / "replacement"
    dst.mkdir()
    listing = json.dumps({"entries": [
        {"name": "../evil.so", "nbytes": 1},
        {"name": "/abs/evil.so", "nbytes": 1},
        {"name": "libok_0000000000000001.so", "nbytes": 2}]}).encode()

    def fake_fetch(addr, route, params, timeout_s):
        body = listing if route == "/peer/cache_list" else b"ok"
        return 200, _crc_headers(body), body

    monkeypatch.setattr(peer_restore, "_http_fetch", fake_fetch)
    out = peer_restore.prewarm_compile_cache(str(dst), [(4, "h:1")])
    assert (out["fetched"], out["donor"]) == (1, 4)
    assert os.listdir(dst) == ["libok_0000000000000001.so"]
    assert not (tmp_path / "evil.so").exists()


def test_recover_prewarms_its_cache_dir_under_the_knob(fleet, tmp_path,
                                                        monkeypatch):
    f = fleet(step=5).up([0, 2])
    for endpoint in f.endpoints.values():
        endpoint.cache_dir = _cache_dir(tmp_path / "survivor", ENTRIES)
    for knob, want in (("0", 0), ("1", len(ENTRIES))):
        monkeypatch.setenv("DLROVER_TPU_PEER_CACHE_PREWARM", knob)
        dst = tmp_path / f"replacement{knob}"
        report = peer_restore.recover(
            scope=f.scope, process_id=1, num_processes=4,
            shm=f.new_shm(1), checkpoint_dir=str(tmp_path / "none"),
            assignment=f.assignment(), cache_dir=str(dst))
        assert report["filled"] and report["rung"] == "peer_shm"
        assert report["cache_prewarmed"] == want
        assert len(os.listdir(dst)) == want if dst.exists() else want == 0


def test_the_bootstrap_prewarms_before_it_counts(fleet, tmp_path,
                                                 monkeypatch):
    """Under peer restore a booting replacement pulls the libraries a
    survivor built, so its boot counts them: a warm start, no nvcc."""
    from dlrover_tpu_torch.observability import jitscope
    from dlrover_tpu_torch.ops.cuda import _build
    from dlrover_tpu_torch.trainer import bootstrap

    f = fleet(step=5).up([0])
    f.endpoints[0].cache_dir = _cache_dir(tmp_path / "survivor", ENTRIES)
    cache = tmp_path / "kernels"
    monkeypatch.setattr(_build, "BUILD_DIR", cache)
    monkeypatch.setattr(bootstrap, "_cache_status", None)
    monkeypatch.setattr(bootstrap, "_worker_ctx", bootstrap.WorkerContext())
    monkeypatch.delenv("DLROVER_TPU_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("DLROVER_TPU_PEER_RESTORE", "1")
    peer_restore.register_context(
        client=peer_restore.LocalPeerClient(f.broker), scope=f.scope,
        process_id=1, num_processes=4)
    bootstrap._setup_compile_cache()
    info = bootstrap.compile_cache_info()
    assert info["entries_at_boot"] == 2  # the two libraries, not the log
    assert sorted(os.listdir(cache)) == sorted(ENTRIES)
    try:
        assert jitscope.reset_scope().warm_expected
    finally:
        jitscope.reset_scope(warm_expected=False, cache_enabled=True)
    monkeypatch.setenv("DLROVER_TPU_PEER_CACHE_PREWARM", "0")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "cold")
    bootstrap._setup_compile_cache()
    assert bootstrap.compile_cache_info()["entries_at_boot"] == 0
