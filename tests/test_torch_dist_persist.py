"""The port's distributed persist (dlrover_tpu_torch/trainer/flash_checkpoint/
distributed.py and master/ckpt_coordinator.py) against the JAX package's
(dlrover_tpu/trainer/flash_checkpoint/distributed.py,
dlrover_tpu/master/ckpt_coordinator.py).

- Ownership: the same owners as the reference's for nested dicts of numpy
  arrays under the replicated-hosts shape (1-4 processes), and for a leaf
  a ``NamedSharding`` over the conftest's 8 CPU devices splits in 2 and 4
  (the devices dealt to 4 processes, two each) against the port's boxes
  of the same split.
- The coordinator: one sequence of manifests fed to both (the reference
  tests' cases: a hole, a duplicate replica, a re-report, a backwards
  step, bounded pending state, and a GC window) gives the same status
  after each report, the same sealed union manifests, and the same files.
- Cross-reads: a commit either package seals reads bit-exact through the
  other's ``read_slice`` (whole leaves and part boxes), with the same
  ``bytes_read`` under ``DLROVER_TPU_VERIFY_CRC`` lazy and off.
- The reference's own cases (tests/test_distributed_ckpt.py:
  TestBackendParity, TestCoordinator, TestDifferentialChain,
  TestPartialRead, TestEngineSaverHandoff) on the port, at their sizes,
  posix only; where the reference injects a fault with its chaos module
  (not ported), the port's tests break the files or the storage directly.
- Over a gloo world on the CPU (tests/torch_dist_persist_checks.py and
  ``dp_workers.train_worker``): the tiny Llama on fsdp=2 x tp=2 and a
  quantized dp=4 trainer save with the knob set, every distinct box
  written by exactly one rank; a step seals only once every rank reported,
  and a missing report leaves the previous step restorable; a restore onto
  fsdp=2 and onto one rank continues the JAX Trainer's uninterrupted
  losses within 1e-6 relative (the tolerance
  tests/test_torch_flash_checkpoint_dist.py states); and ``load_state``
  across a dp change under the knob raises as the reference's does over
  more than one process.

Each spawn has its own timeout.
"""

import contextlib
import json
import os
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.common import storage as port_storage
from dlrover_tpu_torch.master.ckpt_coordinator import CkptCommitCoordinator
from dlrover_tpu_torch.parallel import collectives, dp_workers, process_group
from dlrover_tpu_torch.trainer.flash_checkpoint import (
    Checkpointer,
    StorageType,
    snapshot,
)
from dlrover_tpu_torch.trainer.flash_checkpoint import distributed as dist
from dlrover_tpu_torch.common.multi_process import SharedMemoryBuffer

from torch_ckpt_checks import MLP_DIMS
from torch_dist_persist_checks import ef_dist_worker, seal_worker

SPAWN_TIMEOUT_S = 180.0
LOSS_RTOL = 1e-6
B, S, STEPS = 16, 16, 2
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=100)


@contextlib.contextmanager
def _env(**overrides: str):
    saved: Dict[str, Optional[str]] = {}
    for key, value in overrides.items():
        saved[key] = os.environ.get(key)
        os.environ[key] = value
    try:
        yield
    finally:
        for key, old in saved.items():
            if old is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = old


@pytest.fixture(autouse=True)
def _clean():
    dist.set_commit_client(None)
    yield
    dist.set_commit_client(None)


@pytest.fixture(scope="module")
def ref():
    """The reference's modules (JAX imported here only)."""
    pytest.importorskip("jax")
    from dlrover_tpu.master import ckpt_coordinator
    from dlrover_tpu.trainer.flash_checkpoint import distributed

    return dict(dist=distributed, coordinator=ckpt_coordinator)


def _state(step: float, n: int = 4096) -> Dict:
    return {"w": torch.arange(n, dtype=torch.float32) + float(step),
            "b": torch.ones(512) * float(step),
            "step": int(step)}


def _target(n: int = 4096) -> Dict:
    return {"w": torch.zeros(n), "b": torch.zeros(512), "step": -1}


def _equal(got, want) -> bool:
    return dp_workers.state_equal(got, dp_workers.state_copy(want))


def _two_host_engines(ckpt_dir, coordinator=None, storage=None):
    coordinator = coordinator or CkptCommitCoordinator()
    client = dist.LocalCommitClient(coordinator)
    return [
        dist.DistributedCheckpointEngine(
            ckpt_dir, process_id=p, num_processes=2, client=client,
            storage=storage)
        for p in range(2)
    ], coordinator


def _reader(ckpt_dir):
    return dist.DistributedCheckpointEngine(ckpt_dir, process_id=0,
                                            num_processes=1)


def _saved(ckpt_dir, step, state=None, coordinator=None):
    """``state`` (``_state(step)``) sealed at ``step`` by two hosts."""
    engines, coord = _two_host_engines(ckpt_dir, coordinator)
    state = state or _state(step)
    engines[0].save(step, state, wait_seal=False)
    stats = engines[1].save(step, state, wait_seal=True, timeout=30)
    assert stats["sealed"], stats
    return engines, coord


# -- ownership ----------------------------------------------------------------


def _nested_numpy():
    rng = np.random.default_rng(0)
    return {
        "params": {"dense": {"kernel": rng.standard_normal((8, 4)).astype(
                                 np.float32),
                             "bias": np.zeros(4, np.float32)},
                   "emb": rng.standard_normal((16, 8)).astype(np.float32)},
        "opt": {"mu": {"kernel": np.ones((8, 4), np.float32)},
                "count": np.asarray(3, np.int32)},
        "step": np.asarray(5, np.int64),
    }


@pytest.mark.parametrize("num_processes", [1, 2, 3, 4])
def test_owners_equal_the_reference_on_replicated_hosts(ref, num_processes):
    """Every process's owned boxes, by leaf path, are the reference's."""
    state = _nested_numpy()
    for p in range(num_processes):
        got = dist.owned_event_map(state, p, num_processes)
        want = ref["dist"].owned_event_map(state, p, num_processes)
        assert got == want and got, p


class _Device:
    def __init__(self, device, per: int):
        self.id = device.id
        self.process_index = device.id // per


class _Sharding:
    """A sharding whose devices belong to processes of ``per`` devices."""

    def __init__(self, sharding, per: int):
        self._sharding, self._per = sharding, per

    def devices_indices_map(self, shape):
        return {_Device(d, self._per): idx for d, idx in
                self._sharding.devices_indices_map(shape).items()}


class _MultiProcessArray:
    """A jax array seen as if its 8 devices were 4 processes' (2 each)."""

    def __init__(self, arr, per: int):
        self._arr = arr
        self.shape, self.dtype = arr.shape, arr.dtype
        self.addressable_shards = arr.addressable_shards
        self.sharding = _Sharding(arr.sharding, per)


@pytest.mark.parametrize("split", [2, 4])
def test_owners_of_a_split_leaf_equal_the_reference(ref, monkeypatch, split):
    """A (32, 4) leaf split in ``split`` row blocks over the 8 devices and a
    leaf replicated on all: 4 processes of 2 devices each.  The groups and
    owners of each process's box are the reference's, from the port's
    layouts of the same split."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    procs, per = 4, 2
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(split, 8 // split),
                ("x", "y"))
    split_leaf = jax.device_put(
        jnp.arange(32 * 4, dtype=jnp.float32).reshape(32, 4),
        NamedSharding(mesh, PartitionSpec("x")))
    whole_leaf = jax.device_put(jnp.ones((6,), jnp.float32),
                                NamedSharding(mesh, PartitionSpec()))
    monkeypatch.setattr(jax, "process_count", lambda: procs)
    ref_state = {"w": _MultiProcessArray(split_leaf, per),
                 "b": _MultiProcessArray(whole_leaf, per)}
    rows = 32 // split
    layouts = []
    for p in range(procs):
        block = p * per * split // 8  # the row block of p's devices
        layouts.append({"w": ([32, 4], [[block * rows, (block + 1) * rows],
                                         [0, 4]])})
    for p in range(procs):
        want = {}
        for leaf in ref["dist"].plan_dist_shards(ref_state, p, procs)[0]:
            for s in leaf["shards"]:
                want[s["key"]] = (s["group"], s["owner"])
        (lo, hi), _ = layouts[p]["w"][1]
        port_state = {"w": torch.zeros(hi - lo, 4), "b": torch.ones(6)}
        leaves, pid, n = dist.plan_dist_shards(port_state, p, procs,
                                               layouts=layouts)
        assert (pid, n) == (p, procs)
        for leaf in leaves:
            (s,) = leaf["shards"]
            assert (s["group"], s["owner"]) == want[s["key"]], s["key"]
        groups = {leaf["path"]: leaf["shards"][0]["group"]
                  for leaf in leaves}
        assert len(groups["w"]) == 8 // split // per or split == 4
        assert groups["b"] == list(range(procs))


# -- the coordinator ----------------------------------------------------------


def _manifest(step, pid, nprocs, spans, file_step=None, gshape=100):
    file_step = step if file_step is None else file_step
    return {
        "format": 1, "step": step, "process_id": pid,
        "num_processes": nprocs, "extras": {"at": step}, "files": {},
        "stats": {"bytes_written": 4 * sum(b - a for a, b in spans)},
        "leaves": [{
            "path": "w", "dtype": "float32", "gshape": [gshape],
            "shards": [{
                "index": [[a, b]], "shape": [b - a],
                "file": f"shards/s{file_step}_h{pid}.bin", "offset": 0,
                "nbytes": 4 * (b - a), "crc32": 1, "step": file_step,
            } for a, b in spans],
        }],
    }


# (step, process, processes, spans, file step) reports, in order
COORDINATOR_CASES = {
    "hole": [(4, 0, 2, [(0, 50)], None), (4, 1, 2, [(60, 100)], None),
             (4, 1, 2, [(50, 100)], None)],
    "duplicate_replica": [(4, 0, 3, [(0, 50)], None),
                          (4, 1, 3, [(0, 50)], None)],
    "re_report": [(4, 0, 2, [(0, 50)], None), (4, 1, 2, [(50, 100)], None),
                  (4, 1, 2, [(50, 100)], None)],
    "backwards": [(8, 0, 2, [(0, 50)], None), (8, 1, 2, [(50, 100)], None),
                  (4, 0, 2, [(0, 50)], None), (4, 1, 2, [(50, 100)], None)],
    "bounded_pending": [(s, 0, 2, [(0, 50)], None) for s in range(1, 25)],
    "chain_gc": [r for s in range(1, 7) for r in (
        (s, 0, 2, [(0, 50)], 1 if s % 2 else None),
        (s, 1, 2, [(50, 100)], None))],
}


def _touch_shard_files(ckpt_dir, manifest):
    for leaf in manifest["leaves"]:
        for rec in leaf["shards"]:
            path = os.path.join(ckpt_dir, rec["file"])
            if not os.path.exists(path):
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "wb") as f:
                    f.write(b"\0" * rec["nbytes"])


def _files(ckpt_dir):
    out = {}
    for sub in (dist.SHARDS_DIR, dist.MANIFESTS_DIR):
        out[sub] = sorted(os.listdir(os.path.join(ckpt_dir, sub))) \
            if os.path.isdir(os.path.join(ckpt_dir, sub)) else []
    path = dist.committed_path(ckpt_dir)
    out["COMMITTED"] = open(path).read() if os.path.exists(path) else None
    return out


@pytest.mark.parametrize("case", sorted(COORDINATOR_CASES))
def test_coordinator_decides_as_the_reference_does(ref, tmp_path, case):
    """After every report the two coordinators agree on the step's status
    and the committed step; at the end, on every sealed union manifest
    (as JSON), the pending state kept, and the files GC left."""
    dirs = {"port": str(tmp_path / "port"), "ref": str(tmp_path / "ref")}
    coords = {"port": CkptCommitCoordinator(),
              "ref": ref["coordinator"].CkptCommitCoordinator()}
    with _env(DLROVER_TPU_DIST_MANIFEST_KEEP="2"):
        for step, pid, n, spans, file_step in COORDINATOR_CASES[case]:
            manifest = _manifest(step, pid, n, spans, file_step)
            got = {}
            for name, coord in coords.items():
                _touch_shard_files(dirs[name], manifest)
                ok = coord.report_manifest(dirs[name], step, pid, n,
                                           json.dumps(manifest))
                got[name] = (ok, coord.status(dirs[name], step),
                             coord.committed_step(dirs[name]))
            assert got["port"] == got["ref"], (step, pid)
    files = {name: _files(d) for name, d in dirs.items()}
    assert files["port"] == files["ref"]
    for name in files["port"][dist.MANIFESTS_DIR]:
        mine, theirs = (json.load(open(os.path.join(
            dirs[k], dist.MANIFESTS_DIR, name))) for k in ("port", "ref"))
        assert mine == theirs, name
    pending = {k: sorted(c._pending.get(dirs[k], {}))
               for k, c in coords.items()}
    assert pending["port"] == pending["ref"]
    if case == "bounded_pending":
        assert len(pending["port"]) == CkptCommitCoordinator.MAX_PENDING
    snap = coords["port"].snapshot()["dirs"][dirs["port"]]
    assert snap["committed_step"] == coords["port"].committed_step(
        dirs["port"])


# -- cross-reads --------------------------------------------------------------


def _cross_state_np():
    """Leaves of three dtypes, bf16 among them, as numpy (the reference
    side; ml_dtypes' bfloat16 comes with JAX)."""
    import ml_dtypes

    rng = np.random.default_rng(3)
    return {
        "w": rng.standard_normal((64, 16)).astype(np.float32),
        "h": rng.standard_normal((32, 8)).astype(ml_dtypes.bfloat16),
        "n": {"x": np.arange(15, dtype=np.int32).reshape(5, 3)},
    }


def _as_port(state_np):
    out = {}
    for k, v in state_np.items():
        if isinstance(v, dict):
            out[k] = _as_port(v)
        elif v.dtype.name == "bfloat16":
            out[k] = torch.from_numpy(v.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            out[k] = torch.from_numpy(v.copy())
    return out


def _bits(x) -> np.ndarray:
    """Raw bytes of a slice from either package, for a bit-exact compare."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


SLICES = {
    "w": [(slice(0, 64), slice(0, 16)), (slice(16, 48), slice(0, 16)),
          (slice(8, 40), slice(4, 12))],
    "h": [(slice(0, 32), slice(0, 8)), (slice(0, 16), slice(0, 8))],
    "n/x": [(slice(0, 5), slice(0, 3)), (slice(1, 3), slice(0, 3))],
}


def _read_both(ref, ckpt_dir, crc_mode):
    """``{(leaf, box): (port bytes, ref bytes, port read, ref read)}``."""
    port_reader = _reader(ckpt_dir)
    ref_reader = ref["dist"].DistributedCheckpointEngine(
        ckpt_dir, process_id=0, num_processes=1)
    out = {}
    with _env(DLROVER_TPU_VERIFY_CRC=crc_mode):
        for path, boxes in SLICES.items():
            for box in boxes:
                stats = ({"bytes_read": 0, "shards_fetched": 0},
                         {"bytes_read": 0, "shards_fetched": 0})
                mine = port_reader.read_slice(path, box, stats=stats[0])
                theirs = ref_reader.read_slice(path, box, stats=stats[1])
                out[(path, str(box))] = (_bits(mine), _bits(theirs),
                                         stats[0], stats[1])
    return out


@pytest.mark.parametrize("crc_mode", ["lazy", "off"])
def test_port_commit_reads_bit_exact_in_the_reference(ref, tmp_path,
                                                      crc_mode):
    ckpt_dir = str(tmp_path / "ckpt")
    state_np = _cross_state_np()
    _saved(ckpt_dir, 3, state=_as_port(state_np))
    for key, (mine, theirs, s_mine, s_theirs) in _read_both(
            ref, ckpt_dir, crc_mode).items():
        np.testing.assert_array_equal(mine, theirs, err_msg=str(key))
        assert s_mine == s_theirs, key


@pytest.mark.parametrize("crc_mode", ["lazy", "off"])
def test_reference_commit_reads_bit_exact_in_the_port(ref, tmp_path,
                                                      crc_mode):
    """Sealed by two reference hosts; read by both, and restored whole by
    the port's ``load`` into a target of its tensors."""
    rdist = ref["dist"]
    ckpt_dir = str(tmp_path / "ckpt")
    state_np = _cross_state_np()
    client = rdist.LocalCommitClient(
        ref["coordinator"].CkptCommitCoordinator())
    engines = [rdist.DistributedCheckpointEngine(
        ckpt_dir, process_id=p, num_processes=2, client=client)
        for p in range(2)]
    engines[0].save(3, state_np, wait_seal=False)
    assert engines[1].save(3, state_np, wait_seal=True, timeout=30)["sealed"]
    read = _read_both(ref, ckpt_dir, crc_mode)
    for key, (mine, theirs, s_mine, s_theirs) in read.items():
        np.testing.assert_array_equal(mine, theirs, err_msg=str(key))
        assert s_mine == s_theirs, key
    want = _as_port(state_np)
    target = {"w": torch.zeros(64, 16),
              "h": torch.zeros(32, 8, dtype=torch.bfloat16),
              "n": {"x": torch.zeros(5, 3, dtype=torch.int32)}}
    got, step = _reader(ckpt_dir).load(target)
    assert step == 3 and _equal(got, want)


def test_a_sharded_reference_commit_reads_the_same_bytes(ref, tmp_path):
    """A (64, 16) leaf the reference stored as 8 row blocks (one per
    device): a box over 2 of them reads the same bytes in both packages,
    whole blocks when verifying and the rows alone when not."""
    import jax
    import jax.numpy as jnp

    rdist = ref["dist"]
    mesh = jax.sharding.Mesh(np.array(jax.devices()), ("x",))
    arr = jax.device_put(
        jnp.arange(64 * 16, dtype=jnp.float32).reshape(64, 16),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("x")))
    ckpt_dir = str(tmp_path / "ckpt")
    engine = rdist.DistributedCheckpointEngine(
        ckpt_dir, process_id=0, num_processes=1,
        client=rdist.LocalCommitClient())
    assert engine.save(1, {"w": arr}, wait_seal=True, timeout=30)["sealed"]
    box = (slice(4, 12), slice(0, 16))
    for mode, want_bytes in (("lazy", 2 * 8 * 16 * 4),
                             ("off", 8 * 16 * 4)):
        with _env(DLROVER_TPU_VERIFY_CRC=mode):
            stats = [{"bytes_read": 0, "shards_fetched": 0} for _ in "ab"]
            mine = _reader(ckpt_dir).read_slice("w", box, stats=stats[0])
            theirs = rdist.DistributedCheckpointEngine(
                ckpt_dir, process_id=0, num_processes=1).read_slice(
                    "w", box, stats=stats[1])
        np.testing.assert_array_equal(mine.numpy(), theirs)
        assert stats[0] == stats[1]
        assert stats[0] == {"bytes_read": want_bytes, "shards_fetched": 2}


# -- the reference's cases, on the port ---------------------------------------


def test_commit_and_bitexact_restore(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    _, coord = _saved(ckpt_dir, 5)
    assert dist.read_committed_step(ckpt_dir) == 5
    manifest = dist.read_manifest(ckpt_dir, 5)
    assert set(manifest["hosts"]) == {"0", "1"}
    files = [m["files"] for m in coord._pending[ckpt_dir][5].manifests.values()]
    for per_host in files:
        for entry in per_host.values():
            assert entry["chunks"], "missing chunk CRC records"
            for chunk in entry["chunks"]:
                assert {"offset", "nbytes", "crc32"} <= set(chunk)
    restored, step = _reader(ckpt_dir).load(_target())
    assert step == 5 and _equal(restored, _state(5))


@pytest.mark.parametrize("damage", ["dropped", "torn"])
def test_damaged_payload_is_detected(tmp_path, damage):
    """A payload that never landed (removed) or was cut mid-write
    (truncated to half) fails the restore: it raises, and fabricates no
    bytes."""
    ckpt_dir = str(tmp_path / "ckpt")
    _saved(ckpt_dir, 7)
    shards = os.path.join(ckpt_dir, dist.SHARDS_DIR)
    victim = os.path.join(shards, sorted(os.listdir(shards))[0])
    if damage == "dropped":
        os.remove(victim)
    else:
        with open(victim, "r+b") as f:
            f.truncate(os.path.getsize(victim) // 2)
    with _env(DLROVER_TPU_VERIFY_CRC="lazy"):
        with pytest.raises((OSError, ValueError)):
            _reader(ckpt_dir).load(_target())


def test_seal_refused_until_union_covers(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    engines, coord = _two_host_engines(ckpt_dir)
    engines[0].save(4, _state(4), wait_seal=False)
    status = coord.status(ckpt_dir, 4)
    assert not status["sealed"]
    assert status["reported"] == 1 and status["expected"] == 2
    assert dist.read_committed_step(ckpt_dir) == -1
    engines[1].save(4, _state(4), wait_seal=True, timeout=30)
    assert coord.status(ckpt_dir, 4)["sealed"]


def test_idempotent_re_report_and_monotonic_pointer(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    engines, coord = _saved(ckpt_dir, 8)
    assert engines[1].save(8, _state(8), wait_seal=True, timeout=30)["sealed"]
    assert coord.committed_step(ckpt_dir) == 8
    # a late commit of an OLDER step seals but never regresses the pointer
    _saved(ckpt_dir, 4, coordinator=coord)
    assert dist.read_committed_step(ckpt_dir) == 8
    assert dist.read_manifest(ckpt_dir, 4) is not None


def test_duplicate_replica_records_cannot_fake_coverage(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    coord = CkptCommitCoordinator()
    for pid in (0, 1):
        coord.report_manifest(ckpt_dir, 4, pid, 3, json.dumps(
            _manifest(4, pid, 3, [(0, 50)])))
    assert not coord.status(ckpt_dir, 4)["sealed"]
    assert dist.read_committed_step(ckpt_dir) == -1


def test_pending_state_bounded_without_seals(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    coord = CkptCommitCoordinator()
    engine = dist.DistributedCheckpointEngine(
        ckpt_dir, process_id=0, num_processes=2,
        client=dist.LocalCommitClient(coord))
    for step in range(1, 25):
        engine.save(step, _state(step, n=64), wait_seal=False)
    assert len(coord._pending[ckpt_dir]) <= coord.MAX_PENDING
    assert max(coord._pending[ckpt_dir]) == 24


def test_manifest_scan_fallback_when_pointer_unreadable(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    _saved(ckpt_dir, 4)
    with open(dist.committed_path(ckpt_dir), "w") as f:
        f.write("garbage")
    assert dist.read_committed_step(ckpt_dir) == 4


def _chain_state(values):
    return {name: torch.full((2048,), val) for name, val in values.items()}


def _run_chain(ckpt_dir, steps, rng):
    engines, coord = _two_host_engines(ckpt_dir)
    values = {f"leaf_{i}": float(i) for i in range(6)}
    expected = {}
    for step in steps:
        mutate = rng.choice(sorted(values), size=rng.integers(1, 6),
                            replace=False)
        for name in mutate:
            values[name] = float(rng.integers(0, 1_000_000))
        state = _chain_state(values)
        engines[0].save(step, state, wait_seal=False)
        stats = engines[1].save(step, state, wait_seal=True, timeout=30)
        assert stats["sealed"], f"step {step} failed to seal"
        expected[step] = dict(values)
    return expected


def _assert_bitexact(ckpt_dir, step, values):
    target = _chain_state({k: -1.0 for k in values})
    restored, got = _reader(ckpt_dir).load(target, step=step)
    assert got == step
    assert _equal(restored, _chain_state(values)), f"step {step}"


def test_chain_restores_every_step_then_gc(tmp_path):
    rng = np.random.default_rng(1234)
    steps = list(range(1, 8))
    ckpt_dir = str(tmp_path / "ckpt")
    with _env(DLROVER_TPU_DIST_MANIFEST_KEEP="32"):
        expected = _run_chain(ckpt_dir, steps, rng)
        for step in steps:
            _assert_bitexact(ckpt_dir, step, expected[step])
    gc_dir = str(tmp_path / "gc")
    with _env(DLROVER_TPU_DIST_MANIFEST_KEEP="3"):
        expected = _run_chain(gc_dir, steps, rng)
    retained, dropped = steps[-3:], steps[:-3]
    for step in dropped:
        assert dist.read_manifest(gc_dir, step) is None
    for step in retained:
        _assert_bitexact(gc_dir, step, expected[step])
    referenced = set()
    for step in retained:
        for leaf in dist.read_manifest(gc_dir, step)["leaves"]:
            for rec in leaf["shards"]:
                referenced.add(os.path.basename(rec["file"]))
    on_disk = set(os.listdir(os.path.join(gc_dir, dist.SHARDS_DIR)))
    for name in on_disk - referenced:
        assert int(name.split("_", 1)[0][1:]) >= min(retained), name
    assert referenced <= on_disk


class _FailOnce(port_storage.PosixDiskStorage):
    """Posix storage whose first payload write raises."""

    def __init__(self):
        super().__init__()
        self.failed = False

    def write_chunks(self, content, path, chunk_bytes, writers=1):
        if not self.failed:
            self.failed = True
            raise OSError("write failed")
        return super().write_chunks(content, path, chunk_bytes, writers)


def test_failed_write_does_not_poison_diff_cache(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    engines, _ = _two_host_engines(ckpt_dir, storage=_FailOnce())
    state = _state(1)
    with pytest.raises(OSError, match="write failed"):
        engines[0].save(1, state, wait_seal=False)
    stats0 = engines[0].save(1, state, wait_seal=False)
    assert stats0["shards_written"] > 0 and stats0["shards_reused"] == 0
    assert engines[1].save(1, state, wait_seal=True, timeout=30)["sealed"]
    restored, step = _reader(ckpt_dir).load(_target())
    assert step == 1 and _equal(restored, state)


@pytest.mark.parametrize("damage", ["truncated", "missing"])
def test_damaged_reuse_target_is_rewritten(tmp_path, damage):
    """A cached 'unchanged' shard whose file was truncated or removed is
    written again: no sealed record points past its file."""
    ckpt_dir = str(tmp_path / "ckpt")
    engines, _ = _saved(ckpt_dir, 1)
    shards_dir = os.path.join(ckpt_dir, dist.SHARDS_DIR)
    for name in os.listdir(shards_dir):
        path = os.path.join(shards_dir, name)
        if damage == "missing":
            os.remove(path)
        else:
            with open(path, "r+b") as f:
                f.truncate(max(1, os.path.getsize(path) // 2))
    state = _state(1)
    engines[0].save(2, state, wait_seal=False)
    assert engines[1].save(2, state, wait_seal=True, timeout=30)["sealed"]
    rewritten = 0
    for leaf in dist.read_manifest(ckpt_dir, 2)["leaves"]:
        for rec in leaf["shards"]:
            size = os.path.getsize(os.path.join(ckpt_dir, rec["file"]))
            assert rec["offset"] + rec["nbytes"] <= size
            rewritten += rec["step"] == 2
            if damage == "missing":
                assert rec["step"] == 2
    assert rewritten > 0
    restored, step = _reader(ckpt_dir).load(_target())
    assert step == 2 and _equal(restored, state)


def test_unchanged_state_reuses_every_shard(tmp_path):
    """A second save of the same values writes nothing and restores
    bit-exact from records that chain back."""
    ckpt_dir = str(tmp_path / "ckpt")
    engines, _ = _saved(ckpt_dir, 1, state=_state(1))
    engines[0].save(2, _state(1), wait_seal=False)
    stats = engines[1].save(2, _state(1), wait_seal=True, timeout=30)
    assert stats["sealed"] and stats["bytes_written"] == 0
    assert stats["bytes_reused"] > 0
    restored, step = _reader(ckpt_dir).load(_target())
    assert step == 2 and _equal(restored, _state(1))


def _row_blocks_dir(tmp_path):
    """A (64, 16) leaf in 8 row blocks, one per simulated host."""
    full = torch.arange(64 * 16, dtype=torch.float32).reshape(64, 16)
    layouts = [{"w": ([64, 16], [[8 * p, 8 * p + 8], [0, 16]])}
               for p in range(8)]
    ckpt_dir = str(tmp_path / "ckpt")
    client = dist.LocalCommitClient(CkptCommitCoordinator())
    for p in range(8):
        stats = dist.DistributedCheckpointEngine(
            ckpt_dir, process_id=p, num_processes=8, client=client).save(
                1, {"w": full[8 * p:8 * p + 8]}, wait_seal=p == 7,
                timeout=30, layouts=layouts)
        assert stats["shards_written"] == 1
    assert stats["sealed"]
    return ckpt_dir, full


def test_partial_read_fetches_only_overlapping_shards(tmp_path):
    ckpt_dir, full = _row_blocks_dir(tmp_path)
    stats = {"bytes_read": 0, "shards_fetched": 0}
    out = _reader(ckpt_dir).read_slice("w", (slice(0, 16), slice(0, 16)),
                                       stats=stats)
    assert torch.equal(out, full[:16])
    assert stats == {"bytes_read": 16 * 16 * 4, "shards_fetched": 2}


def test_row_trim_reads_a_subrange_when_verify_is_off(tmp_path):
    ckpt_dir, full = _row_blocks_dir(tmp_path)
    for mode, want in (("off", 2 * 16 * 4), ("lazy", 8 * 16 * 4)):
        with _env(DLROVER_TPU_VERIFY_CRC=mode):
            stats = {"bytes_read": 0, "shards_fetched": 0}
            out = _reader(ckpt_dir).read_slice(
                "w", (slice(2, 4), slice(0, 16)), stats=stats)
        assert torch.equal(out, full[2:4])
        assert stats["bytes_read"] == want, mode


def test_corruption_detected_by_shard_crc(tmp_path):
    ckpt_dir, _ = _row_blocks_dir(tmp_path)
    rec = dist.read_manifest(ckpt_dir, 1)["leaves"][0]["shards"][0]
    with open(os.path.join(ckpt_dir, rec["file"]), "r+b") as f:
        f.seek(rec["offset"] + rec["nbytes"] // 2)
        f.write(b"\xff")
    with pytest.raises(OSError, match="checksum"):
        _reader(ckpt_dir).read_slice(
            "w", (slice(0, 64), slice(0, 16)),
            stats={"bytes_read": 0, "shards_fetched": 0})


def test_load_counts_bytes_and_fills_its_boxes(tmp_path):
    """A whole-leaf restore reads every byte; a restore into rows
    [16, 32) (a layout's box) reads only the two blocks it overlaps."""
    ckpt_dir, full = _row_blocks_dir(tmp_path)
    reader = _reader(ckpt_dir)
    restored, step = reader.load({"w": torch.zeros(64, 16)})
    assert step == 1 and torch.equal(restored["w"], full)
    assert reader.last_read_stats["bytes_read"] == full.numel() * 4
    assert reader.last_read_stats["bytes_total"] == full.numel() * 4
    restored, _ = reader.load({"w": torch.zeros(16, 16)},
                              layout={"w": ([64, 16], [[16, 32], [0, 16]])})
    assert torch.equal(restored["w"], full[16:32])
    assert reader.last_read_stats["bytes_read"] == full.numel() * 4 // 4


# -- the flash engine and the saver -------------------------------------------


def _checkpointer(ckpt_dir, **kw):
    return Checkpointer(ckpt_dir, scope=f"dh{uuid.uuid4().hex[:6]}",
                        async_snapshot=False, device="cpu", **kw)


@contextlib.contextmanager
def _closing(ckpt):
    try:
        yield ckpt
    finally:
        ckpt.engine.unlink_memory()
        ckpt.close()


def test_storage_save_seals_and_restores_through_the_saver(tmp_path):
    """With the knob, a storage save's event carries ``dist`` and this
    process's ``owned`` map, the saver seals the step and writes no legacy
    step dir, and a fresh process (empty shm) restores it through the
    flash engine."""
    ckpt_dir = str(tmp_path / "ckpt")
    dist.set_commit_client(dist.LocalCommitClient(CkptCommitCoordinator()))
    state = _state(3)
    with _env(DLROVER_TPU_DIST_PERSIST="1"):
        with _closing(_checkpointer(ckpt_dir)) as ckpt:
            ckpt.save_checkpoint(3, state, StorageType.DISK)
            assert ckpt.wait_latest_checkpoint(timeout=30)
            event = ckpt.engine._save_event(3)
        assert event["dist"] is True
        assert event["owned"] == {"w": [[[0, 4096]]], "b": [[[0, 512]]],
                                  "step": [[]]}
        assert dist.read_committed_step(ckpt_dir) == 3
        assert not os.path.exists(os.path.join(ckpt_dir, "3"))
        with _closing(_checkpointer(ckpt_dir)) as ckpt:
            restored, step = ckpt.load_checkpoint(_target())
            stats = ckpt.engine.last_read_stats
    assert step == 3 and _equal(restored, state)
    assert stats["bytes_read"] == stats["bytes_total"] == 4096 * 4 + 512 * 4 + 8


def test_without_the_knob_the_event_is_legacy(tmp_path):
    with _closing(_checkpointer(str(tmp_path / "ckpt"))) as ckpt:
        ckpt.save_checkpoint(1, _state(1), StorageType.DISK)
        assert ckpt.wait_latest_checkpoint(timeout=30)
        assert "dist" not in ckpt.engine._save_event(1)
    assert os.path.isdir(str(tmp_path / "ckpt" / "1"))


def test_empty_owned_map_is_authoritative(tmp_path):
    """A present map that owns nothing persists nothing (its manifest
    still carries the leaf specs); only a missing map (save-on-failure)
    persists every local shard."""
    ckpt_dir = str(tmp_path / "ckpt")
    # two hosts simulated in one process share an injected coordinator
    dist.set_commit_client(dist.LocalCommitClient(CkptCommitCoordinator()))
    shm = SharedMemoryBuffer(f"dctest_{uuid.uuid4().hex[:8]}")
    try:
        snapshot.write_snapshot(shm, 2, snapshot.extract_host_shards(
            _state(2)))
        meta = snapshot.read_snapshot_meta(shm)
        owned_nothing = {leaf["path"]: [] for leaf in meta["leaves"]}
        manifest, stats, step = dist.DistributedPersister(
            ckpt_dir, 1, 2).persist_from_shm(shm, meta, owned_nothing)
        assert step == 2 and stats["shards_written"] == 0
        assert stats["shards_skipped_replica"] == 3
        assert {lf["path"] for lf in manifest["leaves"]} == {
            lf["path"] for lf in meta["leaves"]}
        _, stats2, _ = dist.DistributedPersister(
            ckpt_dir, 0, 2).persist_from_shm(shm, meta, None)
        assert stats2["shards_written"] == 3
    finally:
        shm.unlink()
        shm.close()


class _Recorder(dist.LocalCommitClient):
    """A local client that records reports, and can drop them."""

    def __init__(self, drop: bool = False):
        super().__init__(CkptCommitCoordinator())
        self.drop, self.reports = drop, []

    def report_manifest(self, ckpt_dir, step, process_id, num_processes,
                        manifest_json):
        self.reports.append(step)
        if self.drop:
            return False
        return super().report_manifest(ckpt_dir, step, process_id,
                                       num_processes, manifest_json)


def test_unsealed_commit_fails_the_exit_barrier(tmp_path):
    """A report that never lands (the host died before reporting) leaves
    the step unsealed: the exit barrier says so, nothing is committed."""
    ckpt_dir = str(tmp_path / "ckpt")
    dist.set_commit_client(_Recorder(drop=True))
    with _env(DLROVER_TPU_DIST_PERSIST="1",
              DLROVER_TPU_DIST_COMMIT_TIMEOUT_S="1"):
        with _closing(_checkpointer(ckpt_dir)) as ckpt:
            ckpt.save_checkpoint(3, _state(3), StorageType.DISK)
            assert not ckpt.wait_latest_checkpoint(timeout=5)
    assert dist.read_committed_step(ckpt_dir) == -1


def test_a_torn_snapshot_is_never_reported(tmp_path, monkeypatch):
    """The saver's re-check of the shm generation runs before the phase-1
    report: a lock-free persist (dead owner) whose snapshot a writer
    moved under it reports nothing and persists no step."""
    from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver

    ckpt_dir = str(tmp_path / "ckpt")
    client = _Recorder()
    dist.set_commit_client(client)
    scope = f"tg{uuid.uuid4().hex[:6]}"
    shm = SharedMemoryBuffer(f"dlrover_tpu_ckpt_{scope}_0")
    persist = dist.DistributedPersister.persist_from_shm

    def racing(self, shm_, meta, owned):
        out = persist(self, shm_, meta, owned)
        snapshot.write_snapshot(shm_, 6, snapshot.extract_host_shards(
            _state(6)))  # a writer lands a newer snapshot meanwhile
        return out

    monkeypatch.setattr(dist.DistributedPersister, "persist_from_shm",
                        racing)
    saver = AsyncCheckpointSaver(scope=scope)
    try:
        snapshot.write_snapshot(shm, 5, snapshot.extract_host_shards(
            _state(5)))
        event = {"type": "save", "step": 5, "shm": shm.name, "lock": "",
                 "ckpt_dir": ckpt_dir, "process_id": 0, "num_processes": 1,
                 "dist": True, "owned": None}
        saver._handle_save(event)
        assert client.reports == [] and saver.persisted_step(0) == -1
        monkeypatch.setattr(dist.DistributedPersister, "persist_from_shm",
                            persist)
        saver._handle_save(dict(event, step=6))
        assert client.reports == [6] and saver.persisted_step(0) == 6
    finally:
        saver.stop()
        shm.unlink()
        shm.close()
    assert dist.read_committed_step(ckpt_dir) == 6


def test_several_processes_with_no_world_are_refused(tmp_path):
    """With no master, no world and no injected client, a commit of more
    than one process has no coordinator that could seal it: the
    persister, the engine's save and the saver's ``dist`` event refuse it
    before anything is written."""
    from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver

    ckpt_dir = str(tmp_path / "ckpt")
    item = "no master and no torch.distributed world"
    with pytest.raises(NotImplementedError, match=item):
        dist.DistributedPersister(ckpt_dir, 1, 2)
    with pytest.raises(NotImplementedError, match=item):
        dist.DistributedCheckpointEngine(
            ckpt_dir, process_id=0, num_processes=2).save(1, _state(1))
    scope = f"nw{uuid.uuid4().hex[:6]}"
    shm = SharedMemoryBuffer(f"dlrover_tpu_ckpt_{scope}_0")
    saver = AsyncCheckpointSaver(scope=scope)
    try:
        snapshot.write_snapshot(shm, 5, snapshot.extract_host_shards(
            _state(5)))
        event = {"type": "save", "step": 5, "shm": shm.name, "lock": "",
                 "ckpt_dir": ckpt_dir, "process_id": 0, "num_processes": 2,
                 "dist": True, "owned": None}
        with pytest.raises(NotImplementedError, match=item):
            saver._handle_save(event)
        assert saver.persisted_step(0) == -1
    finally:
        saver.stop()
        shm.unlink()
        shm.close()
    assert not os.path.exists(ckpt_dir)


def test_the_store_client_keeps_the_store_bounded(tmp_path):
    """The store commit client deletes each report once the coordinator
    took it, each verdict once its reporter read it, and each step's
    status once the step is committed or evicted: after 30 sealed saves
    of two processes the store holds the keys it held after the first,
    and 30 saves one process never reports add at most the coordinator's
    pending bound.  An idle service only reads the store: a FileStore's
    file does not grow while it polls."""
    store_path = str(tmp_path / "store")
    store = torch.distributed.FileStore(store_path, 1)
    ckpt_dir = str(tmp_path / "ckpt")
    with _env(DLROVER_TPU_DIST_SEAL_POLL_S="0.01",
              DLROVER_TPU_DIST_COMMIT_TIMEOUT_S="30"):
        clients = [dist.StoreCommitClient(store, p, 2) for p in range(2)]
        try:
            def save(step, pids):
                for pid in pids:
                    manifest = _manifest(step, pid, 2,
                                         [(50 * pid, 50 * pid + 50)])
                    _touch_shard_files(ckpt_dir, manifest)
                    assert clients[pid].report_manifest(
                        ckpt_dir, step, pid, 2, json.dumps(manifest))

            save(1, (0, 1))
            assert clients[1].wait_commit(ckpt_dir, 1, 30)
            keys = store.num_keys()
            for step in range(2, 31):
                save(step, (0, 1))
                assert clients[1].wait_commit(ckpt_dir, step, 30)
            assert store.num_keys() == keys
            for step in range(31, 61):
                save(step, (0,))
            status = clients[1].commit_status(ckpt_dir, 60)
            assert (status["sealed"], status["reported"],
                    status["committed_step"]) == (False, 1, 30)
            assert clients[1].commit_status(ckpt_dir, 30)["sealed"]
            assert keys < store.num_keys() <= \
                keys + CkptCommitCoordinator.MAX_PENDING
            size = os.path.getsize(store_path)
            time.sleep(0.3)
            assert os.path.getsize(store_path) == size
        finally:
            clients[0].close()
    assert dist.read_committed_step(ckpt_dir) == 30


class _CountingTrainer:
    """Gives every rank's layout of a state whole on every rank, and
    counts the calls."""

    def __init__(self):
        self.calls = 0

    def state_layout(self, state, rank=None):
        self.calls += 1
        return {}


def test_owners_are_planned_once_for_each_trainer_and_structure(
        tmp_path, monkeypatch):
    """Every rank's layout and this rank's ownership map are computed on
    the first save of a trainer's state and reused while the trainer and
    the state's structure stay: a later save makes no pass over every
    rank's leaves."""
    planned = []
    plan = dist.owned_event_map

    def counting(*args, **kwargs):
        planned.append(1)
        return plan(*args, **kwargs)

    monkeypatch.setattr(dist, "owned_event_map", counting)
    trainer = _CountingTrainer()
    with _env(DLROVER_TPU_DIST_PERSIST="1"):
        with _closing(_checkpointer(str(tmp_path / "ckpt"))) as ckpt:
            engine = ckpt.engine
            monkeypatch.setattr(engine, "num_processes", 4)
            for step in (1, 2):
                layouts = ckpt._layouts(_state(step), trainer)
                engine._note_dist_ownership(_state(step), {}, layouts)
            assert (trainer.calls, len(planned)) == (4, 1)
            assert ckpt._layouts(_state(3), trainer) is layouts
            assert engine._dist_owned == plan(_state(1), 0, 4, {},
                                              [{}] * 4)
            for state in (_state(4, n=64), _state(4, n=64)):
                layouts = ckpt._layouts(state, trainer)
                engine._note_dist_ownership(state, {}, layouts)
            assert (trainer.calls, len(planned)) == (8, 2)
            assert ckpt._layouts(_state(5, n=64), _CountingTrainer()) \
                is not layouts
            monkeypatch.setattr(engine, "num_processes", 1)


# -- over a gloo world --------------------------------------------------------


def _batch():
    ids = np.random.default_rng(0).integers(0, 256, size=(B, S + 1))
    return {"input_ids": ids[:, :-1].astype(np.int32),
            "labels": ids[:, 1:].astype(np.int32)}


def _mlp_shapes():
    out = {}
    for i, (n_in, n_out) in enumerate(MLP_DIMS):
        out[f"Dense_{i}.kernel"] = (n_in, n_out)
        out[f"Dense_{i}.bias"] = (n_out,)
    return out


def _jax_llama(jax):
    """The JAX Trainer's 4 uninterrupted steps on dp=2 x tp=2 of the
    conftest's virtual CPU devices, and its jitted init."""
    import flax.linen as nn
    import jax.numpy as jnp

    from dlrover_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from dlrover_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu.trainer import optim as joptim
    from dlrover_tpu.trainer.train import Trainer as JaxTrainer

    model = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32))
    batch = _batch()
    init = jax.tree.map(np.asarray, nn.meta.unbox(jax.jit(
        lambda rng: model.init(rng, batch["input_ids"]))(
            jax.random.PRNGKey(0))["params"]))
    mesh = build_mesh(MeshConfig(dp=2, tp=2), devices=jax.devices()[:4])
    trainer = JaxTrainer(model, joptim.create_optimizer(**OPT), mesh)
    state = trainer.create_state(jax.random.PRNGKey(0), batch["input_ids"])
    losses = []
    for _ in range(2 * STEPS):
        state, metrics = trainer.train_step(state, batch)
        losses.append(float(metrics["loss"]))
    return init, np.array(losses)


def _jax_load_state_under_the_knob(jax, ckpt_dir):
    """The reference's Trainer.load_state at dp=2 from a dp=4 save made
    under DLROVER_TPU_DIST_PERSIST, in one process: ``(step, residuals'
    max abs)``; and what its engine does with the same restore when it
    counts more than one process: the error it raises."""
    import flax.linen as nn
    import jax.numpy as jnp
    import optax

    from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu.trainer.flash_checkpoint import (
        Checkpointer as JaxCheckpointer,
    )
    from dlrover_tpu.trainer.flash_checkpoint import (
        StorageType as JaxStorageType,
    )
    from dlrover_tpu.trainer.train import Trainer as JaxTrainer

    class MLP(nn.Module):
        @nn.compact
        def __call__(self, x):
            h = x
            for i, (_, n_out) in enumerate(MLP_DIMS):
                h = nn.Dense(n_out)(h)
                if i < len(MLP_DIMS) - 1:
                    h = nn.tanh(h)
            return h[..., 0]

    def trainer(dp):
        model = MLP()

        def loss_fn(params, batch):
            pred = model.apply({"params": params}, batch["x"])
            return jnp.mean((pred - batch["y"]) ** 2)

        mesh = build_mesh(MeshConfig(dp=dp), devices=jax.devices()[:dp])
        return JaxTrainer(model, optax.adamw(1e-2), mesh, loss_fn=loss_fn,
                          grad_sync="int8_sharded")

    x = np.zeros((8, MLP_DIMS[0][0]), np.float32)
    rng = jax.random.PRNGKey(0)
    stacks = _stacks(4)
    with _env(DLROVER_TPU_DIST_PERSIST="1"):
        t = trainer(4)
        state = t.create_state(rng, x)
        state = state.replace(
            step=jnp.asarray(2, state.step.dtype),
            ef_residual={k: jax.device_put(stacks[k.replace("/", ".")],
                                           v.sharding)
                         for k, v in state.ef_residual.items()})
        ckpt = JaxCheckpointer(ckpt_dir, scope=f"j{uuid.uuid4().hex[:8]}",
                               async_snapshot=False)
        ckpt.save_checkpoint(2, state, JaxStorageType.DISK)
        assert ckpt.wait_latest_checkpoint(timeout=120)
        ckpt.engine.unlink_memory()
        ckpt.close()
        t2 = trainer(2)
        ckpt = JaxCheckpointer(ckpt_dir, scope=f"j{uuid.uuid4().hex[:8]}")
        try:
            restored, step = t2.load_state(ckpt, rng, x)
            ef = max(float(np.abs(np.asarray(v)).max())
                     for v in restored.ef_residual.values())
            engine = ckpt.engine
            engine.num_processes = 2
            error = None
            try:
                engine._load_from_storage(t2.abstract_state(rng, x),
                                          t2.state_sharding_for(rng, x))
            except ValueError as e:
                error = str(e)
        finally:
            ckpt.engine.unlink_memory()
            ckpt.close()
    return step, ef, error


def _stacks(world: int):
    rng = np.random.default_rng(2)
    layout = collectives.GradLayout(_mlp_shapes(), world)
    return {n: rng.standard_normal((world,) + _mlp_shapes()[n]).astype(
        np.float32) for n in layout.sharded_paths()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """In the background, over gloo ranks on the CPU: fsdp=2 x tp=2 trains
    the tiny Llama (the JAX model's init) 2 steps and saves under the
    knob, then fsdp=2 and one rank resume from its commit and train 2
    more; the two-phase commit walk (``seal_worker``); a dp=4 quantized
    trainer's save under the knob, then ``load_state`` at dp=2.  Here,
    meanwhile, the JAX Trainer's 4 uninterrupted steps and the reference's
    ``load_state`` under the knob."""
    jax = pytest.importorskip("jax")
    from dlrover_tpu_torch.models.convert import flax_llama_to_state_dict
    from dlrover_tpu_torch.models.llama import LlamaConfig

    root = tmp_path_factory.mktemp("dist_world")
    mesh_dir, dp_dir = str(root / "mesh"), str(root / "dp")
    tag = uuid.uuid4().hex[:8]
    jax_init, jax_losses = _jax_llama(jax)
    state_dict = {k: v.numpy() for k, v in flax_llama_to_state_dict(
        jax_init, LlamaConfig.tiny(dtype=torch.float32)).items()}
    spec = dict(preset="tiny", model=dict(dtype=torch.float32),
                state_dict=state_dict, batch=_batch(), optimizer=OPT,
                grads_dtype=None)
    saving = dict(spec, runs=[dict(
        name="fsdp2_tp2", axes=dict(dp=1, fsdp=2, tp=2), steps=STEPS,
        dist_save=dict(dir=mesh_dir, scope=f"p{tag}"))])

    def resumed(name, axes, world):
        run = dict(name=name, axes=axes, steps=STEPS,
                   resume=dict(dir=mesh_dir, scope=f"r{tag}{name}"))
        return process_group.spawn(
            dp_workers.train_worker, world, (dict(spec, runs=[run]),),
            device="cpu", timeout_s=SPAWN_TIMEOUT_S)

    def spawn(fn, n, arg):
        return process_group.spawn(fn, n, (arg,), device="cpu",
                                   timeout_s=SPAWN_TIMEOUT_S)

    with ThreadPoolExecutor(4) as pool:
        saved = pool.submit(spawn, dp_workers.train_worker, 4, saving)
        sealing = pool.submit(spawn, seal_worker, 4, dict(
            dir=str(root / "seal"), scope=f"s{tag}"))
        ef_saved = pool.submit(spawn, ef_dist_worker, 4, dict(
            dir=dp_dir, scope=f"e{tag}", save=True, stacks=_stacks(4)))
        saved = saved.result()
        onto = {"fsdp2": pool.submit(resumed, "fsdp2", dict(dp=1, fsdp=2), 2),
                "one": pool.submit(resumed, "one", dict(dp=1), 1)}
        ef_saved = ef_saved.result()
        ef_loaded = pool.submit(spawn, ef_dist_worker, 2, dict(
            dir=dp_dir, scope=f"l{tag}"))
        jax_pin = _jax_load_state_under_the_knob(
            jax, str(root / "jax_knob"))
        out = dict(saved=[r["runs"]["fsdp2_tp2"] for r in saved],
                   sealing=sealing.result(), ef_saved=ef_saved,
                   ef_loaded=ef_loaded.result(), jax_loss=jax_losses,
                   jax_pin=jax_pin)
        out.update({k: [r["runs"][k] for r in v.result()]
                    for k, v in onto.items()})
    return out


def test_every_distinct_box_is_written_by_one_rank(world):
    """fsdp=2 x tp=2 and the dp=4 quantized trainer: the ranks' summed
    ``bytes_written`` is one copy of the state's distinct boxes, every
    rank wrote some, and each rank's restore at its own mesh is
    ``torch.equal`` to the state saved."""
    for recs in ([r["dist_ckpt"] for r in world["saved"]],
                 world["ef_saved"]):
        for rec in recs:
            hosts = rec["hosts"]
            assert sorted(hosts) == ["0", "1", "2", "3"]
            written = [h["bytes_written"] for h in hosts.values()]
            assert sum(written) == rec["unique_bytes"] and all(written)
            assert rec["sealed_step"] == rec.get("step", STEPS)
    for rec in world["saved"]:
        c = rec["dist_ckpt"]
        assert c["persisted"] and c["shm_equal"] and c["storage_equal"]
        assert c["storage_step"] == STEPS
        assert c["read_stats"]["bytes_read"] < c["read_stats"]["bytes_total"]
    for rec in world["ef_saved"]:
        assert rec["persisted"] and rec["equal"] and rec["step"] == 2


def test_a_step_seals_only_once_every_rank_reported(world):
    """Over the world's store: step 2 reported by 3 of 4 ranks is not
    sealed, COMMITTED stays at step 1 and every rank restores step 1
    exactly; the last report seals step 2, which then restores."""
    for rec in world["sealing"]:
        assert rec["client"] == "StoreCommitClient"
        assert rec["step1"]["sealed"]
        assert rec["unsealed"] == {"sealed": False, "reported": 3,
                                   "committed_step": 1}
        assert rec["committed_before"] == 1
        assert rec["restored_before"] == 1 and rec["restored_equal"]
        assert rec["sealed_after"]
        assert rec["restored_after"] == 2 and rec["restored_after_equal"]


def test_restores_onto_other_meshes_continue_the_jax_run(world):
    """fsdp=2 x tp=2's 2 steps, then 2 steps from its sealed commit on
    fsdp=2 and on one rank: the JAX Trainer's 4 uninterrupted steps; the
    step after the same-mesh restore, its third."""
    want = world["jax_loss"]
    for rec in world["saved"]:
        np.testing.assert_allclose(rec["loss"], want[:STEPS], rtol=LOSS_RTOL)
        c = rec["dist_ckpt"]
        for source in ("next", "shm", "storage"):
            np.testing.assert_allclose(c[source]["loss"], want[STEPS:STEPS + 1],
                                       rtol=LOSS_RTOL)
    for name in ("fsdp2", "one"):
        for rec in world[name]:
            assert rec["resumed_step"] == STEPS
            np.testing.assert_allclose(rec["loss"], want[STEPS:],
                                       rtol=LOSS_RTOL)
            stats = rec["read_stats"]
            assert 0 < stats["bytes_read"] <= stats["bytes_total"]
    # fsdp=2 reads about half; one rank reads everything
    fsdp = world["fsdp2"][0]["read_stats"]
    assert fsdp["bytes_read"] < 0.75 * fsdp["bytes_total"]
    one = world["one"][0]["read_stats"]
    assert one["bytes_read"] == one["bytes_total"]


def test_load_state_across_a_dp_change_behaves_as_the_reference(world):
    """Under the knob the sealed commit is the only checkpoint, and its
    ``(dp=4, *leaf)`` residual stacks fail the global-shape check of a
    dp=2 target.  With more than one process the reference re-raises that
    (its engine here, told of 2 processes, and the port's 2 ranks alike);
    in one process it logs it, restores the rest and leaves the residuals
    zero (the JAX Trainer on the 8 virtual devices)."""
    step, ef_max, error = world["jax_pin"]
    assert step == 2 and ef_max == 0.0
    assert error is not None and "stored gshape [4," in error
    for rec in world["ef_loaded"]:
        assert "step" not in rec
        assert rec["error"].startswith("leaf ef_residual/")
        assert "stored gshape [4," in rec["error"]
