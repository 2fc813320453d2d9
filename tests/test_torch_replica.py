"""The port's snapshot replicas (dlrover_tpu_torch/trainer/flash_checkpoint/
replica.py and the engine's ``replica=True``) against the JAX package's
(dlrover_tpu/trainer/flash_checkpoint/replica.py, engine.py).

- The ring on raw segments, gloo ranks on the CPU
  (tests/torch_replica_checks.py ``replica_worker``): at world 2 and 3 the
  backup segment holds exactly the predecessor's segment bytes (a sign
  slip in the rotation passes world 2 and fails world 3), the reference
  drill's asymmetric payloads (tests/scripts/replica_asym_worker.py:
  100,000 against 10,001 bytes at a 4096-byte chunk) go round the ring
  and back byte-equal, a chunk size set differently on each rank takes
  the smallest and every rank runs the same rounds, and a torn segment
  contributes nothing while the collective still runs.
- The engine: a tiny Llama on a dp=2 mesh (the JAX model's init, as
  tests/test_torch_flash_checkpoint_dist.py makes it) trains 2 steps and
  makes a memory save with ``replica=True``; rank 1, as its replacement
  would, drops its segment and its backup and opens a fresh checkpointer,
  and every rank restores through the engine's retry: ``torch.equal`` on
  every rank, the next step bitwise the uninterrupted one, and that step
  the JAX Trainer's third on a dp=2 mesh within 1e-6 relative (the
  tolerance of tests/test_torch_flash_checkpoint_dist.py for fp32
  meshes).  The same run under ``DLROVER_TPU_PEER_RESTORE=1`` is held in
  tests/test_torch_peer_restore.py.
- ``replica=True`` in one process does nothing, as in the reference
  (``engine.py:430-438``).
"""

import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.common.multi_process import SharedMemoryBuffer
from dlrover_tpu_torch.parallel import dp_workers, process_group
from dlrover_tpu_torch.trainer.flash_checkpoint import (
    Checkpointer,
    StorageType,
)
from dlrover_tpu_torch.trainer.flash_checkpoint.replica import (
    BACKUP_SHM_SUFFIX,
)

from torch_replica_checks import (
    LOSS_RTOL,
    STEPS,
    jax_losses,
    lose_spec,
    replica_worker,
)

SPAWN_TIMEOUT_S = 180.0

# (name, world, sizes by rank, chunks by rank, torn ranks, lost rank)
RING_CASES = [
    ("world2", 2, [70_001, 50_000], [8192, 8192], [], 1),
    ("asym", 2, [100_000, 10_001], [4096, 4096], [], 1),
    ("world3", 3, [30_000, 20_001, 9_000], [4096, 4096, 4096], [], 1),
    ("chunk_mismatch", 3, [30_000, 20_001, 9_000], [4096, 1000, 8192], [],
     2),
    ("torn", 3, [30_000, 20_001, 9_000], [4096, 4096, 4096], [1], 2),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ring's cases on 2 and 3 ranks and the engine's dp=2 run, in
    the background, while the JAX Trainer runs here."""
    jax = pytest.importorskip("jax")
    spec, init = lose_spec(tmp_path_factory, ["replica"])
    tag = uuid.uuid4().hex[:6]
    by_world = {}
    for name, world, sizes, chunks, torn, lost in RING_CASES:
        by_world.setdefault(world, []).append(dict(
            name=name, scope=f"{tag}{name}", sizes=sizes, chunks=chunks,
            torn=torn, lost=lost))
    with ThreadPoolExecutor(3) as pool:
        ring = {world: pool.submit(process_group.spawn, replica_worker,
                                   world, (cases,), device="cpu",
                                   timeout_s=SPAWN_TIMEOUT_S)
                for world, cases in by_world.items()}
        engine = pool.submit(process_group.spawn, dp_workers.train_worker,
                             2, (spec,), device="cpu",
                             timeout_s=SPAWN_TIMEOUT_S)
        jax_init, losses = jax_losses(jax, STEPS + 1)
        ring = {world: f.result() for world, f in ring.items()}
        engine = [r["runs"]["replica"] for r in engine.result()]
    for a, b in zip(jax.tree.leaves(init), jax.tree.leaves(jax_init)):
        np.testing.assert_array_equal(a, b)
    return dict(ring=ring, engine=engine, jax_loss=losses)


def _case(runs, name):
    world = next(c[1] for c in RING_CASES if c[0] == name)
    return [rank[name] for rank in runs["ring"][world]]


@pytest.mark.parametrize("name", ["world2", "asym", "world3",
                                  "chunk_mismatch"])
def test_backup_holds_the_predecessors_segment(runs, name):
    """Rank r's backup segment holds exactly rank r - 1's bytes, and the
    exchange moved each rank's payload in the agreed chunks."""
    _, world, sizes, chunks, _, _ = next(c for c in RING_CASES
                                         if c[0] == name)
    chunk = min(min(chunks), max(sizes))
    rounds = -(-max(sizes) // chunk)
    for rank, rec in enumerate(_case(runs, name)):
        assert rec["backup"] is True
        assert rec["backup_equal"] is True, (name, rank)
        assert rec["exchange"]["sent"] == sizes[rank]
        assert rec["exchange"]["received"] == sizes[(rank - 1) % world]
        assert rec["exchange"]["chunk"] == chunk
        assert rec["exchange"]["rounds"] == rounds


@pytest.mark.parametrize("name", ["world2", "asym", "world3",
                                  "chunk_mismatch"])
def test_lost_segment_comes_back_from_the_ring(runs, name):
    """The lost rank's segment and backup are gone; rotating the backups
    back by one writes every rank's own bytes into its segment."""
    _, world, _, _, _, lost = next(c for c in RING_CASES if c[0] == name)
    recs = _case(runs, name)
    assert recs[lost]["dropped"] is True
    for rank, rec in enumerate(recs):
        # the lost rank's predecessor receives from the lost rank, which
        # kept no backup; every other rank gets its own bytes back
        assert rec["restored"] is ((rank + 1) % world != lost), (name, rank)
        assert rec["restore_equal"] is True, (name, rank)


def test_chunk_set_differently_takes_the_smallest(runs):
    """Chunks of 4096, 1000 and 8192 bytes: every rank agrees on 1000 and
    runs the same 30 rounds (no deadlock), the restore too."""
    for rec in _case(runs, "chunk_mismatch"):
        assert rec["exchange"]["chunk"] == 1000
        assert rec["exchange"]["rounds"] == 30
        assert rec["restore_exchange"]["chunk"] == 1000


def test_torn_segment_contributes_nothing(runs):
    """Rank 1's segment is torn (odd generation): rank 2 keeps no backup
    of it, the other backups land, and the restore still runs on every
    rank (rank 1 receives rank 2's empty contribution, rank 2 its own
    bytes from rank 0)."""
    recs = _case(runs, "torn")
    assert recs[1]["exchange"]["sent"] == 0
    assert recs[2]["backup_equal"] is None
    assert recs[0]["backup_equal"] is True
    assert recs[1]["backup_equal"] is True
    assert [r["restored"] for r in recs] == [True, False, True]
    assert all(r["restore_equal"] for r in recs)


def test_lost_rank_restores_from_its_successors_backup(runs):
    """dp=2, ``replica=True``: the memory save ran the exchange (the async
    save took the sync path); rank 1 lost its segment and backup; every
    rank restored the saved step ``torch.equal``, rank 1 through the
    replica, and the next step is bitwise the uninterrupted one."""
    for rank, run in enumerate(runs["engine"]):
        rec = run["lost"]
        assert rec["lost"] is (rank == 1)
        assert rec["save_paths"] == [(STEPS, "sync")]
        assert rec["exchange"]["sent"] > 0
        assert rec["exchange"]["received"] == rec["exchange"]["sent"]
        assert rec["restored_step"] == STEPS
        assert rec["equal"] is True
        assert rec["restored"]["loss"] == rec["next"]["loss"]
        assert rec["restored"]["grad_norm"] == rec["next"]["grad_norm"]
        assert rec["recovery"] == {}


def test_replica_run_matches_the_jax_trainer(runs):
    """The 2 steps before the save and the step after the restore are the
    JAX Trainer's 3 uninterrupted steps on dp=2."""
    want = runs["jax_loss"]
    for rec in runs["engine"]:
        np.testing.assert_allclose(rec["loss"], want[:STEPS],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(rec["lost"]["restored"]["loss"],
                                   want[STEPS:], rtol=LOSS_RTOL)


def test_replica_in_one_process_is_a_no_op(tmp_path):
    """As the reference's engine: no manager, no backup segment, and the
    async save keeps its own path."""
    scope = f"r1{uuid.uuid4().hex[:8]}"
    state = {"w": torch.arange(8, dtype=torch.float32), "step": 3}
    ckpt = Checkpointer(str(tmp_path), scope=scope, replica=True,
                        device="cpu")
    try:
        assert ckpt.engine.replica is None
        ckpt.save_checkpoint(3, state, StorageType.MEMORY, layout={})
        assert ckpt.wait_latest_checkpoint(timeout=60)
        name = ckpt.engine._shm.name
        assert not SharedMemoryBuffer(name + BACKUP_SHM_SUFFIX).attach()
        restored, step = ckpt.load_checkpoint(
            {"w": torch.zeros(8), "step": 0}, layout={})
        assert step == 3 and torch.equal(restored["w"], state["w"])
        assert restored["step"] == 3
    finally:
        ckpt.engine.unlink_memory()
        ckpt.close()
