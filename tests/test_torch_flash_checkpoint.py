"""The port's flash checkpoint (dlrover_tpu_torch/trainer/flash_checkpoint,
agent/ckpt_saver.py) against the JAX package's
(dlrover_tpu/trainer/flash_checkpoint, dlrover_tpu/agent/ckpt_saver.py).

- The shm format: the same seeded leaves through both packages' writers
  give byte-identical segments, each package's readers reassemble the
  other's segment bit-identically, and both refuse an odd generation.
- The persisted files: one committed segment persisted and committed by
  both savers gives equal file trees.
- The slice: a tiny Llama from the same weights trains, saves, restores
  from shm and from storage and trains on in both packages; the port's
  losses match the JAX run's, and its resumed run is ``torch.equal`` to
  its uninterrupted run.
- The async save's in-place hazard, the reference's engine behaviours, the
  refused paths, and one test on the card (skips without one).

Every shm name carries a per-test scope, and every test unlinks its
segments.  The JAX package is imported by the ``ref`` fixture only: the
card's machine has no JAX, and there the port-only tests and the ``cuda``
test run (``python -m pytest --noconftest -m cuda``).
"""

import importlib
import os
import struct
import threading
import time
import uuid
from types import SimpleNamespace

import numpy as np
import pytest

import torch

from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
from dlrover_tpu_torch.common.multi_process import SharedMemoryBuffer
from dlrover_tpu_torch.common.pytree import flatten_with_path, map_with_path
from dlrover_tpu_torch.models.convert import flax_llama_to_state_dict
from dlrover_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from dlrover_tpu_torch.trainer import optim as toptim
from dlrover_tpu_torch.trainer.flash_checkpoint import (
    Checkpointer,
    StorageType,
    snapshot,
)
from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
    _DeviceCopy,
    _SnapshotStager,
    read_tracker,
)
from dlrover_tpu_torch.trainer.train import Trainer

B, S = 4, 32
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=100)
# the port's loss against the JAX Trainer's on the same weights and batch:
# the bf16-moment optimizer's cases of tests/test_torch_train.py CASES
# (fp32 compute: 1e-5; bf16 compute with bf16 grads: 2e-3)
LOSS_RTOL = {"fp32": 1e-5, "bf16_grads": 2e-3}
# (compute dtype, grads dtype) of each case: jnp names on the JAX side
DTYPES = {"fp32": (("float32", None), (torch.float32, None)),
          "bf16_grads": (("bfloat16", "bfloat16"),
                         (torch.bfloat16, torch.bfloat16))}


@pytest.fixture
def ref():
    """The JAX package's side of the comparisons."""
    jax = pytest.importorskip("jax")
    mod = importlib.import_module
    ns = SimpleNamespace(
        jax=jax, jnp=mod("jax.numpy"), nn=mod("flax.linen"),
        ml_dtypes=mod("ml_dtypes"),
        snapshot=mod("dlrover_tpu.trainer.flash_checkpoint.snapshot"),
        Shm=mod("dlrover_tpu.common.multi_process").SharedMemoryBuffer,
        Saver=mod("dlrover_tpu.agent.ckpt_saver").AsyncCheckpointSaver,
        llama=mod("dlrover_tpu.models.llama"),
        mesh=mod("dlrover_tpu.parallel.mesh"),
        optim=mod("dlrover_tpu.trainer.optim"),
        flash=mod("dlrover_tpu.trainer.flash_checkpoint"),
        Trainer=mod("dlrover_tpu.trainer.train").Trainer,
    )
    return ns


def _scope():
    return f"t{uuid.uuid4().hex[:8]}"


@pytest.fixture
def async_always(monkeypatch):
    """Small states take the async path too."""
    monkeypatch.setenv("DLROVER_TPU_ASYNC_MIN_BYTES", "0")


@pytest.fixture
def hooks():
    yield
    snapshot.set_stream_fault(None)
    snapshot.set_copy_observer(None)


def _batch(seed=0):
    ids = np.random.default_rng(seed).integers(0, 256, size=(B, S + 1))
    return {"input_ids": ids[:, :-1].astype(np.int32),
            "labels": ids[:, 1:].astype(np.int32)}


def _trainer(dtype=torch.float32, grads_dtype=None, state_dict=None):
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=dtype), device="cpu")
    if state_dict is not None:
        model.load_state_dict(state_dict)
    trainer = Trainer(
        model, toptim.create_optimizer(moment_dtype=torch.bfloat16, **OPT),
        grads_dtype=grads_dtype, device="cpu")
    return trainer, trainer.create_state()


def _snapshot_of(state):
    return {path: (leaf.clone() if isinstance(leaf, torch.Tensor) else leaf)
            for path, leaf in flatten_with_path(state)}


def _assert_state_equal(state, want):
    got = dict(flatten_with_path(state))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        if isinstance(leaf, torch.Tensor):
            assert leaf.dtype == want[path].dtype, path
            assert torch.equal(leaf, want[path]), path
        else:
            assert leaf == want[path], path


def _assert_state_differs(state, other):
    assert any(not torch.equal(leaf, other[path])
               for path, leaf in flatten_with_path(state)
               if isinstance(leaf, torch.Tensor))


# -- the shm format, byte for byte ---------------------------------------------


def _np_leaves(ref):
    """Seeded leaves: fp32, bf16, int32 and a 0-d scalar."""
    rng = np.random.default_rng(7)
    return {
        "params/w": rng.standard_normal((5, 7)).astype(np.float32),
        "opt_state/mu/w": rng.standard_normal((5, 7)).astype(
            ref.ml_dtypes.bfloat16),
        "tokens": rng.integers(-9, 9, (3, 4)).astype(np.int32),
        "step": np.asarray(np.int64(12)),
    }


EXTRAS = {"data_shard": 3, "note": "seeded"}


def _jax_leaf_list(arrays):
    return [{"path": path, "dtype": str(a.dtype),
             "gshape": list(a.shape),
             "shards": [{"index": [[0, d] for d in a.shape], "data": a}]}
            for path, a in arrays.items()]


def _torch_of(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _port_leaf_list(arrays):
    return [{"path": path, "dtype": snapshot.dtype_name(t.dtype),
             "gshape": list(t.shape),
             "shards": [{"index": [[0, d] for d in t.shape], "data": t}]}
            for path, t in ((p, _torch_of(a)) for p, a in arrays.items())]


def _bits(x) -> np.ndarray:
    """The raw bits of a leaf from either package, as numpy."""
    if isinstance(x, torch.Tensor):
        return snapshot.byte_view(x).numpy()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


@pytest.fixture
def segments(ref):
    """A port segment and a reference segment for one test, unlinked at
    the end."""
    scope = _scope()
    port = SharedMemoryBuffer(f"fmt_port_{scope}")
    ref_shm = ref.Shm(f"fmt_ref_{scope}")
    yield port, ref_shm
    port.unlink()
    ref_shm.unlink()
    for name in (port.name, ref_shm.name):
        assert not SharedMemoryBuffer(name).attach()


def _write_port(path, shm, step, arrays, extras):
    leaves = _port_leaf_list(arrays)
    if path == "write":
        return snapshot.write_snapshot(shm, step, leaves, extras)
    return snapshot.stream_snapshot(shm, step, leaves, extras,
                                    chunk_bytes=16)


@pytest.mark.parametrize("path", ["write", "stream"])
def test_segment_is_byte_identical_to_the_reference(ref, segments, path):
    port, ref_shm = segments
    arrays = _np_leaves(ref)
    total = _write_port(path, port, 12, arrays, EXTRAS)
    assert ref.snapshot.write_snapshot(ref_shm, 12, _jax_leaf_list(arrays),
                                       EXTRAS) == total
    assert bytes(port.buf[:total]) == bytes(ref_shm.buf[:total])


def test_each_reader_reads_the_other_package(ref, segments):
    port, ref_shm = segments
    arrays = _np_leaves(ref)
    _write_port("write", port, 5, arrays, EXTRAS)
    ref.snapshot.write_snapshot(ref_shm, 5, _jax_leaf_list(arrays), EXTRAS)
    cases = [
        # (reader module, reader-side attach of the segment the OTHER
        # package wrote)
        (ref.snapshot, ref.Shm(port.name)),
        (snapshot, SharedMemoryBuffer(ref_shm.name)),
    ]
    try:
        for reader, shm in cases:
            meta = reader.read_snapshot_meta(shm)
            assert meta["step"] == 5 and meta["extras"] == EXTRAS
            assert [leaf["path"] for leaf in meta["leaves"]] == list(arrays)
            for leaf in meta["leaves"]:
                (shard,) = leaf["shards"]
                got = reader.read_shard_bytes(shm, meta, shard, leaf["dtype"])
                want = arrays[leaf["path"]]
                assert list(got.shape) == (list(want.shape) or [1])
                assert np.array_equal(_bits(got), _bits(want)), leaf["path"]
        # an odd generation is refused by both readers, on both segments
        for shm in (port, ref_shm):
            (gen,) = struct.unpack(">Q", bytes(shm.buf[8:16]))
            shm.buf[8:16] = struct.pack(">Q", gen + 1)
        for reader, shm in cases + [(ref.snapshot, ref_shm),
                                    (snapshot, port)]:
            assert reader.read_snapshot_meta(shm) is None
            assert reader.is_torn(shm)
    finally:
        for _, shm in cases:
            shm.close()


def test_streaming_makes_one_host_copy_per_chunk(hooks):
    port = SharedMemoryBuffer(f"chunks_{_scope()}")
    counts = {"chunk": 0, "host_copy": 0}

    def observe(event, nbytes):
        counts[event] += 1

    snapshot.set_copy_observer(observe)
    # a 3.2 MB leaf streams in 1 MiB chunks; leaves of at most 2 MiB go
    # as one chunk each
    arrays = {"small": np.arange(12, dtype=np.int32),
              "step": np.asarray(np.int64(3)),
              "big": np.ones((800, 1000), np.float32)}
    try:
        snapshot.stream_snapshot(port, 1, _port_leaf_list(arrays),
                                 chunk_bytes=1 << 20)
    finally:
        port.unlink()
    assert counts["chunk"] == 2 + 4
    assert counts["host_copy"] == counts["chunk"]


# -- the persisted files -------------------------------------------------------

# fields of the persisted files that hold a time or a uuid, where the two
# savers may differ: the meta, the tracker and the done-files hold none
VOLATILE_FIELDS = ()


def _file_tree(root):
    tree = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                tree[os.path.relpath(path, root)] = f.read()
    return tree


def test_persisted_files_equal_the_references(ref, tmp_path, segments,
                                              monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_PERSIST_CHUNK_BYTES", str(1 << 20))
    port, _ = segments
    rng = np.random.default_rng(3)
    arrays = dict(_np_leaves(ref),
                  big=rng.standard_normal((700, 1000)).astype(np.float32))
    _write_port("write", port, 9, arrays, EXTRAS)
    ref_shm = ref.Shm(port.name)
    savers = [ref.Saver(scope=_scope()), AsyncCheckpointSaver(scope=_scope())]
    try:
        for saver, shm, out in ((savers[0], ref_shm, tmp_path / "ref"),
                                (savers[1], port, tmp_path / "port")):
            meta = ref.snapshot.read_snapshot_meta(ref_shm)
            saver._persist_snapshot(shm, meta, str(out), 0)
            saver._commit(str(out), 9, 0, 1)
    finally:
        ref_shm.close()
        savers[0]._queue.close()
        savers[0]._progress.close()
        savers[1].stop()
        savers[1]._queue.close()
    ref_tree, port_tree = (_file_tree(tmp_path / "ref"),
                           _file_tree(tmp_path / "port"))
    assert sorted(port_tree) == sorted(ref_tree) == [
        "9/.done/0", "9/meta_0.json", "9/shards_0.bin",
        "latest_checkpointed_iteration.txt"]
    assert not VOLATILE_FIELDS
    for name in ref_tree:
        assert port_tree[name] == ref_tree[name], name
    assert read_tracker(str(tmp_path / "port")) == 9


# -- the slice against the JAX package ----------------------------------------


def _jax_run(ref, dtypes, ckpt_dir):
    """The JAX Trainer: 4 steps uninterrupted; then from the same start 2
    steps, a storage save, one more step, a restore from shm and 2 steps;
    a restore from storage (fresh scope) and 2 steps.  Returns the initial
    params and the three loss lists."""
    jax, jnp = ref.jax, ref.jnp
    dtype, grads_dtype = (None if d is None else getattr(jnp, d)
                          for d in dtypes)
    mesh = ref.mesh.build_mesh(ref.mesh.MeshConfig(dp=1),
                               devices=jax.devices()[:1])
    trainer = ref.Trainer(
        ref.llama.LlamaForCausalLM(ref.llama.LlamaConfig.tiny(dtype=dtype)),
        ref.optim.create_optimizer(moment_dtype=jnp.bfloat16, **OPT),
        mesh, grads_dtype=grads_dtype)
    batch = _batch()

    def fresh():
        return trainer.create_state(jax.random.PRNGKey(0),
                                    batch["input_ids"])

    def steps(state, n):
        losses = []
        for _ in range(n):
            state, metrics = trainer.train_step(state, batch)
            losses.append(float(metrics["loss"]))
        return state, losses

    state = fresh()
    init = jax.tree.map(np.asarray, ref.nn.meta.unbox(state.params))
    _, straight = steps(state, 4)
    state, _ = steps(fresh(), 2)
    abstract = jax.eval_shape(lambda s: s, state)
    scopes = [_scope(), _scope()]
    ckpt = ref.flash.Checkpointer(ckpt_dir, scope=scopes[0],
                                  async_snapshot=False)
    try:
        ckpt.save_checkpoint(2, state, ref.flash.StorageType.DISK)
        assert ckpt.wait_latest_checkpoint(timeout=60)
        steps(state, 1)
        restored, step = ckpt.load_checkpoint(abstract,
                                              trainer.state_shardings)
        assert step == 2
        _, from_shm = steps(restored, 2)
        ckpt2 = ref.flash.Checkpointer(ckpt_dir, scope=scopes[1])
        try:
            restored, step = ckpt2.load_checkpoint(abstract,
                                                   trainer.state_shardings)
            assert step == 2
            _, from_storage = steps(restored, 2)
        finally:
            ckpt2.close()
    finally:
        ckpt.engine.unlink_memory()
        ckpt.close()
    return init, straight, from_shm, from_storage


def _port_run(dtypes, state_dict, ckpt_dir):
    """The same sequence on the port: restores fill the live state in
    place.  Returns the three loss lists, the final states' snapshots and
    the engine's save paths."""
    trainer, state = _trainer(*dtypes, state_dict=state_dict)
    batch = _batch()

    def steps(state, n):
        losses = []
        for _ in range(n):
            state, metrics = trainer.train_step(state, batch)
            losses.append(metrics["loss"].item())
        return state, losses

    state, straight = steps(state, 4)
    final_straight = _snapshot_of(state)
    trainer, state = _trainer(*dtypes, state_dict=state_dict)
    state, _ = steps(state, 2)
    scopes = [_scope(), _scope()]
    ckpt = Checkpointer(ckpt_dir, scope=scopes[0], device="cpu")
    try:
        ckpt.save_checkpoint(2, state, StorageType.DISK)
        assert ckpt.wait_latest_checkpoint(timeout=60)
        state, _ = steps(state, 1)
        state, step = ckpt.load_checkpoint(state, trainer=trainer)
        assert step == 2
        state, from_shm = steps(state, 2)
        final_shm = _snapshot_of(state)
        ckpt2 = Checkpointer(ckpt_dir, scope=scopes[1], device="cpu")
        try:
            # no trainer passed: train_step refreshes the compute copy of
            # a state it did not produce
            state, step = ckpt2.load_checkpoint(state)
            assert step == 2
            state, from_storage = steps(state, 2)
        finally:
            ckpt2.close()
        paths = list(ckpt.engine.save_paths)
    finally:
        ckpt.engine.unlink_memory()
        ckpt.close()
    return (straight, from_shm, from_storage, final_straight, final_shm,
            _snapshot_of(state), paths)


@pytest.mark.parametrize("case", list(DTYPES))
def test_save_restore_continue_matches_jax_and_is_exact(ref, tmp_path,
                                                        case):
    jdt, tdt = DTYPES[case]
    init, j_straight, j_shm, j_storage = _jax_run(ref, jdt,
                                                  str(tmp_path / "jax"))
    (straight, from_shm, from_storage, final_straight, final_shm,
     final_storage, paths) = _port_run(
        tdt, flax_llama_to_state_dict(init, LlamaConfig.tiny(dtype=tdt[0])),
        str(tmp_path / "port"))
    assert paths == [(2, "sync")]  # a tiny state saves synchronously
    # against the JAX package: every loss within the case's tolerance
    for got, want in ((straight, j_straight), (from_shm, j_shm),
                      (from_storage, j_storage)):
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL[case])
    # against its own uninterrupted run: exact, loss by loss and leaf by
    # leaf (the resumed runs trained steps 3 and 4 from the step-2 state)
    assert from_shm == straight[2:] and from_storage == straight[2:]
    _assert_state_equal_dicts(final_shm, final_straight)
    _assert_state_equal_dicts(final_storage, final_straight)


def _assert_state_equal_dicts(got, want):
    assert got.keys() == want.keys()
    for path in got:
        if isinstance(got[path], torch.Tensor):
            assert torch.equal(got[path], want[path]), path
        else:
            assert got[path] == want[path], path


# -- the async save's in-place hazard ------------------------------------------


def test_async_snapshot_is_not_torn_by_the_next_step(tmp_path, async_always,
                                                     hooks):
    """train_step mutates the masters and moments in place: the async
    save must stage a copy, so a step trained while the stager is held
    must not leak into the snapshot."""
    trainer, state = _trainer()
    batch = _batch()
    state, _ = trainer.train_step(state, batch)
    gate, first_chunk = threading.Event(), threading.Event()

    def hold(chunk):
        first_chunk.set()
        assert gate.wait(30)

    snapshot.set_stream_fault(hold)
    ckpt = Checkpointer(str(tmp_path), scope=_scope(), device="cpu")
    try:
        before = _snapshot_of(state)
        ckpt.save_checkpoint(1, state, StorageType.MEMORY)
        assert first_chunk.wait(30)  # the stager is mid-stream, held
        state, _ = trainer.train_step(state, batch)
        after = _snapshot_of(state)
        gate.set()
        assert ckpt.engine._flush_async(30)
        assert list(ckpt.engine.save_paths) == [(1, "async")]
        state, step = ckpt.load_checkpoint(state, trainer=trainer)
        assert step == 1
        _assert_state_equal(state, before)
        _assert_state_differs(state, after)
    finally:
        gate.set()
        ckpt.engine.unlink_memory()
        ckpt.close()


def test_async_copies_land_in_one_reused_buffer(tmp_path, async_always):
    """The device copy of an async save goes into one buffer the engine
    allocates once and reuses: at most one extra copy of the state."""
    trainer, state = _trainer()
    ckpt = Checkpointer(str(tmp_path), scope=_scope(), device="cpu")
    try:
        ckpt.save_checkpoint(1, state, StorageType.MEMORY)
        assert ckpt.engine._flush_async(30)
        buf = ckpt.engine._copy_buf
        tensors = [leaf for _, leaf in flatten_with_path(state)
                   if isinstance(leaf, torch.Tensor)]
        assert buf is not None and buf.numel() >= sum(
            t.numel() * t.element_size() for t in tensors)
        state, _ = trainer.train_step(state, _batch())
        ckpt.save_checkpoint(2, state, StorageType.MEMORY)
        assert ckpt.engine._flush_async(30)
        assert ckpt.engine._copy_buf.data_ptr() == buf.data_ptr()
        assert list(ckpt.engine.save_paths) == [(1, "async"), (2, "async")]
    finally:
        ckpt.engine.unlink_memory()
        ckpt.close()


# -- the reference's behaviours ------------------------------------------------


@pytest.mark.parametrize("staging", ["stream", "two_phase"])
def test_latest_async_save_wins(tmp_path, async_always, monkeypatch,
                                staging):
    """Back-to-back async memory saves (reference test :249): the newest
    step is the one a restore sees, with the streaming stager and with the
    two-phase one (DLROVER_TPU_STREAM_STAGING=0)."""
    monkeypatch.setenv("DLROVER_TPU_STREAM_STAGING",
                       "1" if staging == "stream" else "0")
    trainer, state = _trainer()
    batch = _batch()
    ckpt = Checkpointer(str(tmp_path), scope=_scope(), device="cpu")
    try:
        for step in range(1, 5):
            ckpt.save_checkpoint(step, state, StorageType.MEMORY)
            want = _snapshot_of(state)
            state, _ = trainer.train_step(state, batch)
        state, step = ckpt.load_checkpoint(state, trainer=trainer)
        assert step == 4
        _assert_state_equal(state, want)
    finally:
        ckpt.engine.unlink_memory()
        ckpt.close()


def _box(freed=None):
    sink = freed if freed is not None else []
    return _DeviceCopy(object(), lambda: sink.append(True))


def test_second_storage_save_waits_not_displaces():
    """Reference test :365: while a storage item is QUEUED, a second
    storage submit waits for it to be taken rather than displacing it."""
    gate, staged = threading.Event(), []

    def stage(step, box, extras, persist):
        gate.wait(10)
        staged.append(step)

    s = _SnapshotStager(stage)
    s.submit(0, _box(), None, False)  # in flight, blocked on the gate
    deadline = time.time() + 5
    while not s._busy:
        assert time.time() < deadline
        time.sleep(0.01)
    s.submit(1, _box(), None, True)  # queued
    assert s.submit(2, _box(), None, False) == "busy"  # memory: deferred
    done = []
    t = threading.Thread(target=lambda: done.append(
        s.submit(3, _box(), None, True)))
    t.start()
    time.sleep(0.3)
    assert not done
    assert s._pending is not None and s._pending[0] == 1
    gate.set()
    t.join(10)
    assert not t.is_alive() and done == [True]
    assert s.flush(10)
    assert staged == [0, 1, 3]
    assert s.stop()


def test_interrupted_write_reads_as_no_snapshot():
    """Reference test :464: until the final header commit the shm reads
    as empty."""
    port = SharedMemoryBuffer(f"torn_{_scope()}")
    try:
        _write_port("write", port, 3, {"w": np.arange(4, dtype=np.float32)},
                    None)
        assert snapshot.read_snapshot_meta(port)["step"] == 3
        port.buf[0:snapshot._HEADER] = struct.pack(">Q", 0)
        assert snapshot.read_snapshot_meta(port) is None
    finally:
        port.unlink()


def test_torn_shm_restores_from_disk(tmp_path, hooks):
    """Reference test :496: a stream torn mid-write (a fault on its third
    chunk) leaves an odd generation; the restore takes the older storage
    step bit-exactly."""
    trainer, state = _trainer()
    batch = _batch()
    state, _ = trainer.train_step(state, batch)
    ckpt = Checkpointer(str(tmp_path), scope=_scope(), async_snapshot=False,
                        device="cpu")
    try:
        ckpt.save_checkpoint(4, state, StorageType.DISK)
        assert ckpt.wait_latest_checkpoint(timeout=60)
        want = _snapshot_of(state)
        state, _ = trainer.train_step(state, batch)

        def fault(chunk):
            if chunk == 2:
                raise RuntimeError("injected: writer killed mid-stream")

        snapshot.set_stream_fault(fault)
        with pytest.raises(RuntimeError, match="injected"):
            snapshot.stream_snapshot(ckpt.engine._shm, 8,
                                     snapshot.plan_shards(state),
                                     chunk_bytes=1 << 12)
        snapshot.set_stream_fault(None)
        assert snapshot.is_torn(ckpt.engine._shm)
        state, step = ckpt.load_checkpoint(state, trainer=trainer)
        assert step == 4
        _assert_state_equal(state, want)
    finally:
        ckpt.engine.unlink_memory()
        ckpt.close()


def test_bf16_snapshot_casts_up_and_default_stays_exact(tmp_path,
                                                       async_always,
                                                       monkeypatch):
    """Reference tests :545 and :591: DLROVER_TPU_SNAPSHOT_DTYPE=bf16
    stores fp32 leaves as bf16 and restores them at the state's dtypes,
    bf16-close; the default is exact."""
    trainer, state = _trainer()
    state, _ = trainer.train_step(state, _batch())
    want = _snapshot_of(state)
    for policy in ("bf16", ""):
        monkeypatch.setenv("DLROVER_TPU_SNAPSHOT_DTYPE", policy)
        ckpt = Checkpointer(str(tmp_path), scope=_scope(), device="cpu")
        try:
            ckpt.save_checkpoint(3, state, StorageType.MEMORY)
            assert ckpt.engine._flush_async(timeout=60)
            stored = {leaf["path"]: leaf["dtype"] for leaf in
                      snapshot.read_snapshot_meta(ckpt.engine._shm)["leaves"]}
            fp32 = [p for p, t in want.items()
                    if isinstance(t, torch.Tensor) and t.dtype ==
                    torch.float32]
            assert fp32
            _, target = _trainer()  # a state of the same structure
            restored, step = ckpt.load_checkpoint(target)
            assert step == 3
        finally:
            ckpt.engine.unlink_memory()
            ckpt.close()
        if policy == "bf16":
            assert all(stored[p] == "bfloat16" for p in fp32)
            for path, leaf in flatten_with_path(restored):
                if isinstance(leaf, torch.Tensor):
                    assert leaf.dtype == want[path].dtype
                    torch.testing.assert_close(leaf.float(),
                                               want[path].float(),
                                               rtol=1e-2, atol=1e-2)
            _assert_state_differs(restored, want)  # not bit-exact
        else:
            assert all(stored[p] == "float32" for p in fp32)
            _assert_state_equal(restored, want)


def test_bf16_moments_round_trip(tmp_path):
    """Reference test :610: the bf16 Adam moments ride shm and storage as
    bf16 bits."""
    trainer, state = _trainer()
    state, _ = trainer.train_step(state, _batch())
    moments = [leaf for path, leaf in flatten_with_path(state.opt_state)
               if isinstance(leaf, torch.Tensor)]
    assert moments and all(m.dtype == torch.bfloat16 for m in moments)
    want = _snapshot_of(state)
    ckpt = Checkpointer(str(tmp_path), scope=_scope(), device="cpu")
    try:
        ckpt.save_checkpoint(1, state, StorageType.DISK)
        assert ckpt.wait_latest_checkpoint(timeout=60)
        stored = {leaf["path"]: leaf["dtype"] for leaf in
                  snapshot.read_snapshot_meta(ckpt.engine._shm)["leaves"]}
        assert stored["opt_state/1/mu/embed_tokens"] == "bfloat16"
        fresh_trainer, fresh = _trainer()
        ckpt2 = Checkpointer(str(tmp_path), scope=_scope(), device="cpu")
        try:
            restored, step = ckpt2.load_checkpoint(fresh,
                                                   trainer=fresh_trainer)
        finally:
            ckpt2.close()
        assert step == 1
        _assert_state_equal(restored, want)
    finally:
        ckpt.engine.unlink_memory()
        ckpt.close()


def test_no_checkpoint_returns_none(tmp_path):
    """Reference test :163."""
    _, state = _trainer()
    before = _snapshot_of(state)
    ckpt = Checkpointer(str(tmp_path), scope=_scope(), device="cpu")
    try:
        assert ckpt.load_checkpoint(state) == (None, -1)
        assert ckpt.latest_step() == -1
    finally:
        ckpt.close()
    _assert_state_equal(state, before)  # untouched


# (Checkpointer kwargs, env, the error and its message): the paths not
# ported yet name their ROADMAP items; two processes with no
# torch.distributed world have nothing to agree on a restore step over
REFUSED = {
    "url_path": (dict(checkpoint_dir="gs://bucket/ckpt"), {},
                 NotImplementedError, "ROADMAP queue 1 item"),
    "two_processes": (dict(num_processes=2), {}, ValueError,
                      "no torch.distributed world"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_paths_out_of_scope_raise(tmp_path, monkeypatch, name):
    kwargs, env, error, match = REFUSED[name]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    kwargs = dict(dict(checkpoint_dir=str(tmp_path), scope=_scope(),
                       device="cpu"), **kwargs)
    with pytest.raises(error, match=match):
        Checkpointer(**kwargs)


def test_stager_failure_is_raised_to_the_trainer(tmp_path, async_always,
                                                 hooks):
    """A failing stager is not swallowed: the next save raises it, and so
    does the exit barrier."""
    trainer, state = _trainer()

    def fault(chunk):
        raise RuntimeError("injected stager fault")

    ckpt = Checkpointer(str(tmp_path), scope=_scope(), device="cpu")
    try:
        snapshot.set_stream_fault(fault)
        ckpt.save_checkpoint(1, state, StorageType.DISK)
        assert ckpt.engine._flush_async(30)
        with pytest.raises(RuntimeError, match="staging failed"):
            ckpt.save_checkpoint(2, state, StorageType.MEMORY)
        ckpt.save_checkpoint(3, state, StorageType.DISK)
        assert ckpt.engine._flush_async(30)
        with pytest.raises(RuntimeError, match="staging failed"):
            ckpt.wait_latest_checkpoint(timeout=30)
    finally:
        snapshot.set_stream_fault(None)
        ckpt.engine.unlink_memory()
        ckpt.close()


def test_persist_failure_is_raised_by_the_exit_barrier(tmp_path,
                                                       monkeypatch):
    trainer, state = _trainer()

    def broken(self, *args):
        raise OSError("injected: disk full")

    monkeypatch.setattr(AsyncCheckpointSaver, "_persist_snapshot", broken)
    ckpt = Checkpointer(str(tmp_path), scope=_scope(), async_snapshot=False,
                        device="cpu")
    try:
        ckpt.save_checkpoint(1, state, StorageType.DISK)
        with pytest.raises(RuntimeError, match="persist failed"):
            ckpt.wait_latest_checkpoint(timeout=30)
        assert read_tracker(str(tmp_path)) is None
    finally:
        ckpt.engine.unlink_memory()
        ckpt.close()


def test_close_lets_an_in_flight_persist_commit(tmp_path, monkeypatch):
    """close() right after a storage save: the persist still running in
    the saver's pool commits, and releases the buffer lock it holds."""
    trainer, state = _trainer()
    real = AsyncCheckpointSaver._persist_snapshot
    started = threading.Event()

    def slow(self, *args):
        started.set()
        time.sleep(0.5)
        return real(self, *args)

    monkeypatch.setattr(AsyncCheckpointSaver, "_persist_snapshot", slow)
    ckpt = Checkpointer(str(tmp_path), scope=_scope(), async_snapshot=False,
                        device="cpu")
    try:
        ckpt.save_checkpoint(1, state, StorageType.DISK)
        assert started.wait(30)
        ckpt.close()
        saver = ckpt.engine._local_saver
        deadline = time.time() + 30
        while not saver.idle():
            assert time.time() < deadline
            time.sleep(0.05)
        assert saver.take_error() is None
        assert read_tracker(str(tmp_path)) == 1
    finally:
        ckpt.engine._lock.close()
        ckpt.engine.unlink_memory()


def test_shard_index_map_assembles_a_sharded_leaf():
    """A reference snapshot may hold a leaf in several shards (its mesh's
    shardings): the port's map assembles any slice from them."""
    full = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    m = snapshot.ShardIndexMap("float32", [4, 6])
    m.add([[0, 2], [0, 6]], full[:2].clone())
    assert not m.covers((slice(0, 4), slice(0, 6)))
    assert m.whole() is None
    m.add_lazy([[2, 4], [0, 6]], lambda: full[2:].clone())
    assert m.covers((slice(0, 4), slice(0, 6)))
    assert torch.equal(m.read((slice(0, 4), slice(0, 6))), full)
    assert torch.equal(m.read((slice(1, 3), slice(2, 5))), full[1:3, 2:5])
    whole = snapshot.ShardIndexMap("float32", [4, 6])
    whole.add([[0, 4], [0, 6]], full.reshape(-1))
    assert torch.equal(whole.whole(), full)


def test_pytree_paths_and_rebuild():
    _, state = _trainer()
    paths = [p for p, _ in flatten_with_path(state)]
    assert paths[:2] == ["step", "params/embed_tokens"]
    assert "opt_state/1/count" in paths
    assert "opt_state/1/mu/layers.0.attn.q_proj.weight" in paths
    assert "opt_state/3/count" in paths
    assert not any(p.startswith("ef_residual") for p in paths)  # None
    rebuilt = map_with_path(
        lambda path, leaf: leaf + 1 if isinstance(leaf, int) else leaf,
        state)
    assert type(rebuilt) is type(state) and rebuilt.step == 1
    assert rebuilt.params["embed_tokens"] is state.params["embed_tokens"]
    assert type(rebuilt.opt_state[1]) is type(state.opt_state[1])


# -- devices -------------------------------------------------------------------


def test_default_device_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Checkpointer(str(tmp_path), scope=_scope())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the async save's device copy and "
                    "side-stream staging run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_async_save_step_restore_on_card(tmp_path, cuda_device,
                                         async_always):
    """On the card: an async storage save, a step trained while it
    stages, the exit barrier, then restores from shm and from storage into
    the live state, each equal to the state at the save."""
    # the flash kernels take head_dim 64 or 128
    model = LlamaForCausalLM(LlamaConfig.tiny(
        attention_impl="flash", hidden_size=256, head_dim=64),
        device=cuda_device)
    trainer = Trainer(model, toptim.create_optimizer(
        moment_dtype=torch.bfloat16, **OPT), grads_dtype=torch.bfloat16,
        device=cuda_device)
    state = trainer.create_state()
    batch = _batch()
    state, _ = trainer.train_step(state, batch)
    ckpt = Checkpointer(str(tmp_path), scope=_scope(), device=cuda_device)
    ckpt2 = None
    try:
        ckpt.save_checkpoint(1, state, StorageType.DISK)
        want = _snapshot_of(state)
        state, _ = trainer.train_step(state, batch)
        assert ckpt.wait_latest_checkpoint(timeout=120)
        assert list(ckpt.engine.save_paths) == [(1, "async")]
        # the copy went into the engine's buffer on the card
        assert ckpt.engine._copy_buf is not None
        assert ckpt.engine._copy_buf.is_cuda
        state, step = ckpt.load_checkpoint(state, trainer=trainer)
        assert step == 1
        _assert_state_equal(state, want)
        state, _ = trainer.train_step(state, batch)
        ckpt2 = Checkpointer(str(tmp_path), scope=_scope(),
                             device=cuda_device)
        state, step = ckpt2.load_checkpoint(state, trainer=trainer)
        assert step == 1
        _assert_state_equal(state, want)
        for n, p in model.named_parameters():
            assert torch.equal(p, state.params[n].to(p.dtype))
    finally:
        for c in (ckpt, ckpt2):
            if c is not None:
                c.engine.unlink_memory()
                c.close()
