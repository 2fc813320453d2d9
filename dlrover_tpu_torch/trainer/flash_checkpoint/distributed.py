"""Distributed persist: each shard written once by its owner, a step
committed in two phases, unchanged shards not rewritten, and restores that
read only the bytes they need.

Port of ``dlrover_tpu/trainer/flash_checkpoint/distributed.py``.  The
legacy persist (``agent/ckpt_saver.py``) writes every local shard of every
process and commits with done files, so a leaf whole on every rank is
written once per rank, and a crash between two ranks' writes can leave a
step committed on some and not on others.  Here:

* **Ownership** — the processes whose box of a leaf is the same box form
  its replica group; one member, ``group[crc32(path|box) % len(group)]``,
  writes it and the rest skip it.  Every process derives the same groups
  without communication: from every rank's layout (``layouts``, one
  ``snapshot.Layout`` per process; ``Trainer.state_layout(state, rank=r)``
  gives it), where the reference reads ``sharding.devices_indices_map``.  A
  leaf no layout names is whole on every process, and its group is every
  process.
* **Two-phase commit** — phase 1: each process writes its owned shards
  (``storage.write_chunks``) and reports a manifest of them (file, offset,
  bytes and CRC32 per shard) to the job's one ``CkptCommitCoordinator``
  (``master/ckpt_coordinator.py``).  Phase 2: the coordinator seals the
  step once the manifests' union covers every leaf, writing the union
  manifest and then the ``COMMITTED`` pointer, each atomically.  A crash
  before the seal leaves the previous step restorable.
* **Differential saves** — a per-shard CRC cache, seeded from the last
  committed manifest, lets an unchanged shard's record point at the file
  that last wrote it; the coordinator deletes shard files no kept manifest
  references (``DLROVER_TPU_DIST_MANIFEST_KEEP``).
* **Partial reads** — a restore reads only the stored shards its target
  boxes overlap (``storage.read_range``); with ``DLROVER_TPU_VERIFY_CRC=off``
  only the overlapping rows, otherwise whole shards so that their CRCs can
  be checked.

How a report reaches the coordinator: over a ``torch.distributed`` world of
more than one rank, ``StoreCommitClient`` carries reports and seal states
through the world's c10d store, with the coordinator in process 0 (the
port's stand-in for the reference's master RPC, which the port does not
have); in one process, ``LocalCommitClient``.  Reports and seal polls run
in the saver's thread and use no collective of the training group.

The storage layout is the reference's, so each package reads the other's
sealed commits wherever their leaf paths agree::

    <dir>/shards/s<step>_h<proc>.bin      phase-1 payloads (owned shards)
    <dir>/manifests/manifest_<step>.json  sealed union manifest (atomic)
    <dir>/COMMITTED                       latest sealed step (atomic)

The chaos point ``ckpt.phase1_report`` (a DROP is a host dying after its
shard bytes landed and before its report), the trace spans
``ckpt.phase1_report``, ``ckpt.dist_save`` and ``ckpt.dist_restore`` and
the ``ckpt_phase_seconds`` phases are the reference's.  ``get_commit_client``
finds the commit path as the reference's does: the master's RPC
(``MasterCommitClient`` over ``MasterClient.singleton_instance()``) when a
master is configured, as it is in every process the agent starts and in
the agent itself; else the world's store; else one process's own
coordinator.  A commit of several processes with no master and no world
has no coordinator that could seal it and raises
``NotImplementedError``.  Not ported: the object-store ranged reads
(item 7).  Leaves read back as torch tensors of the stored dtype (bf16
included), where the reference returns numpy arrays.
"""

import atexit
import json
import os
import threading
import time
import zlib
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np
import torch
import torch.distributed as tdist

from dlrover_tpu_torch import chaos
from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.pytree import map_with_path
from dlrover_tpu_torch.common.storage import (
    CheckpointStorage,
    get_checkpoint_storage,
)
from dlrover_tpu_torch.trainer.flash_checkpoint import snapshot
from dlrover_tpu_torch.trainer.flash_checkpoint.snapshot import Layout

SHARDS_DIR = "shards"
MANIFESTS_DIR = "manifests"
COMMITTED_FILE = "COMMITTED"
MANIFEST_FORMAT = 1


def shard_key(path: str, index: List[List[int]]) -> str:
    """Stable identity of one global shard: leaf path + index box."""
    spans = ";".join(f"{int(a)}:{int(b)}" for a, b in index)
    return f"{path}|{spans}"


def _norm_index(index, shape) -> List[List[int]]:
    out = []
    for dim, sl in enumerate(index):
        start = sl.start if sl.start is not None else 0
        stop = sl.stop if sl.stop is not None else shape[dim]
        out.append([int(start), int(stop)])
    return out


def manifest_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, MANIFESTS_DIR, f"manifest_{step}.json")


def committed_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, COMMITTED_FILE)


def shard_file(step: int, process_id: int) -> str:
    """Relative (to ckpt_dir) payload file for one host's phase-1 write."""
    return os.path.join(SHARDS_DIR, f"s{step}_h{process_id}.bin")


# ---------------------------------------------------------------------------
# Ownership planning.
# ---------------------------------------------------------------------------


def world() -> Tuple[int, int]:
    """``(rank, size)`` of ``torch.distributed``'s world; ``(0, 1)`` when
    none is initialised."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return 0, 1


def box_of(layout: Optional[Layout], path: str,
            gshape: Sequence[int]) -> List[List[int]]:
    """A process's box of a leaf: its layout's, else the whole leaf."""
    if layout and path in layout:
        return [[int(a), int(b)] for a, b in layout[path][1]]
    return [[0, int(d)] for d in gshape]


def plan_dist_shards(
    state: Any,
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
    layout: Optional[Layout] = None,
    layouts: Optional[Sequence[Layout]] = None,
) -> Tuple[List[Dict], int, int]:
    """Enumerate this process's shards with ownership annotations.

    Returns ``(leaves, process_id, num_processes)`` where each leaf is
    ``{path, dtype, gshape, shards}`` and each shard carries ``index``
    (its global box), ``key``, ``group`` (sorted process ids of the replica
    group) and ``owner``.  ``data`` stays the tensor where it lives.

    Enumeration is ``snapshot.plan_shards`` — the stager's own planner,
    so the writer cannot disagree with the shm layout about what a
    process's shards are; ``layout`` places this process's tensors
    (``layouts[process_id]`` when only ``layouts`` is given).  Replica
    groups come from ``layouts``, one per process: the processes whose box
    of the leaf equals this one's.  Without ``layouts`` a leaf ``layout``
    does not name is whole on every process (group: every process), and a
    leaf it names raises: its owner cannot be derived without the other
    processes' boxes.  As in the reference, when no world is initialised
    but the caller declares ``num_processes > 1`` (one independent process
    per host, each holding the whole state), every shard's group is every
    declared process — unless ``layouts`` say where each one's tensors
    sit (hosts simulated in one process, each with its own shards)."""
    _, world_size = world()
    replicated_hosts = bool(
        layouts is None and num_processes and num_processes > 1
        and world_size == 1
    )
    if num_processes is None:
        num_processes = world_size
    if process_id is None:
        process_id = 0 if replicated_hosts else world()[0]
    all_hosts = list(range(num_processes))
    if layouts is not None:
        if len(layouts) != num_processes:
            raise ValueError(f"{len(layouts)} layouts for {num_processes} "
                             "processes")
        if layout is None:
            layout = layouts[process_id]
    leaves = snapshot.plan_shards(state, layout)
    for leaf in leaves:
        path = leaf["path"]
        for shard in leaf["shards"]:
            key = shard_key(path, shard["index"])
            if replicated_hosts or num_processes == 1:
                group = all_hosts
            elif layouts is not None:
                group = [p for p in all_hosts
                         if box_of(layouts[p], path, leaf["gshape"])
                         == shard["index"]]
                if process_id not in group:
                    mine = box_of(layouts[process_id], path,
                                   leaf["gshape"])
                    raise ValueError(
                        f"leaf {path}: layouts[{process_id}] places this "
                        f"process at {mine}, its tensor sits at "
                        f"{shard['index']}")
            elif not (layout and path in layout):
                group = all_hosts  # whole on every process
            else:
                raise ValueError(
                    f"leaf {path} is split over the processes: its owner "
                    "needs every process's layout (layouts=, or the "
                    "Checkpointer's trainer=)")
            shard["key"] = key
            shard["group"] = group
            shard["owner"] = _owner_of(key, group)
    return leaves, int(process_id), int(num_processes)


def _owner_of(key: str, group: List[int]) -> int:
    """Deterministic replica-group member that writes this shard.
    Hashing spreads the write load across the group instead of piling
    every replicated leaf on the lowest rank."""
    return group[zlib.crc32(key.encode("utf-8")) % len(group)]


def owned_event_map(
    state: Any,
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
    layout: Optional[Layout] = None,
    layouts: Optional[Sequence[Layout]] = None,
) -> Dict[str, List[List[List[int]]]]:
    """{leaf_path: [owned shard index boxes]} — the compact ownership
    summary a flash-engine save event carries to the saver (which sees
    only the shm meta, never the layouts).  Ownership depends only on the
    layouts, so the map stays valid when the saver relabels the event to
    a newer shm step."""
    leaves, pid, _ = plan_dist_shards(state, process_id, num_processes,
                                      layout, layouts)
    owned: Dict[str, List[List[List[int]]]] = {}
    for leaf in leaves:
        boxes = [s["index"] for s in leaf["shards"] if s["owner"] == pid]
        owned[leaf["path"]] = boxes
    return owned


# ---------------------------------------------------------------------------
# Coverage math (shared with the coordinator).
# ---------------------------------------------------------------------------


def _box_volume(index: List[List[int]]) -> int:
    v = 1
    for a, b in index:
        v *= max(0, int(b) - int(a))
    return v if index else 1


def union_covers(leaf: Dict) -> bool:
    """True when the leaf's shard index boxes tile its full gshape.
    DISTINCT boxes of a partition never overlap, so the deduplicated
    volume sum equals the global volume iff coverage is full.  Identical
    boxes are counted ONCE: a save-on-failure without an ownership map
    persists every replica, and summing duplicates would let two copies of
    shard X "cover" for a missing shard Y — sealing a torn checkpoint."""
    need = 1
    for d in leaf.get("gshape", []):
        need *= int(d)
    got = 0
    seen = set()
    for s in leaf.get("shards", []):
        box = tuple(tuple(int(v) for v in span) for span in s["index"])
        if box in seen:
            continue
        seen.add(box)
        got += _box_volume(s["index"])
    return got >= need


# ---------------------------------------------------------------------------
# Phase-1 writer.
# ---------------------------------------------------------------------------


class HostShardWriter:
    """Persist one host's OWNED shards for a step and build its phase-1
    manifest.

    Differential: a per-shard CRC cache (seeded from the last committed
    manifest) lets unchanged shards reference the step file that last
    wrote them instead of re-writing — the manifest chains back.  Reuse
    is guarded by a file-size probe so a GC'd (never-sealed) or truncated
    file can never be referenced."""

    def __init__(
        self,
        ckpt_dir: str,
        process_id: int,
        num_processes: int,
        storage: Optional[CheckpointStorage] = None,
    ):
        self.ckpt_dir = ckpt_dir
        self.process_id = int(process_id)
        self.num_processes = int(num_processes)
        self.storage = storage or get_checkpoint_storage(path=ckpt_dir)
        # shard_key -> committed-or-written record {"file","offset",
        # "nbytes","crc32","shape","step"}
        self._cache: Dict[str, Dict] = {}
        self._seeded = False

    # -- differential cache -------------------------------------------

    def _seed_cache(self) -> None:
        """Prime the diff cache from the last committed manifest, so a
        restarted host resumes chaining instead of re-writing the world
        on its first save."""
        if self._seeded:
            return
        self._seeded = True
        step = read_committed_step(self.ckpt_dir, self.storage)
        if step < 0:
            return
        manifest = read_manifest(self.ckpt_dir, step, self.storage)
        if manifest is None:
            return
        for leaf in manifest.get("leaves", []):
            for rec in leaf.get("shards", []):
                key = shard_key(leaf["path"], rec["index"])
                self._cache[key] = {
                    "file": rec["file"],
                    "offset": int(rec["offset"]),
                    "nbytes": int(rec["nbytes"]),
                    "crc32": int(rec["crc32"]),
                    "shape": list(rec.get("shape", [])),
                    "step": int(rec.get("step", step)),
                }
        logger.info(
            "dist-ckpt proc %d: diff cache seeded from committed step %d "
            "(%d shard records)", self.process_id, step, len(self._cache),
        )

    # -- persist ------------------------------------------------------

    def persist(
        self,
        step: int,
        shard_iter: Iterable[Tuple[Dict, Dict, Optional[Callable[[], Any]]]],
        differential: Optional[bool] = None,
        extras: Optional[Dict] = None,
    ) -> Dict:
        """Write owned+changed shards, return this host's manifest.

        ``shard_iter`` yields ``(leaf_spec, shard, get_bytes)`` where
        ``leaf_spec`` is ``{path, dtype, gshape}``, ``shard`` carries
        ``index``/``key`` (and ``shape``), and ``get_bytes`` returns the
        shard's bytes (a buffer); ``get_bytes=None`` for a shard this host
        skips — it still rides the manifest's leaf spec so the coordinator
        learns the global tree."""
        if differential is None:
            differential = envs.get_bool("DLROVER_TPU_DIST_DIFF")
        self._seed_cache()
        t0 = time.monotonic()
        rel_bin = shard_file(step, self.process_id)
        abs_bin = os.path.join(self.ckpt_dir, rel_bin)
        leaves: Dict[str, Dict] = {}
        payload_parts: List[memoryview] = []
        offset = 0
        stats = {
            "shards_written": 0,
            "shards_reused": 0,
            "shards_skipped_replica": 0,
            "bytes_written": 0,
            "bytes_reused": 0,
        }
        file_size_cache: Dict[str, Optional[int]] = {}

        def _file_covers(rel: str, end: int) -> bool:
            # a reused record must point at bytes that actually exist:
            # a mere existence probe would chain to a TRUNCATED file (a
            # killed writer's leftover) and seal an unrestorable step
            if rel not in file_size_cache:
                file_size_cache[rel] = self.storage.size(
                    os.path.join(self.ckpt_dir, rel)
                )
            size = file_size_cache[rel]
            return size is not None and size >= end

        # cache updates are STAGED and applied only after write_chunks
        # succeeds: a failed/partial write must not leave records a
        # later save would chain to
        cache_updates: Dict[str, Dict] = {}
        for leaf_spec, shard, get_bytes in shard_iter:
            entry = leaves.setdefault(leaf_spec["path"], {
                "path": leaf_spec["path"],
                "dtype": leaf_spec["dtype"],
                "gshape": list(leaf_spec["gshape"]),
                "shards": [],
            })
            if get_bytes is None:
                stats["shards_skipped_replica"] += 1
                continue
            view = memoryview(get_bytes()).cast("B")
            crc = zlib.crc32(view)
            key = shard["key"]
            shape = list(shard.get("shape") or []) or None
            cached = self._cache.get(key) if differential else None
            if (
                cached is not None
                and cached["crc32"] == crc
                and cached["nbytes"] == len(view)
                and _file_covers(
                    cached["file"], cached["offset"] + cached["nbytes"]
                )
            ):
                record = {
                    "index": shard["index"],
                    "shape": shape or cached.get("shape") or [len(view)],
                    "file": cached["file"],
                    "offset": cached["offset"],
                    "nbytes": cached["nbytes"],
                    "crc32": crc,
                    "step": cached["step"],
                }
                stats["shards_reused"] += 1
                stats["bytes_reused"] += len(view)
            else:
                record = {
                    "index": shard["index"],
                    "shape": shape or [len(view)],
                    "file": rel_bin,
                    "offset": offset,
                    "nbytes": len(view),
                    "crc32": crc,
                    "step": int(step),
                }
                # the view itself, not a copy: on the saver path (views
                # of shm, the buffer lock held through this call) the
                # join below is the only host copy
                payload_parts.append(view)
                offset += len(view)
                stats["shards_written"] += 1
                stats["bytes_written"] += len(view)
            del view
            entry["shards"].append(record)
            cache_updates[key] = {
                "file": record["file"],
                "offset": record["offset"],
                "nbytes": record["nbytes"],
                "crc32": crc,
                "shape": record["shape"],
                "step": record["step"],
            }

        chunks: List[Dict] = []
        if payload_parts:
            payload = b"".join(payload_parts)
            # release the per-shard views NOW (shm exports): the joined
            # payload is the only buffer the writer pool needs
            for part in payload_parts:
                part.release()
            payload_parts.clear()
            writers = max(1, envs.get_int("DLROVER_TPU_PERSIST_WRITERS"))
            chunk_bytes = max(
                1 << 20, envs.get_int("DLROVER_TPU_PERSIST_CHUNK_BYTES")
            )
            chunks = self.storage.write_chunks(
                payload, abs_bin, chunk_bytes=chunk_bytes, writers=writers
            )
            del payload
        self._cache.update(cache_updates)
        manifest = {
            "format": MANIFEST_FORMAT,
            "step": int(step),
            "process_id": self.process_id,
            "num_processes": self.num_processes,
            "extras": extras or {},
            "leaves": list(leaves.values()),
            "files": (
                {rel_bin: {"payload_bytes": offset, "chunks": chunks}}
                if offset else {}
            ),
            "stats": stats,
        }
        dur = time.monotonic() - t0
        from dlrover_tpu_torch.observability import metrics as obs_metrics

        obs_metrics.observe_ckpt_phase("dist_persist", dur, ok=True)
        logger.info(
            "dist-ckpt proc %d step %d: wrote %d shards (%.1f MB), reused "
            "%d, replica-skipped %d in %.2fs",
            self.process_id, step, stats["shards_written"],
            stats["bytes_written"] / 1e6, stats["shards_reused"],
            stats["shards_skipped_replica"], dur,
        )
        return manifest


# ---------------------------------------------------------------------------
# Commit clients: how a host reaches the coordinator.
# ---------------------------------------------------------------------------


def _wait_sealed(status_fn: Callable[[], Dict], step: int,
                 timeout: float) -> bool:
    """Poll ``status_fn`` every ``DLROVER_TPU_DIST_SEAL_POLL_S`` until the
    step is sealed (or a newer one committed), at most ``timeout`` s."""
    deadline = time.time() + timeout
    poll = envs.get_float("DLROVER_TPU_DIST_SEAL_POLL_S")
    while True:
        status = status_fn()
        if status.get("sealed") or status.get("committed_step", -1) >= step:
            return True
        if time.time() >= deadline:
            return False
        time.sleep(max(0.02, poll))


class LocalCommitClient:
    """In-process commit path: wraps a coordinator directly (one process,
    simulated hosts, tests)."""

    def __init__(self, coordinator=None):
        if coordinator is None:
            from dlrover_tpu_torch.master.ckpt_coordinator import (
                CkptCommitCoordinator,
            )

            coordinator = CkptCommitCoordinator()
        self.coordinator = coordinator

    def report_manifest(self, ckpt_dir: str, step: int, process_id: int,
                        num_processes: int, manifest_json: str) -> bool:
        return self.coordinator.report_manifest(
            ckpt_dir, step, process_id, num_processes, manifest_json
        )

    def commit_status(self, ckpt_dir: str, step: int) -> Dict:
        return self.coordinator.status(ckpt_dir, step)

    def wait_commit(self, ckpt_dir: str, step: int, timeout: float) -> bool:
        return _wait_sealed(lambda: self.commit_status(ckpt_dir, step),
                            step, timeout)


class MasterCommitClient:
    """Commit path over the master RPC client (the production shape:
    phase-1 manifests and seal polls ride the existing report/get
    demux to the master's coordinator).  ``get_commit_client`` picks it
    when a master is configured; ``client=`` or ``set_commit_client``
    inject one."""

    def __init__(self, master_client):
        self.client = master_client

    def report_manifest(self, ckpt_dir: str, step: int, process_id: int,
                        num_processes: int, manifest_json: str) -> bool:
        return self.client.report_ckpt_manifest(
            ckpt_dir, step, num_processes, manifest_json,
            process_id=process_id,
        )

    def commit_status(self, ckpt_dir: str, step: int) -> Dict:
        resp = self.client.get_ckpt_commit_status(ckpt_dir, step)
        return {
            "sealed": bool(resp.sealed),
            "committed_step": int(resp.committed_step),
            "reported": int(resp.reported),
            "expected": int(resp.expected),
            "reason": resp.reason,
        }

    def wait_commit(self, ckpt_dir: str, step: int, timeout: float) -> bool:
        return self.client.wait_ckpt_commit(ckpt_dir, step, timeout)


#: a value no key of the commit or broker stores holds (JSON never does)
_ABSENT = "\x00absent"


def store_read(store, key: str) -> Optional[bytes]:
    """``key``'s value, or None when it is absent, in one atomic store
    operation: a compare-and-set that never matches leaves the key as it
    is and returns its value, or the expected one when there is no key.
    A ``check`` then ``get`` would block until the store's timeout when
    another process deletes the key in between."""
    value = store.compare_set(key, _ABSENT, _ABSENT)
    return None if value == _ABSENT.encode() else value


class StoreCommitClient:
    """Commit path over a ``torch.distributed`` world's c10d store: the
    job's one coordinator runs in process 0, and every process's reports
    and seal polls go through the store (the port's stand-in for the
    reference's master RPC, ``MasterCommitClient``).

    A report is a key of its own (``report/<n>``, ``n`` from the store's
    one counter ``seq``); process 0's service thread reads ``seq`` once a
    tick, feeds each new report to the coordinator in order and deletes
    it, then publishes the step's status (``status/<dir>/<step>``), the
    dir's committed step (``committed/<dir>``) and the report's verdict
    (``ack/<n>``), which the reporter waits for, as for an RPC's answer,
    and deletes.  A step's status key goes once the step is at or below
    the committed step or the coordinator no longer tracks it, so the
    store holds a bounded number of keys however many saves a job makes.
    Nothing here is a collective of the training group: the saver's
    thread reports and polls while the training thread runs its own
    collectives."""

    PREFIX = "dlrover_tpu_ckpt_commit/"

    def __init__(self, store, process_id: int, num_processes: int,
                 group=None):
        """``group``: the default process group whose store this is; the
        service thread stops once the world no longer has it."""
        self.store = tdist.PrefixStore(self.PREFIX, store)
        self._group = group
        self.process_id = int(process_id)
        self.num_processes = int(num_processes)
        self.coordinator = None
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if self.process_id == 0:
            from dlrover_tpu_torch.master.ckpt_coordinator import (
                CkptCommitCoordinator,
            )

            self.coordinator = CkptCommitCoordinator()
            self._seen = 0
            # dir -> steps whose status key is in the store
            self._published: Dict[str, set] = {}
            # the counter exists before the service's first read of it
            self.store.add("seq", 0)
            self._thread = threading.Thread(
                target=self._serve, name="ckpt-commit-service", daemon=True)
            self._thread.start()
            # stopped before the interpreter tears the store down under it
            atexit.register(self.close)

    # -- the reporting side (every process) ----------------------------

    def report_manifest(self, ckpt_dir: str, step: int, process_id: int,
                        num_processes: int, manifest_json: str) -> bool:
        pid = int(process_id)
        n = int(self.store.add("seq", 1)) - 1
        self.store.set(f"report/{n}", json.dumps({
            "ckpt_dir": ckpt_dir, "step": int(step), "process_id": pid,
            "num_processes": int(num_processes),
            "manifest": manifest_json,
        }))
        ack = f"ack/{n}"
        deadline = time.time() + envs.get_float(
            "DLROVER_TPU_DIST_COMMIT_TIMEOUT_S")
        poll = max(0.01, envs.get_float("DLROVER_TPU_DIST_SEAL_POLL_S"))
        while not self.store.check([ack]):
            if time.time() >= deadline:
                logger.error("dist-ckpt proc %d step %d: the coordinator "
                             "did not take the report", pid, step)
                return False
            time.sleep(min(poll, 0.05))
        verdict = self.store.get(ack) == b"1"
        self.store.delete_key(ack)
        return verdict

    def commit_status(self, ckpt_dir: str, step: int) -> Dict:
        status = {"step": int(step), "committed_step": -1, "sealed": False,
                  "reported": 0, "expected": 0, "reason": ""}
        # process 0 deletes a status key once its step is committed
        value = store_read(self.store, f"status/{ckpt_dir}/{int(step)}")
        if value is not None:
            status.update(json.loads(value))
        committed = f"committed/{ckpt_dir}"
        if self.store.check([committed]):
            status["committed_step"] = max(
                status["committed_step"], int(self.store.get(committed)))
        status["sealed"] = bool(status["sealed"] or (
            step >= 0 and step <= status["committed_step"]))
        return status

    def wait_commit(self, ckpt_dir: str, step: int, timeout: float) -> bool:
        return _wait_sealed(lambda: self.commit_status(ckpt_dir, step),
                            step, timeout)

    # -- the coordinator side (process 0) ------------------------------

    def _serve(self) -> None:
        poll = min(0.05, max(0.005, envs.get_float(
            "DLROVER_TPU_DIST_SEAL_POLL_S")))
        while not self._stopped.is_set():
            if self._group is not None and not (
                    tdist.is_initialized() and self._group is
                    tdist.distributed_c10d._get_default_group()):
                return  # the world this store served is gone
            try:
                self._drain()
            except Exception as e:  # noqa: BLE001 - the world went away
                if not self._stopped.is_set():
                    logger.warning("ckpt commit service stopped: %s", e)
                return
            self._stopped.wait(poll)

    def _drain(self) -> None:
        """Feed every report that arrived, in the order of ``seq``: one
        read of the store when none did."""
        sent = int(self.store.get("seq"))
        while self._seen < sent:
            n = self._seen
            key = f"report/{n}"
            if not self.store.check([key]):
                break  # reserved, not written yet
            report = json.loads(self.store.get(key))
            self.store.delete_key(key)
            ok = self.coordinator.report_manifest(
                report["ckpt_dir"], report["step"],
                report["process_id"], report["num_processes"],
                report["manifest"])
            ckpt_dir, step = report["ckpt_dir"], report["step"]
            status = self.coordinator.status(ckpt_dir, step)
            self.store.set(f"status/{ckpt_dir}/{step}", json.dumps(status))
            self.store.set(f"committed/{ckpt_dir}",
                           str(status["committed_step"]))
            self._prune(ckpt_dir, step, status["committed_step"])
            self.store.set(f"ack/{n}", "1" if ok else "0")
            self._seen = n + 1

    def _prune(self, ckpt_dir: str, step: int, committed: int) -> None:
        """Delete the status keys of ``ckpt_dir``'s steps at or below the
        committed step (``commit_status`` answers them from
        ``committed/<dir>``) and of steps the coordinator evicted."""
        published = self._published.setdefault(ckpt_dir, set())
        published.add(int(step))
        for s in sorted(published):
            if s <= committed or not self.coordinator.status(
                    ckpt_dir, s)["reported"]:
                self.store.delete_key(f"status/{ckpt_dir}/{s}")
                published.discard(s)

    def close(self) -> None:
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


_client_override = None
_local_client: Optional[LocalCommitClient] = None
_store_client: Optional[Tuple[Any, StoreCommitClient]] = None
_client_mu = threading.Lock()


def set_commit_client(client) -> None:
    """Inject the commit path explicitly (tests, custom transports).
    ``None`` restores auto-discovery."""
    global _client_override
    _client_override = client


def master_client():
    """The process's master RPC client when a master is configured
    (``MasterClient.singleton_instance()``), else None."""
    from dlrover_tpu_torch.agent.master_client import MasterClient

    return MasterClient.singleton_instance()


def get_commit_client(num_processes: int = 1):
    """The commit path for this process, in the reference's order: an
    injected override; else the master's RPC (``MasterCommitClient``)
    when a master is configured; else the store client of the
    ``torch.distributed`` world when one of more than one rank is
    initialised (one per world: a new world gets a new client); else a
    process-local coordinator (one process — commit semantics intact,
    coordination in-process).

    A commit of ``num_processes > 1`` with none of these raises
    ``NotImplementedError``: a private coordinator would never see the
    other processes' reports, so nothing could seal it."""
    global _local_client, _store_client
    if _client_override is not None:
        return _client_override
    mc = master_client()
    if mc is not None:
        return MasterCommitClient(mc)
    rank, size = world()
    if size <= 1 and int(num_processes) > 1:
        raise NotImplementedError(
            f"a distributed commit of {int(num_processes)} processes with "
            "no master and no torch.distributed world: no coordinator "
            "could seal it (configure the master's address, "
            "DLROVER_TPU_MASTER_ADDR, or initialise the world)")
    with _client_mu:
        if size > 1:
            group = tdist.distributed_c10d._get_default_group()
            if _store_client is None or _store_client[0] is not group:
                if _store_client is not None:
                    _store_client[1].close()
                store = tdist.distributed_c10d._get_default_store()
                _store_client = (group, StoreCommitClient(store, rank, size,
                                                          group))
            return _store_client[1]
        if _local_client is None:
            _local_client = LocalCommitClient()
        return _local_client


def fire_phase1_report(
    client, ckpt_dir: str, step: int, process_id: int,
    num_processes: int, manifest: Dict,
) -> bool:
    """The ONE phase-1 report sequence, shared by the trainer-side
    engine and the saver-side persister so both commit paths behave
    identically under the same chaos schedule.  The ``ckpt.
    phase1_report`` point models a host dying AFTER its shard bytes
    landed but BEFORE the coordinator hears about them — the
    torn-commit window the seal protocol exists to survive."""
    from dlrover_tpu_torch.observability import metrics as obs_metrics
    from dlrover_tpu_torch.observability import trace

    fault = chaos.point(
        "ckpt.phase1_report", step=step, proc=process_id
    )
    if fault is not None and fault.kind in (chaos.DROP, chaos.FLAP):
        logger.warning(
            "dist-ckpt proc %d step %d: phase-1 report dropped "
            "(injected host death before report)", process_id, step,
        )
        return False
    t0, ok = time.monotonic(), False
    try:
        with trace.span(
            "ckpt.phase1_report",
            attrs={"step": int(step), "proc": int(process_id)},
        ):
            ok = client.report_manifest(
                ckpt_dir, step, process_id, num_processes,
                json.dumps(manifest),
            )
        return ok
    finally:
        obs_metrics.observe_ckpt_phase(
            "phase1", time.monotonic() - t0, ok=ok
        )


# ---------------------------------------------------------------------------
# Committed-state readers (shared by writers, coordinator, restore).
# ---------------------------------------------------------------------------


def read_committed_step(
    ckpt_dir: str, storage: Optional[CheckpointStorage] = None
) -> int:
    """Latest sealed step: the COMMITTED pointer, with a manifest-dir
    scan fallback (manifests are written atomically BEFORE the pointer,
    so the newest readable manifest is always a fully sealed step)."""
    storage = storage or get_checkpoint_storage(path=ckpt_dir)
    raw = storage.read(committed_path(ckpt_dir))
    if raw:
        try:
            return int(str(raw).strip())
        except ValueError:
            logger.warning(
                "dist-ckpt: unreadable COMMITTED pointer in %s; falling "
                "back to a manifest scan", ckpt_dir,
            )
    best = -1
    for name in storage.listdir(os.path.join(ckpt_dir, MANIFESTS_DIR)):
        if name.startswith("manifest_") and name.endswith(".json"):
            try:
                best = max(best, int(name[len("manifest_"):-len(".json")]))
            except ValueError:
                continue
    return best


def read_manifest(
    ckpt_dir: str, step: int,
    storage: Optional[CheckpointStorage] = None,
) -> Optional[Dict]:
    storage = storage or get_checkpoint_storage(path=ckpt_dir)
    raw = storage.read(manifest_path(ckpt_dir, step))
    if raw is None:
        return None
    try:
        return json.loads(raw)
    except ValueError:
        return None


def manifest_leaf(manifest: Dict, path: str) -> Optional[Dict]:
    """The sealed manifest's record for one leaf path (None when the
    manifest does not carry it)."""
    for leaf in manifest.get("leaves", []):
        if leaf.get("path") == path:
            return leaf
    return None


# ---------------------------------------------------------------------------
# The engine: save / restore façade.
# ---------------------------------------------------------------------------


def _host_bytes(data: torch.Tensor) -> np.ndarray:
    """A shard's bytes on the host, as a flat uint8 array."""
    return snapshot.byte_view(data).cpu().numpy()


class DistributedCheckpointEngine:
    """Per-process façade over the distributed commit.

    ``save`` copies only OWNED shards device->host, persists them
    (differential), fires the phase-1 report, and (optionally) blocks
    until the coordinator seals the step.  ``load`` restores from the
    sealed manifest into a target state in place, with partial reads and
    per-shard byte accounting in ``last_read_stats``.  The sealed
    ``COMMITTED`` pointer is job-global, so every process reads the same
    step."""

    def __init__(
        self,
        checkpoint_dir: str,
        process_id: Optional[int] = None,
        num_processes: Optional[int] = None,
        client=None,
        storage: Optional[CheckpointStorage] = None,
    ):
        self.checkpoint_dir = checkpoint_dir
        self.process_id = process_id
        self.num_processes = num_processes
        self._storage = storage or get_checkpoint_storage(path=checkpoint_dir)
        self._client = client
        self._writer: Optional[HostShardWriter] = None
        self.last_save_stats: Dict = {}
        self.last_read_stats: Dict = {}
        self.last_extras: Dict = {}
        # whether the last load began to fill its target (a failure after
        # that leaves the target inconsistent)
        self.fill_started = False

    def _commit_client(self, num_processes: int):
        if self._client is None:
            self._client = get_commit_client(num_processes)
        return self._client

    def _get_writer(self, process_id: int, num_processes: int):
        if self._writer is None:
            self._writer = HostShardWriter(
                self.checkpoint_dir, process_id, num_processes,
                storage=self._storage,
            )
        return self._writer

    # -- save ---------------------------------------------------------

    def save(
        self,
        step: int,
        state: Any,
        extras: Optional[Dict] = None,
        wait_seal: bool = True,
        timeout: Optional[float] = None,
        layout: Optional[Layout] = None,
        layouts: Optional[Sequence[Layout]] = None,
    ) -> Dict:
        """Persist owned shards + two-phase commit; returns the save
        stats (bytes/shards written / reused / replica-skipped, whether
        the phase-1 report landed and whether the step sealed).
        ``layout``/``layouts``: as ``plan_dist_shards``."""
        leaves, pid, nprocs = plan_dist_shards(
            state, self.process_id, self.num_processes, layout, layouts
        )
        client = self._commit_client(nprocs)
        writer = self._get_writer(pid, nprocs)

        def _iter():
            for leaf in leaves:
                spec = {"path": leaf["path"], "dtype": leaf["dtype"],
                        "gshape": leaf["gshape"]}
                for shard in leaf["shards"]:
                    if shard["owner"] != pid:
                        yield spec, shard, None
                        continue
                    data = shard["data"]
                    shard = dict(
                        shard, shape=[int(d) for d in data.shape] or [1],
                    )
                    yield spec, shard, (lambda _d=data: _host_bytes(_d))

        from dlrover_tpu_torch.observability import trace

        with trace.span(
            "ckpt.dist_save", attrs={"step": int(step), "proc": pid}
        ):
            manifest = writer.persist(step, _iter(), extras=extras)
            stats = dict(manifest["stats"])
            stats["reported"] = fire_phase1_report(
                client, self.checkpoint_dir, step, pid, nprocs,
                manifest,
            )
            stats["sealed"] = False
            if stats["reported"] and wait_seal:
                if timeout is None:
                    timeout = envs.get_float(
                        "DLROVER_TPU_DIST_COMMIT_TIMEOUT_S")
                stats["sealed"] = client.wait_commit(
                    self.checkpoint_dir, step, timeout
                )
        self.last_save_stats = stats
        return stats

    # -- restore ------------------------------------------------------

    def committed_step(self) -> int:
        return read_committed_step(self.checkpoint_dir, self._storage)

    def load(self, target: Any, layout: Optional[Layout] = None,
             step: Optional[int] = None) -> Tuple[Optional[Any], int]:
        """Restore ``(state, step)`` from the sealed manifest (latest
        committed step unless pinned) into ``target``: its tensors filled
        in place at this process's boxes (``layout``, as the flash
        engine's ``load``), its ints the checkpoint's.  Reads ONLY the
        stored shards those boxes overlap; ``last_read_stats`` records
        ``{bytes_read, bytes_total, shards_fetched}``.  Every leaf is
        checked against the manifest before any is filled."""
        from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
            target_boxes,
        )

        return self.load_boxes(target, target_boxes(target, layout), step)

    def load_boxes(self, target: Any, boxes: Dict,
                   step: Optional[int] = None) -> Tuple[Optional[Any], int]:
        """``load`` with this process's ``{path: (global shape, box)}``
        already resolved (``engine.target_boxes``)."""
        from dlrover_tpu_torch.observability import metrics as obs_metrics
        from dlrover_tpu_torch.observability import trace

        t0, out_step = time.monotonic(), -1
        try:
            with trace.span("ckpt.dist_restore") as sp:
                state, out_step = self._load_boxes(target, boxes, step)
                sp.set_attr("step", int(out_step))
            return state, out_step
        finally:
            obs_metrics.observe_ckpt_phase(
                "dist_restore", time.monotonic() - t0, ok=out_step >= 0
            )

    def _load_boxes(self, target: Any, boxes: Dict,
                    step: Optional[int]) -> Tuple[Optional[Any], int]:
        self.fill_started = False
        if step is None:
            step = self.committed_step()
        if step < 0:
            self.last_read_stats = {}
            return None, -1
        manifest = read_manifest(self.checkpoint_dir, step, self._storage)
        if manifest is None:
            logger.error(
                "dist-ckpt: committed step %d has no readable manifest "
                "in %s", step, self.checkpoint_dir,
            )
            self.last_read_stats = {}
            return None, -1
        by_path = {leaf["path"]: leaf for leaf in manifest["leaves"]}
        stats = {
            "bytes_read": 0,
            "bytes_total": sum(
                int(rec["nbytes"])
                for leaf in manifest["leaves"]
                for rec in leaf["shards"]
            ),
            "shards_fetched": 0,
        }
        for path, (gshape, _) in boxes.items():
            leaf = by_path.get(path)
            if leaf is None:
                raise ValueError(f"checkpoint missing leaf {path}")
            if list(leaf["gshape"]) != list(gshape):
                raise ValueError(
                    f"leaf {path}: stored gshape {leaf['gshape']} != "
                    f"target {tuple(gshape)}"
                )

        def fill(path, leaf):
            box = boxes[path][1]
            src = self.read_slice_from(
                by_path[path], tuple(slice(a, b) for a, b in box), stats)
            if isinstance(leaf, torch.Tensor):
                with torch.no_grad():
                    leaf.copy_(src.reshape(leaf.shape))
                return leaf
            return type(leaf)(src.reshape(()).item())

        self.fill_started = True
        state = map_with_path(fill, target)
        self.last_read_stats = stats
        self.last_extras = manifest.get("extras", {}) or {}
        logger.info(
            "dist-ckpt restored step %d reading %.1f/%.1f MB (%d shard "
            "fetches)", step, stats["bytes_read"] / 1e6,
            stats["bytes_total"] / 1e6, stats["shards_fetched"],
        )
        return state, step

    def read_slice(
        self, path: str, target, step: Optional[int] = None,
        stats: Optional[Dict] = None,
    ) -> torch.Tensor:
        """One leaf slice straight off the committed manifest (the
        partial-read primitive ``load`` assembles through; also the
        byte-accounting probe)."""
        if step is None:
            step = self.committed_step()
        manifest = read_manifest(self.checkpoint_dir, step, self._storage)
        if manifest is None:
            raise OSError(f"no sealed manifest for step {step}")
        for leaf in manifest["leaves"]:
            if leaf["path"] == path:
                if stats is None:
                    stats = self.last_read_stats = {
                        "bytes_read": 0, "shards_fetched": 0,
                    }
                return self.read_slice_from(leaf, target, stats)
        raise ValueError(f"no leaf {path} in step {step}")

    def read_slice_from(
        self, leaf: Dict, target, stats: Dict
    ) -> torch.Tensor:
        """Assemble ``target`` (tuple of slices over the leaf's global
        shape) from manifest shard records, reading only overlapping
        byte ranges.  With CRC verification off, a row-contiguous
        overlap is trimmed to the sub-range of the stored shard it
        needs; any verifying mode fetches whole needed shards so the
        recorded CRC can be checked."""
        dtype = leaf["dtype"]
        gshape = leaf["gshape"]
        tgt = []
        for dim, sl in enumerate(target):
            start = sl.start if sl.start is not None else 0
            stop = sl.stop if sl.stop is not None else gshape[dim]
            tgt.append((int(start), int(stop)))
        out = torch.zeros([b - a for a, b in tgt],
                          dtype=snapshot.torch_dtype(dtype))
        verify = envs.get_str("DLROVER_TPU_VERIFY_CRC").lower() != "off"
        filled = 0
        seen_boxes = set()
        for rec in leaf["shards"]:
            # duplicate replica records (manifests persisted without an
            # ownership map) carry identical bytes: consume each box
            # once, or the filled accounting would double-count and mask
            # genuinely missing shards as zeros
            box = tuple(
                tuple(int(v) for v in span) for span in rec["index"]
            )
            if box in seen_boxes:
                continue
            seen_boxes.add(box)
            src_slices, dst_slices = [], []
            overlap_ok = True
            for (ts, te), (ss, se) in zip(tgt, rec["index"]):
                lo, hi = max(ts, ss), min(te, se)
                if lo >= hi:
                    overlap_ok = False
                    break
                src_slices.append(slice(lo - ss, hi - ss))
                dst_slices.append(slice(lo - ts, hi - ts))
            if not overlap_ok:
                continue
            arr = self._fetch(rec, dtype, src_slices, verify, stats)
            piece = out[tuple(dst_slices)]
            out[tuple(dst_slices)] = arr.reshape(piece.shape)
            filled += piece.numel() if dst_slices else out.numel()
        if filled < out.numel():
            raise ValueError(
                f"sealed manifest does not cover leaf {leaf['path']} "
                f"slice {tgt} (filled {filled}/{out.numel()})"
            )
        return out

    def _fetch(self, rec: Dict, dtype: str, src_slices, verify: bool,
               stats: Dict) -> torch.Tensor:
        """The bytes of one stored shard's needed sub-box."""
        path = os.path.join(self.checkpoint_dir, rec["file"])
        shape = [int(d) for d in rec["shape"]]
        nbytes = int(rec["nbytes"])
        row_trim = (
            not verify
            and len(src_slices) >= 1
            and len(shape) >= 1
            and all(
                sl.start == 0 and sl.stop == dim
                for sl, dim in zip(src_slices[1:], shape[1:])
            )
            and shape[0] > 0
            and nbytes % shape[0] == 0
        )
        if row_trim and (
            src_slices[0].start > 0 or src_slices[0].stop < shape[0]
        ):
            row_bytes = nbytes // shape[0]
            lo, hi = src_slices[0].start, src_slices[0].stop
            buf = self._storage.read_range(
                path, int(rec["offset"]) + lo * row_bytes,
                (hi - lo) * row_bytes,
            )
            if buf is None or len(buf) != (hi - lo) * row_bytes:
                raise OSError(
                    f"shard range vanished: {path}@{rec['offset']}"
                )
            stats["bytes_read"] += len(buf)
            stats["shards_fetched"] += 1
            arr = snapshot.tensor_from_bytes(buf, dtype,
                                             [hi - lo] + shape[1:])
            rest = tuple(src_slices[1:])
            return arr[(slice(None),) + rest] if rest else arr
        buf = self._storage.read_range(path, int(rec["offset"]), nbytes)
        if buf is None or len(buf) != nbytes:
            raise OSError(
                f"shard payload vanished/truncated: {path}"
                f"@{rec['offset']}+{nbytes}"
            )
        stats["bytes_read"] += nbytes
        stats["shards_fetched"] += 1
        if verify:
            got = zlib.crc32(memoryview(np.ascontiguousarray(buf)))
            if got != int(rec["crc32"]):
                raise OSError(
                    f"shard checksum mismatch: {path}@{rec['offset']}"
                    f"+{nbytes} (stored {int(rec['crc32']):#010x}, got "
                    f"{got:#010x})"
                )
        arr = snapshot.tensor_from_bytes(buf, dtype, shape)
        return arr[tuple(src_slices)]


# ---------------------------------------------------------------------------
# Saver-side persister (the flash-engine -> saver handoff).
# ---------------------------------------------------------------------------


class DistributedPersister:
    """Persist a flash-checkpoint shm snapshot through the distributed
    commit instead of the legacy per-proc done-file protocol.

    Lives in the saver (``AsyncCheckpointSaver``, one per
    ``(process_id, ckpt_dir)``): the save EVENT carries the ownership map
    (``owned_event_map`` — the saver never sees the layouts), and the
    payload bytes come straight out of shm at the meta's recorded offsets
    — no re-staging."""

    def __init__(self, ckpt_dir: str, process_id: int, num_processes: int,
                 storage: Optional[CheckpointStorage] = None):
        # refuses a commit no coordinator of this world can seal before
        # anything is written
        get_commit_client(num_processes)
        self.writer = HostShardWriter(
            ckpt_dir, process_id, num_processes, storage=storage
        )
        self.ckpt_dir = ckpt_dir
        self.process_id = int(process_id)
        self.num_processes = int(num_processes)

    def persist_from_shm(
        self, shm, meta: Dict, owned: Optional[Dict[str, List]],
    ) -> Tuple[Dict, Dict, int]:
        """Write owned shards out of shm; returns ``(manifest, stats,
        step)`` WITHOUT reporting — the saver fires :meth:`report` only
        after its torn-generation re-check passes, so a racing writer
        can never get a torn snapshot's manifest sealed.

        ``owned=None`` means "no ownership map" (save-on-failure from a
        register-only event): every local shard is persisted — safe,
        just redundant.  A PRESENT map is authoritative even when this
        host owns nothing (its empty-shards manifest still teaches the
        coordinator the leaf specs); conflating the two would make a
        zero-owner host re-write the full state and defeat the dedup."""
        step = int(meta["step"])
        base = snapshot.payload_base(shm)
        owned_keys: Optional[set] = None
        if owned is not None:
            owned_keys = {
                shard_key(path, index)
                for path, boxes in owned.items()
                for index in boxes
            }

        def _iter():
            for leaf in meta["leaves"]:
                spec = {"path": leaf["path"], "dtype": leaf["dtype"],
                        "gshape": leaf["gshape"]}
                for shard_meta in leaf["shards"]:
                    key = shard_key(leaf["path"], shard_meta["index"])
                    shard = {
                        "index": shard_meta["index"],
                        "key": key,
                        "shape": shard_meta.get("shape"),
                    }
                    if owned_keys is not None and key not in owned_keys:
                        yield spec, shard, None
                        continue

                    def get_bytes(
                        _off=int(shard_meta["offset"]),
                        _n=int(shard_meta["nbytes"]),
                    ):
                        return memoryview(shm.buf)[
                            base + _off : base + _off + _n
                        ]

                    yield spec, shard, get_bytes

        manifest = self.writer.persist(
            step, _iter(), extras=meta.get("extras") or {}
        )
        return manifest, dict(manifest["stats"]), step

    def report(self, step: int, manifest: Dict) -> bool:
        """Phase-1 report (after the caller validated the persist)."""
        return fire_phase1_report(
            get_commit_client(self.num_processes), self.ckpt_dir, step,
            self.process_id,
            self.num_processes, manifest,
        )

    def wait_commit(self, step: int, timeout: Optional[float] = None) -> bool:
        if timeout is None:
            timeout = envs.get_float("DLROVER_TPU_DIST_COMMIT_TIMEOUT_S")
        return get_commit_client(self.num_processes).wait_commit(
            self.ckpt_dir, step, timeout
        )
