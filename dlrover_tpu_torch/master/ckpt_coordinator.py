"""The job's two-phase checkpoint commit coordinator.

Port of ``CkptCommitCoordinator`` of ``dlrover_tpu/master/ckpt_coordinator.py``.
Phase 1 lands here as one manifest per process: the owned shards it
persisted (file, offset, bytes and CRC32 per shard) and every leaf's spec,
so that any one report teaches the coordinator the global tree.  The
coordinator **seals** a step only when the union of the reported manifests
covers every leaf's global shape; phase 2 then writes the sealed union
manifest and advances the ``COMMITTED`` pointer (both with
``storage.write_atomic``), and deletes the shard files that no kept
manifest references.  The port has no master: the one coordinator of a
``torch.distributed`` world runs in process 0, fed through the world's
store (``distributed.StoreCommitClient``), and one process runs its own
(``distributed.LocalCommitClient``).

Failure matrix (what each crash window leaves behind):

* host dies before/while writing shards → its manifest never arrives,
  the step never seals; orphan ``shards/`` files are GC'd later.
* host dies between its shard write and its report (the
  ``ckpt.phase1_report`` chaos point) → same as above.
* coordinator dies before writing the union manifest (the
  ``ckpt.phase2_commit`` chaos point) → step unsealed; a re-report of
  any manifest (idempotent) retries the seal.
* coordinator dies between the manifest write and the COMMITTED pointer →
  the manifest-scan fallback in ``distributed.read_committed_step`` still
  finds the sealed step (a manifest file exists only for fully covered
  steps).

In every window the previously committed step stays fully restorable.

``PeerRestoreBroker`` (the reference's, ``:447-544``) is the directory of
shm snapshots that peers can serve to a replaced process
(``trainer/flash_checkpoint/peer_restore.py``).  The reference keeps it in
the master; the port reaches it in-process (``peer_restore.LocalPeerClient``)
or over the world's c10d store (``peer_restore.StorePeerClient``).

Phase 2 runs under the reference's ``ckpt.phase2_commit`` trace span and
chaos point, and records ``ckpt_phase_seconds{phase="phase2_seal"}``.  The
servicer files each recovery report both here and in its time-series store,
whose recent reports the MTTR sentinel judges
(``observability/sentinel.py``); the dashboard's ``/recovery`` view reads
the broker's ``snapshot()`` (``master/dashboard.py``).
"""

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from dlrover_tpu_torch import chaos
from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.storage import get_checkpoint_storage
from dlrover_tpu_torch.trainer.flash_checkpoint import distributed as dist


class _PendingCommit:
    """One (ckpt_dir, step)'s phase-1 state."""

    def __init__(self, step: int):
        self.step = step
        self.manifests: Dict[int, Dict] = {}
        self.expected = 0
        self.sealed = False
        self.sealing = False  # a phase-2 seal is in flight off-lock
        self.error = ""
        self.created = time.time()
        self.sealed_at = 0.0
        self.bytes_written = 0


class CkptCommitCoordinator:
    """Sequences distributed checkpoint commits for every checkpoint
    directory the job writes.

    Thread-safe behind one mutex, which only ever guards in-memory state,
    never storage I/O.  A seal is three moves: the seal *decision* and the
    union build happen under the lock, the union-manifest write runs
    off-lock so concurrent reports and status queries never queue behind
    one slow storage call, and the small COMMITTED-pointer publish re-takes
    the lock so 'sealed' and 'COMMITTED advanced' stay one indivisible
    transition for every status reader.  ``_PendingCommit.sealing`` claims
    a step so duplicate reports arriving mid-seal don't start a second
    seal."""

    def __init__(self, storage_factory=None):
        self._mu = threading.Lock()
        self._storage_factory = storage_factory or (
            lambda path: get_checkpoint_storage(path=path)
        )
        self._storages: Dict[str, Any] = {}
        # ckpt_dir -> {step: _PendingCommit}
        self._pending: Dict[str, Dict[int, _PendingCommit]] = {}
        self._committed: Dict[str, int] = {}

    def _storage(self, ckpt_dir: str):
        if ckpt_dir not in self._storages:
            self._storages[ckpt_dir] = self._storage_factory(ckpt_dir)
        return self._storages[ckpt_dir]

    # -- phase 1 -------------------------------------------------------

    def report_manifest(
        self,
        ckpt_dir: str,
        step: int,
        process_id: int,
        num_processes: int,
        manifest_json: str,
    ) -> bool:
        """Record one host's phase-1 manifest; seal if the union now
        covers the global pytree.  Idempotent per (step, process) —
        re-reports replace the stored manifest and retry a failed
        seal."""
        try:
            manifest = json.loads(manifest_json)
        except ValueError as e:
            logger.error(
                "ckpt coordinator: unparseable manifest from proc %d "
                "step %d: %s", process_id, step, e,
            )
            return False
        union = None
        with self._mu:
            if ckpt_dir not in self._committed:
                # lazily learn the dir's committed history (coordinator
                # restart must not forget sealed steps)
                self._committed[ckpt_dir] = dist.read_committed_step(
                    ckpt_dir, self._storage(ckpt_dir)
                )
            steps = self._pending.setdefault(ckpt_dir, {})
            pending = steps.setdefault(int(step), _PendingCommit(int(step)))
            if pending.sealed:
                return True  # duplicate report of a sealed step
            pending.manifests[int(process_id)] = manifest
            pending.expected = max(
                pending.expected, int(num_processes), len(pending.manifests)
            )
            if not pending.sealing and self._union_covers(pending):
                # claim the seal and snapshot the union UNDER the lock;
                # the storage I/O runs off-lock in _seal below
                pending.sealing = True
                union = self._build_union(pending)
            self._evict(steps, self._committed.get(ckpt_dir, -1))
            storage = self._storage(ckpt_dir)
        sealed_now = union is not None and self._seal(
            ckpt_dir, pending, union, storage
        )
        if sealed_now:
            # GC outside the mutex: it scans the shards dir and reads
            # every retained manifest (idempotent cleanup, safe to race)
            try:
                self._gc(ckpt_dir, storage)
            except Exception as e:  # noqa: BLE001 - cleanup only
                logger.warning(
                    "ckpt coordinator GC in %s failed: %s", ckpt_dir, e
                )
        return True

    @staticmethod
    def _union_covers(pending: _PendingCommit) -> bool:
        """True when the reported manifests' shard boxes tile every
        leaf's full global shape."""
        union: Dict[str, Dict] = {}
        for manifest in pending.manifests.values():
            for leaf in manifest.get("leaves", []):
                entry = union.setdefault(leaf["path"], {
                    "path": leaf["path"],
                    "gshape": leaf["gshape"],
                    "shards": [],
                })
                entry["shards"].extend(leaf.get("shards", []))
        if not union:
            return False
        return all(dist.union_covers(leaf) for leaf in union.values())

    # -- phase 2 -------------------------------------------------------

    def _seal(self, ckpt_dir: str, pending: _PendingCommit,
              union: Dict, storage: Any) -> bool:
        """Publish the sealed union manifest + COMMITTED pointer.

        Runs OFF the coordinator mutex (the caller claimed the seal via
        ``pending.sealing``); only the final COMMITTED-pointer publish
        re-takes the lock, so status readers see 'sealed' and 'COMMITTED
        advanced' atomically and the pointer never moves backwards.  A
        failure (injected via ``ckpt.phase2_commit`` or real) marks the
        pending error and leaves the previous commit intact; the next
        (re-)report retries."""
        from dlrover_tpu_torch.observability import metrics as obs_metrics
        from dlrover_tpu_torch.observability import trace

        step = pending.step
        t0, ok = time.monotonic(), False
        try:
            with trace.span(
                "ckpt.phase2_commit",
                attrs={"step": step, "hosts": len(pending.manifests)},
            ):
                fault = chaos.point("ckpt.phase2_commit", step=step)
                if fault is not None and fault.kind in (
                    chaos.DROP, chaos.FLAP
                ):
                    # injected coordinator death before the commit
                    # record: nothing published, step stays unsealed
                    raise chaos.ChaosError(
                        "chaos: coordinator died before phase-2 commit"
                    )
                storage.write_atomic(
                    json.dumps(union),
                    dist.manifest_path(ckpt_dir, step),
                )
                with self._mu:
                    if step > self._committed.get(ckpt_dir, -1):
                        # the pointer file is a handful of bytes and the
                        # write is a local atomic rename: cheap enough
                        # to keep under the lock, which is what makes
                        # the advance monotonic under concurrent seals
                        storage.write_atomic(
                            str(step), dist.committed_path(ckpt_dir)
                        )
                        self._committed[ckpt_dir] = step
                    pending.sealed = True
                    pending.error = ""
                    pending.sealed_at = time.time()
                ok = True
                logger.info(
                    "ckpt coordinator: sealed step %d in %s (%d hosts, "
                    "%.1f MB new bytes)", step, ckpt_dir,
                    len(pending.manifests), pending.bytes_written / 1e6,
                )
        except Exception as e:  # noqa: BLE001 - seal failure must not
            # crash the servicer; the previous commit stays restorable
            with self._mu:
                pending.error = f"{type(e).__name__}: {e}"
            logger.error(
                "ckpt coordinator: phase-2 commit of step %d FAILED "
                "(%s); previous committed step %d remains the restore "
                "point", step, pending.error,
                self._committed.get(ckpt_dir, -1),
            )
        finally:
            with self._mu:
                pending.sealing = False
            obs_metrics.observe_ckpt_phase(
                "phase2_seal", time.monotonic() - t0, ok=ok
            )
        return ok

    def _build_union(self, pending: _PendingCommit) -> Dict:
        union_leaves: Dict[str, Dict] = {}
        hosts: Dict[str, Dict] = {}
        chain: set = set()
        extras: Dict = {}
        bytes_written = 0
        seen_boxes: set = set()
        for pid in sorted(pending.manifests):
            manifest = pending.manifests[pid]
            if manifest.get("extras"):
                extras = manifest["extras"]
            stats = manifest.get("stats", {})
            hosts[str(pid)] = stats
            bytes_written += int(stats.get("bytes_written", 0))
            for leaf in manifest.get("leaves", []):
                entry = union_leaves.setdefault(leaf["path"], {
                    "path": leaf["path"],
                    "dtype": leaf["dtype"],
                    "gshape": leaf["gshape"],
                    "shards": [],
                })
                for rec in leaf.get("shards", []):
                    # a save-on-failure without an ownership map makes
                    # several hosts persist the SAME replicated shard:
                    # keep the first record per box (identical bytes)
                    box = (leaf["path"],) + tuple(
                        tuple(int(v) for v in span)
                        for span in rec["index"]
                    )
                    if box in seen_boxes:
                        continue
                    seen_boxes.add(box)
                    entry["shards"].append(rec)
                    chain.add(int(rec.get("step", pending.step)))
        pending.bytes_written = bytes_written
        return {
            "format": dist.MANIFEST_FORMAT,
            "step": pending.step,
            "num_processes": pending.expected,
            "extras": extras,
            "leaves": list(union_leaves.values()),
            "hosts": hosts,
            "chain": sorted(chain),
        }

    def _gc(self, ckpt_dir: str, storage=None) -> None:
        """Manifest-chain GC: drop manifests beyond the retention
        window, then delete shard files no retained manifest references.
        Files referenced by ANY retained manifest survive — every
        retained committed step stays bit-exact restorable.  Runs OUTSIDE
        the coordinator mutex (idempotent)."""
        keep = max(1, envs.get_int("DLROVER_TPU_DIST_MANIFEST_KEEP"))
        if storage is None:
            with self._mu:
                storage = self._storage(ckpt_dir)
        man_dir = os.path.join(ckpt_dir, dist.MANIFESTS_DIR)
        steps: List[int] = []
        for name in storage.listdir(man_dir):
            if name.startswith("manifest_") and name.endswith(".json"):
                try:
                    steps.append(int(name[len("manifest_"):-len(".json")]))
                except ValueError:
                    continue
        steps.sort()
        drop, retain = steps[:-keep], steps[-keep:]
        referenced: set = set()
        for step in retain:
            manifest = dist.read_manifest(ckpt_dir, step, storage)
            if manifest is None:
                continue
            for leaf in manifest.get("leaves", []):
                for rec in leaf.get("shards", []):
                    referenced.add(os.path.basename(rec["file"]))
        for step in drop:
            storage.safe_remove(dist.manifest_path(ckpt_dir, step))
        removed = 0
        floor = retain[0] if retain else -1
        shards_dir = os.path.join(ckpt_dir, dist.SHARDS_DIR)
        for name in storage.listdir(shards_dir):
            if not name.endswith(".bin") or name in referenced:
                continue
            # only collect files STRICTLY OLDER than the retention
            # window: an unreferenced file at/after the oldest retained
            # step may belong to an in-flight (not yet sealed) commit
            try:
                file_step = int(name.split("_", 1)[0][1:])
            except (ValueError, IndexError):
                continue
            if file_step >= floor:
                continue
            storage.safe_remove(os.path.join(shards_dir, name))
            removed += 1
        if drop or removed:
            logger.info(
                "ckpt coordinator GC in %s: dropped %d manifests, "
                "removed %d superseded shard files (keep=%d)",
                ckpt_dir, len(drop), removed, keep,
            )

    #: hard cap on pending commits tracked per directory: on a job where
    #: a host can never report (step never seals, watermark never moves)
    #: every save would otherwise accumulate its peers' manifests forever
    MAX_PENDING = 16

    @classmethod
    def _evict(cls, steps: Dict[int, _PendingCommit],
               committed: int) -> None:
        """Bound pending state: sealed/abandoned steps older than the
        committed watermark (minus a small history for status queries)
        are dropped, and the per-dir count is hard-capped regardless of
        the watermark (oldest first; a dropped unsealed step can be
        re-reported — its shard files are still on disk)."""
        stale = [
            s for s in steps if s < committed - 8 and not steps[s].sealing
        ]
        for s in stale:
            del steps[s]
        evictable = [s for s in steps if not steps[s].sealing]
        while len(steps) > cls.MAX_PENDING and evictable:
            oldest = min(evictable)
            evictable.remove(oldest)
            if not steps[oldest].sealed:
                logger.warning(
                    "ckpt coordinator: evicting unsealed pending step "
                    "%d (%d manifests) — pending cap %d reached; a "
                    "re-report revives it", oldest,
                    len(steps[oldest].manifests), cls.MAX_PENDING,
                )
            del steps[oldest]

    # -- queries -------------------------------------------------------

    def status(self, ckpt_dir: str, step: int = -1) -> Dict:
        with self._mu:
            if ckpt_dir not in self._committed:
                self._committed[ckpt_dir] = dist.read_committed_step(
                    ckpt_dir, self._storage(ckpt_dir)
                )
            committed = self._committed.get(ckpt_dir, -1)
            pending = self._pending.get(ckpt_dir, {}).get(int(step))
            return {
                "step": int(step),
                "committed_step": committed,
                "sealed": bool(
                    (pending and pending.sealed)
                    or (step >= 0 and step <= committed)
                ),
                "reported": len(pending.manifests) if pending else 0,
                "expected": pending.expected if pending else 0,
                "reason": pending.error if pending else "",
            }

    def committed_step(self, ckpt_dir: str) -> int:
        return int(self.status(ckpt_dir)["committed_step"])

    def snapshot(self) -> Dict:
        """Per-dir committed step + recent commit attempts (step, hosts
        reported, sealed, error, bytes)."""
        with self._mu:
            dirs = {}
            for ckpt_dir, steps in self._pending.items():
                dirs[ckpt_dir] = {
                    "committed_step": self._committed.get(ckpt_dir, -1),
                    "commits": [
                        {
                            "step": p.step,
                            "reported": len(p.manifests),
                            "expected": p.expected,
                            "sealed": p.sealed,
                            "error": p.error,
                            "bytes_written": p.bytes_written,
                            "age_s": round(time.time() - p.created, 1),
                        }
                        for _, p in sorted(steps.items())[-8:]
                    ],
                }
            for ckpt_dir, committed in self._committed.items():
                dirs.setdefault(ckpt_dir, {
                    "committed_step": committed, "commits": [],
                })
            return {"dirs": dirs}


class PeerRestoreBroker:
    """Directory of the shm snapshots the job's processes can serve.

    Surviving processes announce their committed snapshot steps; a
    replacement asks for donors and is pointed at every announced peer of
    its scope that holds the wanted step, replica-group members first
    (byte-identical shards), then the rest.  Finished recoveries report
    back (``recoveries``)."""

    #: recoveries retained
    MAX_RECOVERIES = 32

    def __init__(self):
        self._mu = threading.Lock()
        # scope -> {process_id: {step, addr, num_processes, ts}}
        self._peers: Dict[str, Dict[int, Dict]] = {}
        self._recoveries: List[Dict] = []

    def announce(self, scope: str, process_id: int, num_processes: int,
                 step: int, addr: str) -> bool:
        with self._mu:
            self._peers.setdefault(scope, {})[int(process_id)] = {
                "step": int(step),
                "addr": addr,
                "num_processes": int(num_processes),
                "ts": time.time(),
            }
        return True

    def assign(self, scope: str, process_id: int, step: int = -1,
               group: Optional[List[int]] = None) -> Dict:
        """Ordered donors for one recovering process: peers of ``scope``
        holding ``step`` (the newest announced step when ``step`` is -1),
        the requester excluded, replica-group members first."""
        group = [int(g) for g in (group or [])]
        with self._mu:
            peers = {
                pid: dict(entry)
                for pid, entry in self._peers.get(scope, {}).items()
                if pid != int(process_id)
            }
        if step < 0 and peers:
            step = max(entry["step"] for entry in peers.values())
        candidates = [
            (pid, entry) for pid, entry in peers.items()
            if entry["step"] == step and step >= 0
        ]
        # replica-group members hold byte-identical shards: one hop
        # restores everything, so they lead the donor order
        candidates.sort(key=lambda item: (item[0] not in group, item[0]))
        return {
            "step": int(step),
            "donors": {str(pid): entry["addr"] for pid, entry in candidates},
        }

    def record_recovery(self, report: Dict) -> bool:
        entry = dict(report, ts=time.time())
        with self._mu:
            self._recoveries.append(entry)
            del self._recoveries[:-self.MAX_RECOVERIES]
        return True

    def recoveries(self) -> List[Dict]:
        with self._mu:
            return [dict(r) for r in self._recoveries]

    def evict(self, scope: str, process_id: int) -> None:
        """Forget a dead process's announcement (the fetch side's
        demotion is the backstop while the broker has not heard of the
        death)."""
        with self._mu:
            self._peers.get(scope, {}).pop(int(process_id), None)

    def snapshot(self) -> Dict:
        """Who can serve which step, each announcement's age, and the
        last recoveries."""
        now = time.time()
        with self._mu:
            scopes = {
                scope: {
                    str(pid): {
                        "step": entry["step"],
                        "addr": entry["addr"],
                        "age_s": round(now - entry["ts"], 1),
                    }
                    for pid, entry in sorted(peers.items())
                }
                for scope, peers in self._peers.items()
            }
            recoveries = [dict(r) for r in self._recoveries[-8:]]
        return {"scopes": scopes, "recoveries": recoveries}
