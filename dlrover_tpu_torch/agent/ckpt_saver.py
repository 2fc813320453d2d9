"""Agent-side async checkpoint saver.

Port of ``dlrover_tpu/agent/ckpt_saver.py`` (``AsyncCheckpointSaver``): lives
in the agent process so the last shm snapshot survives worker crashes (or,
with no agent, in the training process as the engine's local saver); drains
save events from the SharedQueue, persists shm payloads to storage, and
runs the done-file commit protocol:

    <ckpt_dir>/tmp_<step>/shards_<proc>.bin + meta_<proc>.json
    <ckpt_dir>/tmp_<step>/.done/<proc>          (one per process)
    rename tmp_<step> -> <step> + tracker file   (by process 0's agent,
                                                  once all done-files exist)

A save event with ``dist`` (``DLROVER_TPU_DIST_PERSIST``) takes the
distributed persist instead (``distributed.DistributedPersister``, one per
``(process, ckpt_dir)``): the shards the event's ownership map names are
written out of shm, the phase-1 report fires only after the
torn-generation re-check, and the step counts as persisted only once the
coordinator sealed it — no done files, no rename.  Its coordinator is
the one ``distributed.get_commit_client`` finds: the master's, over its
commit RPC, in an agent process (which always has a master) and in any
process with a master configured; else process 0's over the world's
store.  A ``dist`` event of several processes with neither raises
``NotImplementedError``.

Save-on-failure: when the agent detects worker death it calls
``save_shm_on_failure`` which persists any shm snapshot newer than the
last committed step.

With ``DLROVER_TPU_PEER_RESTORE=1`` a persisted step is announced to the
peer-restore broker (``peer_restore.maybe_announce``: a no-op unless a
peer client and a serve endpoint are registered in the process).  A failed
persist is logged and kept (``take_error``): the engine raises it to the
training thread.
"""

import json
import os
import queue as queue_mod
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.common.constants import CheckpointConstant
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.multi_process import (
    SharedDict,
    SharedLock,
    SharedMemoryBuffer,
    SharedQueue,
)
from dlrover_tpu_torch.common.storage import (
    CheckpointStorage,
    PosixDiskStorage,
    refuse_url_path,
)
from dlrover_tpu_torch.trainer.flash_checkpoint import snapshot


class AsyncCheckpointSaver:
    _singleton: Optional["AsyncCheckpointSaver"] = None

    def __init__(
        self,
        scope: str = "",
        storage: Optional[CheckpointStorage] = None,
        queue: Optional[SharedQueue] = None,
        commit_timeout: float = 600.0,
    ):
        from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
            CKPT_EVENT_QUEUE,
            CKPT_PROGRESS,
            default_scope,
        )

        self._scope = scope or default_scope()
        self._queue = queue or SharedQueue(
            f"{CKPT_EVENT_QUEUE}_{self._scope}", create=True
        )
        # progress dict lets worker-side engines see persist completion
        # (their wait_saving_complete exit barrier)
        self._progress = SharedDict(
            f"{CKPT_PROGRESS}_{self._scope}", create=True
        )
        self._storage = storage or PosixDiskStorage()
        # an explicitly injected storage (credentials, options) always wins
        self._storage_injected = storage is not None
        self._commit_timeout = commit_timeout
        self._thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        # save events persist concurrently — proc 0's commit barrier must
        # not block other processes' persists behind it in the queue
        self._executor = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="ckpt-persist"
        )
        self._outstanding = 0
        # a Condition so wait_idle blocks on persist completion instead
        # of sleep-polling the counter (same long-poll-over-poll move as
        # the control plane's kv waits, in-process)
        self._outstanding_lock = threading.Condition()
        # when the saver went from idle to busy (0 = idle): the
        # heartbeat digest's ckpt_busy_s, feeding the master's
        # checkpoint-stall diagnostician
        self._busy_since = 0.0
        # wait_idle sync sentinels awaiting the drain loop's ack
        self._sync_acks: Dict[str, threading.Event] = {}
        # per-process serialization of events for the same shm
        self._proc_locks: Dict[int, threading.Lock] = {}
        # process_id -> last save event (for save-on-failure)
        self._tracked: Dict[int, Dict] = {}
        self._persisted_steps: Dict[int, int] = {}
        # (process_id, ckpt_dir) -> DistributedPersister: long-lived, so
        # its differential CRC cache survives across saves
        self._dist_persisters: Dict[Tuple[int, str], object] = {}
        # the first persist failure not yet raised to a trainer
        self._error: Optional[BaseException] = None

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def start_async_saving_ckpt(cls, scope: str = "") -> "AsyncCheckpointSaver":
        """Start the singleton saver inside the agent process (reference
        ``start_async_saving_ckpt`` ckpt_saver.py:477)."""
        if cls._singleton is None:
            cls._singleton = cls(scope=scope)
            cls._singleton.start()
        return cls._singleton

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._drain_loop, daemon=True, name="ckpt-saver"
            )
            self._thread.start()

    def stop(self):
        self._stopped.set()
        self._executor.shutdown(wait=False)
        self._progress.close()

    def take_error(self) -> Optional[BaseException]:
        """The first persist failure since the last call (or None)."""
        with self._outstanding_lock:
            error, self._error = self._error, None
        return error

    def idle(self) -> bool:
        with self._outstanding_lock:
            return self._outstanding == 0

    def persisted_step(self, process_id: int) -> int:
        """Highest step durably persisted (committed) for this process
        (-1 = none), so an engine's exit barrier can distinguish 'saver
        idle' from 'save actually durable'."""
        return self._persisted_steps.get(int(process_id), -1)

    def busy_seconds(self) -> float:
        """Seconds since the saver went from idle to busy (0.0 when
        idle).  A value that keeps growing across heartbeats is a
        persist that never finishes — the checkpoint-stall signal."""
        with self._outstanding_lock:
            if self._outstanding == 0 or self._busy_since <= 0:
                return 0.0
            return max(0.0, time.time() - self._busy_since)

    def wait_idle(self, timeout: float = 600.0) -> bool:
        """Agent-side exit barrier: block until all queued/in-flight
        persists finished (reference _wait_async_saver training.py:1515).

        Blocks on the outstanding-count Condition, so the common case
        (persists draining to zero) wakes immediately; the short wait
        cap only re-checks the cross-process queue, which has no
        in-process completion signal."""
        deadline = time.time() + timeout
        if self._thread is not None and not self._stopped.is_set():
            # FIFO sync sentinel: the queue pop and the _outstanding
            # increment are two steps, so a just-dequeued save is
            # briefly invisible to both the queue and the counter.  The
            # sentinel's ack proves every save queued before this call
            # has been popped AND counted, closing that window.
            sync_id = uuid.uuid4().hex
            ack = threading.Event()
            self._sync_acks[sync_id] = ack
            try:
                self._queue.put({"type": "sync", "sync_id": sync_id})
                # chunked so a concurrent stop() can't strand us: the
                # drain loop acks pending sentinels on exit, but a
                # sentinel registered after that exit would wait the
                # full timeout without the _stopped re-check here
                while not ack.is_set():
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        return False
                    if self._stopped.is_set():
                        break
                    ack.wait(min(0.2, remaining))
            finally:
                self._sync_acks.pop(sync_id, None)
        while time.time() < deadline:
            # the queue check is a unix-socket round-trip — keep it
            # OUTSIDE the Condition, or persist completions (which need
            # the same lock to decrement) serialize behind IPC
            # (a stopped saver has no consumer: anything still queued —
            # including our own sentinel — will never be popped, so
            # idleness is the outstanding counter alone)
            if self._stopped.is_set() or self._queue.empty():
                with self._outstanding_lock:
                    if self._outstanding == 0:
                        return True
                    self._outstanding_lock.wait(
                        min(0.2, max(0.01, deadline - time.time()))
                    )
            else:
                time.sleep(min(0.2, max(0.01, deadline - time.time())))
        return False

    # -- event loop --------------------------------------------------------

    def _drain_loop(self):
        while not self._stopped.is_set():
            try:
                event = self._queue.get(timeout=1.0)
            except queue_mod.Empty:
                continue
            except Exception as e:  # noqa: BLE001 - queue may close on exit
                logger.warning("ckpt saver queue error: %s", e)
                time.sleep(1.0)
                continue
            if event.get("type") == "register":
                self._tracked[int(event["process_id"])] = dict(event)
                continue
            if event.get("type") == "sync":
                ack = self._sync_acks.get(str(event.get("sync_id", "")))
                if ack is not None:
                    ack.set()
                continue
            if event.get("type") != "save":
                continue
            with self._outstanding_lock:
                if self._outstanding == 0:
                    self._busy_since = time.time()
                self._outstanding += 1
            self._executor.submit(self._run_save, event)
        # stopping: wake every wait_idle still parked on a sentinel this
        # loop will never pop
        for ack in list(self._sync_acks.values()):
            ack.set()

    def _run_save(self, event: Dict):
        from dlrover_tpu_torch.observability import metrics as obs_metrics
        from dlrover_tpu_torch.observability import trace

        proc_lock = self._proc_locks.setdefault(
            int(event["process_id"]), threading.Lock()
        )
        t0, ok = time.monotonic(), False
        try:
            with proc_lock:
                # persist span: shm -> durable storage for one step;
                # storage chaos faults fired below attribute here
                with trace.span(
                    "flash.persist",
                    attrs={"step": int(event.get("step", -1))},
                ):
                    self._handle_save(event)
            ok = True
        except Exception as e:  # noqa: BLE001 - saver must survive
            logger.exception("async ckpt persist failed: %s", event)
            with self._outstanding_lock:
                if self._error is None:
                    self._error = e
        finally:
            obs_metrics.observe_ckpt_phase(
                "persist", time.monotonic() - t0, ok=ok
            )
            with self._outstanding_lock:
                self._outstanding -= 1
                if self._outstanding == 0:
                    self._busy_since = 0.0
                self._outstanding_lock.notify_all()

    # -- persist -----------------------------------------------------------

    def _handle_save(self, event: Dict):
        process_id = int(event["process_id"])
        self._tracked[process_id] = dict(event)
        step = int(event["step"])
        ckpt_dir = event["ckpt_dir"]
        shm = SharedMemoryBuffer(event["shm"])
        if not shm.attach():
            logger.error("save event for missing shm %s", event["shm"])
            return
        t0 = time.time()
        # the WORKER owns the lock guarding its shm; a dead worker leaves
        # a stale socket FILE behind, so liveness = the server answering
        # (ping), not the file existing.  Dead owner => persist lock-free
        # (nobody can write the buffer).
        acquired = False
        lock = None
        lock_name = event.get("lock", "")
        owner_dead = bool(event.get("owner_dead"))
        if lock_name:
            lock = SharedLock(lock_name, create=False)
            if lock.is_available() and lock.ping():
                if owner_dead:
                    # workers were just killed; break any held lock
                    try:
                        lock.force_release()
                    except (TimeoutError, RuntimeError):
                        pass
                # the streaming stager holds the buffer lock for the
                # WHOLE paced D2H stream — minutes for multi-GB states
                # on a slow link — so the persist wait must outlast a
                # stream, not just a memcpy.  When the stream finishes,
                # the saver re-reads the meta and persists the (possibly
                # newer) snapshot it finds.
                wait_s = envs.get_float("DLROVER_TPU_PERSIST_LOCK_WAIT_S")
                try:
                    acquired = lock.acquire(timeout=wait_s)
                except TimeoutError:
                    acquired = False
                if not acquired and lock.ping():
                    logger.warning(
                        "could not acquire live ckpt lock %s; skipping "
                        "persist of a possibly-torn snapshot", lock_name,
                    )
                    return
            else:
                lock = None  # dead owner: lock-free persist is safe
        try:
            gen0 = snapshot.read_generation(shm)
            meta = snapshot.read_snapshot_meta(shm)
            if meta is None:
                if snapshot.is_torn(shm):
                    logger.warning(
                        "shm %s left torn mid-stream (dirty generation); "
                        "nothing persistable — restore will fall back to "
                        "storage candidates", event["shm"],
                    )
                return
            if meta["step"] != step:
                # the trainer overwrote the snapshot with a newer step in
                # the enqueue->persist window; persist the newer content
                # (SPMD lockstep means peers raced the same way)
                logger.warning(
                    "shm snapshot advanced %d -> %d before persist",
                    step, meta["step"],
                )
                step = meta["step"]
            dist_event = bool(event.get("dist"))
            if dist_event:
                persister = self._dist_persister(
                    process_id, ckpt_dir, int(event["num_processes"]))
                # owned=None (no map: a save-on-failure from a register
                # event) persists every local shard; a map, even one
                # owning nothing, is exact
                dist_manifest, _, step = persister.persist_from_shm(
                    shm, meta, event.get("owned"))
            else:
                self._persist_snapshot(shm, meta, ckpt_dir, process_id)
            if acquired is False and snapshot.read_generation(shm) != gen0:
                # lock-free persist (dead owner) raced a writer after
                # all: the bytes just written may be torn — do NOT
                # commit them as a valid step
                logger.error(
                    "shm %s generation moved during lock-free persist; "
                    "discarding the possibly-torn copy", event["shm"],
                )
                return
        finally:
            if acquired and lock is not None:
                lock.release()
            shm.close()
        if dist_event:
            # no done files, no rename: the step is durable only once the
            # coordinator seals it.  The phase-1 report fires only HERE,
            # after the torn-generation re-check above passed (a torn
            # snapshot's manifest must never reach the coordinator), and
            # the progress (the trainer's exit barrier) advances only on
            # the seal, so wait_saving_complete means "globally committed"
            reported = persister.report(step, dist_manifest)
            if not (reported and persister.wait_commit(step)):
                logger.error(
                    "distributed commit of step %d not sealed (reported="
                    "%s); the previous committed step remains the "
                    "restore point", step, reported,
                )
                return
        else:
            self._commit(ckpt_dir, step, process_id,
                         int(event["num_processes"]))
        self._persisted_steps[process_id] = step
        try:
            self._progress.set(str(process_id), step)
        except Exception:  # noqa: BLE001 - progress is best-effort
            pass
        if envs.get_bool("DLROVER_TPU_PEER_RESTORE"):
            # the step proved durable and the shm copy passed its
            # torn-generation re-check: announce it to the broker now
            from dlrover_tpu_torch.trainer.flash_checkpoint import (
                peer_restore,
            )

            peer_restore.maybe_announce(
                step, process_id=process_id,
                num_processes=int(event["num_processes"]))
        logger.info(
            "persisted ckpt step=%d proc=%d in %.2fs%s",
            step, process_id, time.time() - t0,
            " (distributed commit sealed)" if dist_event else "",
        )

    def _dist_persister(self, process_id: int, ckpt_dir: str,
                        num_processes: int):
        """The per-(process, dir) distributed persister."""
        key = (int(process_id), ckpt_dir)
        if key not in self._dist_persisters:
            from dlrover_tpu_torch.trainer.flash_checkpoint.distributed \
                import DistributedPersister

            self._dist_persisters[key] = DistributedPersister(
                ckpt_dir, process_id, num_processes,
                storage=self._storage_for(ckpt_dir),
            )
        return self._dist_persisters[key]

    def _storage_for(self, ckpt_dir: str) -> CheckpointStorage:
        """An explicitly injected storage wins; URL checkpoint dirs (the
        reference's fsspec backend) are not ported."""
        if not self._storage_injected:
            refuse_url_path(ckpt_dir)
        return self._storage

    @staticmethod
    def _persist_pool_config() -> Tuple[int, int]:
        """(writers, chunk_bytes) for the parallel persist pool."""
        writers = envs.get_int("DLROVER_TPU_PERSIST_WRITERS")
        chunk = envs.get_int("DLROVER_TPU_PERSIST_CHUNK_BYTES")
        return max(1, writers), max(1 << 20, chunk)

    def _persist_snapshot(
        self, shm: SharedMemoryBuffer, meta: Dict, ckpt_dir: str,
        process_id: int,
    ):
        storage = self._storage_for(ckpt_dir)
        step = meta["step"]
        tmp_dir = os.path.join(ckpt_dir, f"tmp_{step}")
        storage.safe_makedirs(tmp_dir)
        bin_name = f"shards_{process_id}.bin"
        # payload starts right after the meta header in shm
        base = snapshot.payload_base(shm)
        payload = meta.get("payload_bytes", shm.size - base)
        # memoryview, NOT bytes(): materializing the payload first costs
        # a multi-GB allocation + memcpy and capped persist at ~100MB/s
        # on an 860MB/s disk.  The chunked writer pool fans fixed-size
        # slices across threads (posix pwrite releases the GIL) and
        # records a CRC32 per chunk, verified again on restore.
        writers, chunk_bytes = self._persist_pool_config()
        view = memoryview(shm.buf)[base : base + payload]
        chunks = storage.write_chunks(
            view,
            os.path.join(tmp_dir, bin_name),
            chunk_bytes=chunk_bytes,
            writers=writers,
        )
        # per-SHARD CRCs ride the leaf meta too: lazy restore verifies
        # exactly the ranges it fetches (a resharded multi-host restore
        # must not pull whole 64MB writer chunks to check a 1MB shard),
        # while the chunk records above serve the eager whole-payload
        # verify and the writer pool's own integrity.  One extra RAM
        # pass over shm — noise next to the disk write.
        import zlib

        leaves = meta["leaves"]
        for leaf in leaves:
            for shard in leaf["shards"]:
                start, n = int(shard["offset"]), int(shard["nbytes"])
                shard["crc32"] = zlib.crc32(view[start : start + n])
        disk_meta = {
            "step": step,
            "bin_file": bin_name,
            "extras": meta.get("extras", {}),
            "leaves": leaves,
            "payload_bytes": int(payload),
            "chunks": chunks,
        }
        storage.write(
            json.dumps(disk_meta),
            os.path.join(tmp_dir, f"meta_{process_id}.json"),
        )

    def _commit(self, ckpt_dir: str, step: int, process_id: int,
                num_processes: int):
        storage = self._storage_for(ckpt_dir)
        tmp_dir = os.path.join(ckpt_dir, f"tmp_{step}")
        done_dir = os.path.join(tmp_dir, CheckpointConstant.DONE_DIR)
        storage.safe_makedirs(done_dir)
        storage.write("1", os.path.join(done_dir, str(process_id)))
        if process_id != 0:
            return
        # process-0's agent finalizes once every process persisted
        deadline = time.time() + self._commit_timeout
        final_dir = os.path.join(ckpt_dir, str(step))
        while time.time() < deadline:
            done = len(storage.listdir(done_dir))
            if done >= num_processes:
                if storage.exists(final_dir):
                    # re-save of a step that already exists on disk (e.g.
                    # save-on-failure after a normal save): replace it —
                    # refusing would leave tmp_ stranded with the tracker
                    # pointing at stale data
                    storage.safe_rmtree(final_dir)
                storage.safe_move(tmp_dir, final_dir)
                from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
                    tracker_path,
                )

                # atomic: a crash mid-write must never leave a torn
                # tracker (restore falls back to a directory scan on an
                # unreadable tracker, but a half-written NUMBER would
                # silently point at the wrong step)
                storage.write_atomic(str(step), tracker_path(ckpt_dir))
                logger.info("committed checkpoint step %d", step)
                return
            time.sleep(0.5)
        logger.error(
            "commit timed out for step %d (%d/%d done)",
            step, len(storage.listdir(done_dir)), num_processes,
        )

    # -- save-on-failure ---------------------------------------------------

    def save_shm_on_failure(self) -> List[int]:
        """Persist any shm snapshot newer than its last committed step
        (called by the agent when workers die).  Returns persisted steps."""
        saved = []
        for process_id, event in list(self._tracked.items()):
            shm = SharedMemoryBuffer(event["shm"])
            if not shm.attach():
                continue
            meta = snapshot.read_snapshot_meta(shm)
            torn = snapshot.is_torn(shm)
            shm.close()
            if meta is None:
                if torn:
                    # the worker died mid-stream: the shm holds a part-
                    # old, part-new payload under a dirty generation.
                    # Nothing here is persistable — the restore path
                    # falls back to the storage step candidates.
                    logger.warning(
                        "save-on-failure: proc %d shm snapshot is torn "
                        "(killed mid-stream); falling back to storage "
                        "candidates", process_id,
                    )
                continue
            if meta["step"] > self._persisted_steps.get(process_id, -1):
                logger.info(
                    "save-on-failure: persisting shm step %d (proc %d)",
                    meta["step"], process_id,
                )
                try:
                    self._handle_save(
                        {**event, "step": meta["step"], "owner_dead": True}
                    )
                    saved.append(meta["step"])
                except Exception:  # noqa: BLE001 - keep persisting others
                    logger.exception(
                        "save-on-failure persist failed for proc %d",
                        process_id,
                    )
        return saved
