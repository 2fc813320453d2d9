"""Checkpoint engine: the training-process side of Flash Checkpoint.

Port of ``dlrover_tpu/trainer/flash_checkpoint/engine.py``.  Save path:
device->host copy of the state's tensors into shm, then an event to the
async saver, which persists shm to storage off the training path.  Load
path: shm fast path, else the newest readable step on storage.

The async save (``save_to_memory_async`` / ``save_to_storage_async``) must
deal with what the reference does not have: the port's ``train_step``
mutates the fp32 masters and the Adam moments IN PLACE
(``trainer/train.py``), so a snapshot staged from the live tensors behind
the next step would tear.  The async save therefore enqueues a
device-to-device copy of every leaf on the training stream (into one device
buffer, allocated once and reused: the reference's "at most one transient
device copy"), records a CUDA event and returns.  A train step dispatched
after it runs after the copy on the same stream; the stager thread's side
stream waits for the event before its device-to-host chunks.  The blocking
time is the time to enqueue the copies.

A restore fills the target state's tensors IN PLACE (``load(target)``):
host-to-device copies from shm or from the files, and no second
device-resident copy of the state.

Over a ``torch.distributed`` world of N ranks (one process each), the
process id and count are the rank and the world size.  Each rank writes
the local tensors of its state into its own segment, each at its box of
the leaf's global shape (``layout``: ``Trainer.state_layout``;
``snapshot.py``), and its saver persists them under ``tmp_<step>``; process
0 commits once every process's done file exists.  A restore is collective,
with a fixed count of agreements per ``load``: every rank offers its shm
step (the shm must cover this rank's target boxes), one ``all_gather`` of
one int64 agrees on it, and only a step that every rank offers wins;
otherwise one more agrees whether a sealed distributed commit at least as
new as the newest legacy step restores, and if none does, every rank scans
storage for its newest fully covering legacy step and one more
``all_gather`` agrees on that, or every rank starts fresh.  A storage
restore may reshard: each target box is read from the stored boxes it
overlaps, whatever mesh saved them.  Ranks that share one host and no
agent each run their own in-process saver.

``DLROVER_TPU_DIST_PERSIST=1`` routes storage saves through the
distributed persist (``distributed.py``): the save event carries this
rank's ownership map (``_note_dist_ownership``, from every rank's layout),
and the saver writes the owned shards only and commits the step in two
phases, with no done files.

A lost process's snapshot can come back from its peers' memory.
``replica=True`` (over a world of more than one process; in one process it
does nothing, as in the reference) keeps each segment on the next process
of the world's ring (``replica.py``): every memory save, a skipped one too,
ends in that collective exchange, so the async saves take the synchronous
path (the exchange must not run on the stager's thread beside the training
thread's collectives).  ``DLROVER_TPU_PEER_RESTORE=1`` serves this
process's segment to its peers and announces each committed step to the
broker (``peer_restore.py``; the engine starts the endpoint and takes the
default peer client where none is registered).  When the memory agreement
of a restore fails, every rank runs the replica restore and then the peer
restore's ladder (a survivor fetches nothing), and agrees again after each,
so every rank makes the same collectives.

Telemetry: the engine registers its snapshot segment with the memory
scope as the host byte source ``ckpt_shm:<name>`` (its mapped size) and
marks its phases with ``torch.profiler.record_function`` spans under the
reference's names (``flash.save`` through its trace span, ``flash.load``,
``ckpt_device_to_host``, ``ckpt_shm_write``, ``ckpt_stream_stage``).  A
save and a restore run under the reference's trace spans ``flash.save``
and ``flash.restore`` (the goodput ledger charges them to ``ckpt_stall``)
with their chaos points and ``ckpt_phase_seconds``.  Its timer is
ROADMAP item 7, the rest.
"""

import collections
import logging
import math
import os
import threading
import time
import weakref
import zlib
from contextlib import contextmanager
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.common.constants import CheckpointConstant, NodeEnv
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.multi_process import (
    SharedDict,
    SharedLock,
    SharedMemoryBuffer,
    SharedQueue,
)
from dlrover_tpu_torch.common.pytree import flatten_with_path, map_with_path
from dlrover_tpu_torch.common.storage import get_checkpoint_storage
from dlrover_tpu_torch.device import DeviceLike, resolve_device
from dlrover_tpu_torch.trainer.flash_checkpoint import snapshot
from dlrover_tpu_torch.trainer.flash_checkpoint.snapshot import (
    Layout,
    ShardIndexMap,
)
from dlrover_tpu_torch.training_event.emitter import (
    TrainerEvents,
    get_default_emitter,
)

CKPT_EVENT_QUEUE = "ckpt_events"
CKPT_LOCK = "ckpt_lock"
CKPT_PROGRESS = "ckpt_progress"

# device offsets of the async copy's leaves are aligned to this many bytes
# (a typed view needs an offset its element size divides)
_COPY_ALIGN = 256


def default_scope() -> str:
    """Per-job scope for shm/socket names.  Derived from the job name or
    the master address so two unrelated jobs on one host never collide
    (a stale snapshot from job A must not 'resume' into job B)."""
    name = envs.get_str(NodeEnv.JOB_NAME)
    if name:
        return name
    master = envs.get_str(NodeEnv.MASTER_ADDR)
    if master:
        import hashlib

        return "job" + hashlib.md5(master.encode()).hexdigest()[:8]
    return "job"


def shm_name(process_id: int, scope: str = "") -> str:
    scope = scope or default_scope()
    return f"dlrover_tpu_ckpt_{scope}_{process_id}"


class _DeviceCopy:
    """Holds the on-device state copy of one async snapshot.

    Freeing is observable (``on_free``) and idempotent, so the engine can
    account how many device copies are live and refuse to dispatch a
    second concurrent one — the documented worst case is ONE extra copy,
    and that promise is enforced here rather than hoped for."""

    def __init__(self, snap, on_free):
        self._snap = snap
        self._on_free = on_free
        self._freed = False

    def take(self):
        snap, self._snap = self._snap, None
        return snap

    def free(self):
        self._snap = None
        if not self._freed:
            self._freed = True
            self._on_free()


class _SnapshotStager:
    """One background thread staging queued device-copies into shm.

    Mailbox of depth 1 with latest-wins for memory snapshots: a newer
    snapshot makes a *queued* (not yet started) older one pointless, so
    it is superseded rather than either dropping the new one or stalling
    the training thread.  A queued STORAGE snapshot is never superseded
    (it carries a durability promise): a newer memory snapshot arriving
    behind it gets ``"busy"`` back — the engine then saves synchronously,
    so the fresher state is never dropped — and a second storage snapshot
    waits (bounded) for the queued one to be taken.  A storage snapshot
    MAY supersede a queued memory one.

    A staging failure is kept (``take_error``) and raised to the training
    thread by the engine's next save, load or exit barrier.
    """

    def __init__(self, stage_fn):
        self._stage = stage_fn
        self._cond = threading.Condition()
        self._pending = None  # (step, box, extras, persist)
        self._busy = False
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def take_error(self) -> Optional[BaseException]:
        with self._cond:
            error, self._error = self._error, None
        return error

    def drop_queued_memory(self) -> bool:
        """Free a queued (not yet started) MEMORY snapshot, releasing its
        device copy.  A queued STORAGE snapshot is never dropped
        (durability promise).  Returns True if something was dropped."""
        with self._cond:
            if self._pending is not None and not self._pending[3]:
                logger.info(
                    "queued memory snapshot step=%d dropped for a newer "
                    "save", self._pending[0],
                )
                self._pending[1].free()
                self._pending = None
                self._cond.notify_all()
                return True
        return False

    def submit(self, step, box, extras, persist, wait_timeout: float = 60.0):
        """Queue a staging item.  Returns True when queued, False when the
        stager is stopped, and ``"busy"`` when a queued storage snapshot
        would not drain within ``wait_timeout`` — the caller must then
        fall back to a synchronous save rather than blocking the training
        thread unboundedly."""
        with self._cond:
            if self._stopped:
                return False
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="ckpt-stager", daemon=True
                )
                self._thread.start()
            if self._pending is not None and self._pending[3]:
                if not persist:
                    logger.info(
                        "memory snapshot step=%d: storage snapshot "
                        "step=%d queued; deferring to sync path",
                        step, self._pending[0],
                    )
                    return "busy"
                deadline = time.time() + wait_timeout
                while (
                    self._pending is not None
                    and self._pending[3]
                    and not self._stopped
                ):
                    left = deadline - time.time()
                    if left <= 0:
                        return "busy"
                    self._cond.wait(min(left, 1.0))
                if self._stopped:
                    return False
            if self._pending is not None:
                logger.info(
                    "async snapshot step=%d superseded by step=%d",
                    self._pending[0], step,
                )
                self._pending[1].free()
            self._pending = (step, box, extras, persist)
            self._cond.notify_all()
            return True

    def flush(self, timeout: float = 600.0) -> bool:
        """Wait until nothing is queued and nothing is staging."""
        deadline = time.time() + timeout
        with self._cond:
            while self._pending is not None or self._busy:
                left = deadline - time.time()
                if left <= 0:
                    return False
                self._cond.wait(left)
        return True

    def stop(self, timeout: float = 60.0) -> bool:
        """Drain and stop.  Returns False if the stager thread is still
        running (stuck staging) — the caller must then NOT tear down
        resources the thread touches (shm)."""
        deadline = time.time() + timeout
        drained = self.flush(max(0.0, deadline - time.time()))
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
            thread = self._thread
        if thread is not None and thread.is_alive():
            thread.join(max(0.1, deadline - time.time()))
            if thread.is_alive():
                return False
        return drained

    def _run(self):
        while True:
            with self._cond:
                while self._pending is None and not self._stopped:
                    self._cond.wait()
                if self._pending is None:
                    return  # stopped and drained
                item, self._pending = self._pending, None
                self._busy = True
                # a submitter may be waiting for a queued storage
                # snapshot to be taken
                self._cond.notify_all()
            step, box, extras, persist = item
            item = None
            try:
                self._stage(step, box, extras, persist)
            except Exception as e:  # noqa: BLE001 - kept for the trainer
                logger.exception("async snapshot step=%d failed", step)
                with self._cond:
                    if self._error is None:
                        self._error = e
            finally:
                # safety net (normally a no-op: the stage body frees the
                # copy once it is staged)
                box.free()
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()


def tracker_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, CheckpointConstant.TRACKER_FILE)


def read_tracker(ckpt_dir: str, storage=None) -> Optional[int]:
    storage = storage or get_checkpoint_storage(path=ckpt_dir)
    try:
        content = storage.read(tracker_path(ckpt_dir))
        return int(content.strip()) if content else None
    except (OSError, ValueError):
        return None


def process_identity(process_id: Optional[int] = None,
                     num_processes: Optional[int] = None) -> Tuple[int, int]:
    """``(process id, process count)`` of this engine: the rank and world
    size of ``torch.distributed`` when a world is initialised (the restore
    agreement runs over it), else the arguments or ``NodeEnv``'s
    ``PROCESS_ID`` and ``NUM_PROCESSES``.  An argument or an env value that
    names another rank or world raises, and so does a count above one with
    no world to agree over."""
    if dist.is_available() and dist.is_initialized():
        have = {"process_id": dist.get_rank(),
                "num_processes": dist.get_world_size()}
        for name, given, env in (
                ("process_id", process_id, NodeEnv.PROCESS_ID),
                ("num_processes", num_processes, NodeEnv.NUM_PROCESSES)):
            claims = [(name, given)]
            if os.environ.get(env, "") != "":
                claims.append((env, int(os.environ[env])))
            for source, value in claims:
                if value is not None and int(value) != have[name]:
                    raise ValueError(
                        f"{source}={value} conflicts with the "
                        f"torch.distributed world ({name} {have[name]})")
        return have["process_id"], have["num_processes"]
    pid = (process_id if process_id is not None
           else envs.get_int(NodeEnv.PROCESS_ID))
    count = (num_processes if num_processes is not None
             else envs.get_int(NodeEnv.NUM_PROCESSES))
    if count > 1:
        raise ValueError(
            f"{count} processes and no torch.distributed world: the "
            "restore step is agreed over it; initialise it first "
            "(trainer/bootstrap.init)")
    return int(pid), int(count)


def target_boxes(target: Any, layout: Optional[Layout] = None) -> Dict:
    """``{path: (global shape, box)}`` of every leaf of ``target`` on this
    rank: ``layout``'s, or the whole leaf for a leaf it does not name."""
    layout = layout or {}
    out = {}
    for path, leaf in flatten_with_path(target):
        if path in layout:
            gshape, box = layout[path]
            out[path] = ([int(d) for d in gshape],
                         [[int(a), int(b)] for a, b in box])
        else:
            shape = [int(d) for d in snapshot._as_tensor(leaf).shape]
            out[path] = (shape, [[0, d] for d in shape])
    return out


class CheckpointEngine:
    def __init__(
        self,
        checkpoint_dir: str,
        process_id: Optional[int] = None,
        num_processes: Optional[int] = None,
        scope: str = "",
        replica: bool = False,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # a concrete index: a tensor's device compares equal to it
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.checkpoint_dir = checkpoint_dir
        self.process_id, self.num_processes = process_identity(
            process_id, num_processes)
        # Distributed persist (opt-in): storage saves route through the
        # two-phase commit — the saver writes only the shards this
        # process OWNS and reports a manifest instead of running the
        # done-file protocol.  The ownership map is computed here (the
        # saver never sees the layouts) and rides the save event.
        self._dist_persist = envs.get_bool("DLROVER_TPU_DIST_PERSIST")
        self._dist_owned: Optional[Dict] = None
        # (layouts, state structure) the map was planned from
        self._dist_owned_for: Optional[Tuple] = None
        if self._dist_persist:
            from dlrover_tpu_torch.trainer.flash_checkpoint import (
                distributed,
            )

            # over a world, process 0's coordinator must serve every
            # rank's reports from now on, whether or not it saves
            distributed.get_commit_client(self.num_processes)
        # the byte accounting of the last restore from a sealed commit
        self.last_read_stats: Dict = {}
        # URL checkpoint dirs raise here (the fsspec backend is item 7)
        self._storage = get_checkpoint_storage(path=checkpoint_dir)
        self._scope = scope or default_scope()
        self._shm = SharedMemoryBuffer(shm_name(self.process_id, self._scope))
        # memory scope: the snapshot segment is this process's dominant
        # /dev/shm footprint; the provider reads the MAPPED size only (0
        # until the engine maps it), so a sample never maps a segment
        # (by a weak reference: the scope must not keep a dropped engine's
        # mapping alive)
        try:
            from dlrover_tpu_torch.observability import memscope

            shm = weakref.ref(self._shm)
            memscope.scope().register_host_provider(
                f"ckpt_shm:{self._shm.name}",
                lambda: float(shm().size) if shm() is not None else 0.0)
        except Exception:  # noqa: BLE001 - telemetry must not break
            pass  # engine construction
        self._replica = None
        if replica and self.num_processes > 1:
            from dlrover_tpu_torch.trainer.flash_checkpoint.replica import (
                CkptReplicaManager,
            )

            self._replica = CkptReplicaManager(
                self._shm.name, self.process_id, self.num_processes,
                device=self.device)
        # the report of the last peer recovery this engine ran ({} when
        # none: a survivor fetches nothing)
        self.last_recovery: Dict = {}
        self._peer_restore = envs.get_bool("DLROVER_TPU_PEER_RESTORE")
        self._peer_endpoint = None
        if self._peer_restore:
            from dlrover_tpu_torch.trainer.flash_checkpoint import (
                peer_restore,
            )

            self._peer_endpoint = peer_restore.engine_context(self)
        # Each engine OWNS the lock guarding its snapshot buffer (one
        # writer per shm).  The lock dies with this process, so a crashed
        # mid-save worker can never leave it held.  The agent owns the
        # event queue.
        self._lock_name = f"{CKPT_LOCK}_{self._scope}_{self.process_id}"
        self._lock = SharedLock(self._lock_name, create=True)
        # The SharedLock serializes this process against the AGENT's
        # saver, but it is idempotent per client id — and every thread of
        # this engine is one client, so it cannot serialize the background
        # stager against the training thread.  This in-process mutex is
        # the thread-vs-thread half of the buffer lock; writers take it
        # FIRST, then the SharedLock (_buffer_write_lock).
        self._shm_mu = threading.Lock()
        # guards the durability watermarks (_persist_requested /
        # _last_storage_step): check-then-written from both the training
        # thread and the stager thread
        self._persist_mu = threading.Lock()
        queue_name = f"{CKPT_EVENT_QUEUE}_{self._scope}"
        queue_probe = SharedQueue(queue_name, create=False)
        agent_side = queue_probe.is_available()
        # no agent: persist from a background thread pool in-process.  The
        # ranks of a world may share a host, so each names its own queue
        # and progress dict (a rank must not take another's for an agent's)
        local_scope = (self._scope if self.num_processes <= 1
                       else f"{self._scope}_local{self.process_id}")
        self._queue = (
            queue_probe if agent_side else
            SharedQueue(f"{CKPT_EVENT_QUEUE}_{local_scope}", create=True)
        )
        self._progress = SharedDict(
            f"{CKPT_PROGRESS}_{self._scope}", create=False
        )
        self._local_saver = None
        if not agent_side:
            from dlrover_tpu_torch.agent.ckpt_saver import (
                AsyncCheckpointSaver,
            )

            self._local_saver = AsyncCheckpointSaver(
                scope=local_scope, queue=self._queue
            )
            self._local_saver.start()
        self.latest_memory_step = -1
        self._last_storage_step = -1
        # highest step an ASYNC storage save was requested for; compared
        # against _last_storage_step (advanced only once the persist
        # event is truly enqueued) so the exit barrier can detect a
        # dropped persist instead of reporting success on a stale target
        self._persist_requested = -1
        self.last_extras: Dict = {}
        self._registered = False
        self._register_mu = threading.Lock()
        self._stager = _SnapshotStager(self._stage_snapshot)
        # live device copies of async snapshots: AT MOST ONE.  The copy
        # lives in one buffer the engine allocates once and reuses
        # (_copy_buf), and the slot says whether a stager item still
        # reads it.
        self._live_copies = 0
        self._copy_cv = threading.Condition()
        self._copy_buf: Optional[torch.Tensor] = None
        # (layout, views of _copy_buf per leaf) of the last async save
        self._copy_views: Optional[Tuple] = None
        # when the stager last finished staging a snapshot into shm, and the
        # two phases of the last synchronous save (seconds)
        self.last_staged_at: Optional[float] = None
        self.last_sync_phases: Dict[str, float] = {}
        # How long an async save waits for the device-copy slot before
        # falling back to the synchronous path.
        self._slot_wait_s = envs.get_float("DLROVER_CKPT_SLOT_WAIT_S")
        # Streaming staging (default): the stager precomputes the shm
        # layout and lands each paced D2H chunk directly at its final
        # offset.  "0" restores the two-phase extract + pack path.
        self._stream_staging = envs.get_bool("DLROVER_TPU_STREAM_STAGING")
        # Buffer-lock acquisition bound for the stager and blocking
        # saves: it must outlast a legitimate in-flight stream.
        self._lock_timeout_s = envs.get_float(
            "DLROVER_TPU_CKPT_LOCK_TIMEOUT_S"
        )
        # States at or below this many bytes take the SYNCHRONOUS save
        # path even when async was requested: a small state stages in
        # milliseconds, and the async path opens a crash window (save
        # returned, snapshot not yet in shm).
        self._async_min_bytes = envs.get_int("DLROVER_TPU_ASYNC_MIN_BYTES")
        # Opt-in snapshot precision: "bf16" casts fp32 leaves in the
        # async device copy, halving its device memory and the D2H
        # traffic.  Restore casts back up to the target's dtypes — NOT
        # bit-exact.  Leave empty for exact snapshots.
        self._snapshot_dtype = envs.get_str(
            "DLROVER_TPU_SNAPSHOT_DTYPE"
        ).lower()
        if self._snapshot_dtype in ("bfloat16",):
            self._snapshot_dtype = "bf16"  # accept the dtype's own name
        elif self._snapshot_dtype not in ("", "bf16"):
            logger.warning(
                "unrecognized DLROVER_TPU_SNAPSHOT_DTYPE=%r (supported: "
                "bf16); snapshots stay at full precision",
                self._snapshot_dtype,
            )
            self._snapshot_dtype = ""
        self._events = get_default_emitter("trainer")
        # which path each save took ("sync", "async", "sync_fallback",
        # "skipped"), newest last: the bench and chip_smoke.py print it
        self.save_paths: Deque[Tuple[int, str]] = collections.deque(
            maxlen=64)

    # -- errors from the background threads ----------------------------------

    def _raise_background_error(self) -> None:
        """Raise, on the caller's thread, a failure of the stager or of
        the in-process saver since the last call."""
        error = self._stager.take_error()
        where = "staging"
        if error is None and self._local_saver is not None:
            error = self._local_saver.take_error()
            where = "persist"
        if error is not None:
            raise RuntimeError(
                f"flash checkpoint background {where} failed: {error!r}"
            ) from error

    # -- save --------------------------------------------------------------

    @contextmanager
    def _buffer_write_lock(self, timeout: Optional[float]):
        """The two-level buffer-lock protocol, encoded ONCE: thread
        mutex first (stager vs training thread), SharedLock second
        (worker vs agent saver), released in reverse order.

        ``timeout=None`` means non-blocking.  The two acquires share ONE
        deadline.  Yields True iff BOTH are held; on False nothing is
        held."""
        if timeout is None:
            mu_ok = self._shm_mu.acquire(blocking=False)
        else:
            deadline = time.monotonic() + timeout
            mu_ok = self._shm_mu.acquire(timeout=timeout)
        acquired = False
        if mu_ok:
            got = False
            try:
                if timeout is None:
                    got = self._lock.acquire(blocking=False)
                else:
                    left = max(0.05, deadline - time.monotonic())
                    got = self._lock.acquire(timeout=left)
            finally:
                if not got:
                    self._shm_mu.release()
            acquired = got
        try:
            yield acquired
        finally:
            if acquired:
                self._lock.release()
                self._shm_mu.release()

    def _check_device(self, state: Any) -> None:
        for path, leaf in flatten_with_path(state):
            if (isinstance(leaf, torch.Tensor)
                    and leaf.device.type != self.device.type):
                raise ValueError(
                    f"leaf {path} is on {leaf.device}; this engine "
                    f"checkpoints a state on {self.device}")

    def _check_layout(self, layout: Optional[Layout]) -> None:
        """Over a world a rank's tensors may be shards, and only the
        layout says so: saved or restored as whole leaves they would be a
        wrong checkpoint.  ``{}`` says every leaf is whole on every
        rank."""
        if layout is None and self.num_processes > 1:
            raise ValueError(
                f"a world of {self.num_processes} processes needs the "
                "state's layout (Trainer.state_layout; {} for a state "
                "whole on every rank): without it every local tensor "
                "would pass for its whole leaf")

    def save_to_memory(
        self,
        step: int,
        state: Any,
        extras: Optional[Dict] = None,
        block_on_busy: bool = False,
        layout: Optional[Layout] = None,
    ) -> float:
        """Blocking device->host snapshot into shm; returns blocked secs.

        When the saver still holds the buffer (persisting the previous
        snapshot), a plain memory save is *skipped* rather than stalling
        the training loop; storage saves pass ``block_on_busy=True``
        because the caller explicitly asked for durability.  ``layout``
        places this rank's local tensors in their global leaves
        (``Trainer.state_layout``); a leaf it does not name is saved
        whole.  Over a world it is required (``_check_layout``)."""
        self._check_layout(layout)
        self._raise_background_error()
        self._check_device(state)
        from dlrover_tpu_torch.observability import metrics as obs_metrics
        from dlrover_tpu_torch.observability import trace

        t0, blocked = time.monotonic(), -1.0
        try:
            with trace.span(
                "flash.save",
                attrs={"step": int(step), "storage": bool(block_on_busy)},
            ):
                blocked = self._save_to_memory(step, state, extras,
                                               block_on_busy, layout)
            return blocked
        finally:
            # a skipped non-blocking save is normal contention, not an
            # error; only a durability-requested save that could not
            # write counts
            obs_metrics.observe_ckpt_phase(
                "save_memory", time.monotonic() - t0,
                ok=blocked >= 0 or not block_on_busy,
            )

    def _save_to_memory(self, step, state, extras, block_on_busy,
                        layout) -> float:
        from dlrover_tpu_torch import chaos

        chaos.point("flash.save", step=step)  # exception/delay kinds
        t0 = time.time()
        if not block_on_busy:
            # cheap skip probe: an in-process stager mid-stream, or the
            # agent's saver reading the buffer, must not stall a plain
            # memory save
            with self._buffer_write_lock(None) as free:
                pass
            if not free:
                logger.info(
                    "skip memory snapshot step=%d: stager/saver holds "
                    "the buffer", step,
                )
                self.save_paths.append((int(step), "skipped"))
                self._replicate()
                return 0.0
        self._ensure_registered()
        t_d2h = time.time()
        with record_function("ckpt_device_to_host"):
            leaves = snapshot.extract_host_shards(state, layout=layout)
        t_write = time.time()
        # Re-acquire for the write.  A plain memory save must never
        # stall the training loop, so it skips if the stager or saver
        # won the buffer between the probe above and here; only explicit
        # storage saves block (bounded).
        written = False
        with self._buffer_write_lock(
            self._lock_timeout_s if block_on_busy else None
        ) as held:
            if held:
                with record_function("ckpt_shm_write"):
                    snapshot.write_snapshot(self._shm, step, leaves, extras)
                written = True
        del leaves
        self.last_sync_phases = {"device_to_host_s": t_write - t_d2h,
                                 "shm_write_s": time.time() - t_write}
        if not written:
            # writing anyway would tear the snapshot the saver is reading
            logger.log(
                logging.ERROR if block_on_busy else logging.INFO,
                "could not acquire ckpt buffer for step %d; snapshot skipped",
                step,
            )
            self.save_paths.append((int(step), "skipped"))
            self._replicate()
            return -1.0
        self.latest_memory_step = step
        self._replicate()
        self._announce(step)
        blocked = time.time() - t0
        self.save_paths.append((int(step), "sync"))
        logger.info(
            "flash-ckpt memory snapshot step=%d blocked %.3fs", step, blocked
        )
        self._events.instant(
            TrainerEvents.CKPT_SAVE,
            {"step": int(step), "blocked_s": round(blocked, 4),
             "storage": bool(block_on_busy)},
        )
        return blocked

    def _replicate(self) -> None:
        if self._replica is not None:
            # NOT best-effort: backup() is a collective, and a process that
            # skipped it would desynchronize the collective counts and
            # wedge every peer at the next exchange; a failure raises
            self._replica.backup()

    def _announce(self, step: int) -> None:
        """Advertise a committed shm step to the peer-restore broker."""
        if self._peer_restore:
            from dlrover_tpu_torch.trainer.flash_checkpoint import (
                peer_restore,
            )

            peer_restore.maybe_announce(
                step, scope=self._scope, process_id=self.process_id,
                num_processes=self.num_processes)

    @property
    def replica(self):
        """The replica manager (``replica.py``), or None."""
        return self._replica

    @property
    def peer_restore(self) -> bool:
        """Whether the engine serves and announces its segment and tries
        a peer recovery when the memory agreement fails."""
        return self._peer_restore

    @property
    def dist_persist(self) -> bool:
        """Whether storage saves take the distributed persist."""
        return self._dist_persist

    def _note_dist_ownership(self, state: Any, layout: Optional[Layout],
                             layouts: Optional[Sequence[Layout]]) -> None:
        """Refresh the ownership map a distributed-persist save event
        carries, from ``layouts`` (every process's layout of ``state``;
        ``None``: every leaf ``layout`` does not name is whole on every
        process).  Ownership depends only on the layouts, not the values,
        so the map stays valid when the saver relabels the event to a
        newer shm step of the same mesh, and is planned again only when
        ``layouts`` is another object or the state another structure (the
        Checkpointer passes the same list while both stay).  A map that
        cannot be planned logs a warning and this save takes the legacy
        persist, as the reference's does."""
        if not self._dist_persist:
            return
        from dlrover_tpu_torch.trainer.flash_checkpoint import distributed

        shape = snapshot.structure(state)
        done = self._dist_owned_for
        if layouts is not None and done is not None \
                and done[0] is layouts and done[1] == shape:
            return
        self._dist_owned_for = None
        try:
            self._dist_owned = distributed.owned_event_map(
                state, self.process_id, self.num_processes, layout, layouts
            )
        except Exception as e:  # noqa: BLE001 - falls back to legacy
            logger.warning(
                "distributed persist: ownership planning failed (%s); "
                "this save falls back to the legacy persist protocol", e,
            )
            self._dist_owned = None
            return
        self._dist_owned_for = (layouts, shape)

    def save_to_storage(
        self, step: int, state: Any, extras: Optional[Dict] = None,
        layout: Optional[Layout] = None,
        layouts: Optional[Sequence[Layout]] = None,
    ) -> float:
        """Snapshot to shm + async persist event; returns blocked secs.
        ``layouts``: every process's layout, which the distributed
        persist derives each shard's owner from (``_note_dist_ownership``).
        """
        self._check_layout(layout)
        self._note_dist_ownership(state, layout, layouts)
        return self._save_to_storage(step, state, extras, layout)

    def _save_to_storage(self, step, state, extras, layout) -> float:
        # record the durability promise BEFORE attempting the write: if
        # the save is dropped below, the exit barrier must see requested
        # > persisted and report the loss
        with self._persist_mu:
            self._persist_requested = max(self._persist_requested, int(step))
        blocked = self.save_to_memory(step, state, extras, block_on_busy=True,
                                      layout=layout)
        if blocked < 0:
            # the snapshot was not written (buffer-lock timeout): an event
            # now would persist stale data under this step's name
            self._reconcile_dropped_stage(step, persist=True)
            return blocked
        self._queue.put(self._save_event(step), timeout=60)
        with self._persist_mu:
            self._last_storage_step = max(self._last_storage_step, int(step))
        return blocked

    # -- async save --------------------------------------------------------

    def save_to_memory_async(
        self, step: int, state: Any, extras: Optional[Dict] = None,
        layout: Optional[Layout] = None,
    ) -> float:
        """Snapshot with enqueue-only blocking (see module docstring).

        Never skips: if a previous copy is still staging, a queued older
        memory snapshot is superseded, else this call waits (bounded) for
        the device-copy slot, else it saves synchronously — the recovery
        point always advances to this step.  Under replicas the save is
        synchronous: the replica exchange is a collective, and must not
        run on the stager's thread."""
        if self._replica is not None:
            return self.save_to_memory(step, state, extras, layout=layout)
        return self._async_save(step, state, extras, False, layout)

    def save_to_storage_async(
        self, step: int, state: Any, extras: Optional[Dict] = None,
        layout: Optional[Layout] = None,
        layouts: Optional[Sequence[Layout]] = None,
    ) -> float:
        """Storage save with enqueue-only blocking: the persist event is
        enqueued by the background thread AFTER the shm write, preserving
        the snapshot-before-event commit order.  ``layouts``: as
        ``save_to_storage``.  Synchronous under replicas, as
        ``save_to_memory_async``."""
        if self._replica is not None:
            return self.save_to_storage(step, state, extras, layout, layouts)
        self._check_layout(layout)
        self._note_dist_ownership(state, layout, layouts)
        return self._async_save(step, state, extras, True, layout)

    def _on_copy_freed(self):
        with self._copy_cv:
            self._live_copies -= 1
            self._copy_cv.notify_all()

    def _async_save(self, step, state, extras, persist: bool,
                    layout) -> float:
        self._check_layout(layout)
        self._raise_background_error()
        self._check_device(state)
        with record_function("flash.save"):
            return self._async_save_body(step, state, extras, persist,
                                         layout)

    def _sync_save(self, step, state, extras, persist: bool, layout,
                   block_on_busy: bool = False) -> float:
        if persist:
            # the ownership map was noted by the public save
            return self._save_to_storage(step, state, extras, layout)
        return self.save_to_memory(step, state, extras,
                                   block_on_busy=block_on_busy,
                                   layout=layout)

    def _sync_fallback(self, step, state, extras, persist: bool, layout,
                       block_on_busy: bool) -> float:
        """The async save's synchronous fallback (the recovery point still
        advances); recorded as such in ``save_paths``."""
        blocked = self._sync_save(step, state, extras, persist, layout,
                                  block_on_busy=block_on_busy)
        if self.save_paths and self.save_paths[-1] == (int(step), "sync"):
            self.save_paths[-1] = (int(step), "sync_fallback")
        return blocked

    def _async_save_body(self, step, state, extras, persist: bool,
                         layout) -> float:
        t0 = time.time()
        leaves = snapshot.plan_shards(state, layout)
        if snapshot.snapshot_nbytes(leaves) <= self._async_min_bytes:
            # small state: sync staging is ~free and leaves no window
            # where a crash right after save() loses the snapshot
            return self._sync_save(step, state, extras, persist, layout)
        # Never dispatch a second device copy while one is still live.  A
        # newer snapshot must NEVER lose to an older in-flight one, so when
        # the slot is held we (1) supersede a merely-QUEUED older memory
        # copy, (2) wait bounded for the slot, and (3) as a last resort
        # take the synchronous save path.
        sync_fallback = False
        # Not under _copy_cv: freeing the queued copy runs _on_copy_freed,
        # which locks _copy_cv from under the stager's own lock — taking
        # the two locks here in the opposite order would deadlock.
        if self._live_copies > 0:
            self._stager.drop_queued_memory()
        with self._copy_cv:
            if self._live_copies > 0:
                deadline = t0 + self._slot_wait_s
                while self._live_copies > 0:
                    left = deadline - time.time()
                    if left <= 0:
                        break
                    self._copy_cv.wait(left)
                sync_fallback = self._live_copies > 0
            if not sync_fallback:
                self._live_copies += 1
        if sync_fallback:
            logger.warning(
                "async %s save step=%d: previous device copy still "
                "live after %.0fs; sync fallback",
                "storage" if persist else "memory", step, self._slot_wait_s,
            )
            self._events.instant(
                TrainerEvents.CKPT_SYNC_FALLBACK,
                {"step": int(step), "storage": persist},
            )
            return self._sync_fallback(step, state, extras, persist,
                                       layout, block_on_busy=True)
        try:
            snap = self._device_copy(leaves)
        except torch.OutOfMemoryError as e:
            self._on_copy_freed()
            logger.warning(
                "on-device snapshot copy failed (%s); sync fallback", e
            )
            return self._sync_fallback(step, state, extras, persist,
                                       layout, block_on_busy=False)
        box = _DeviceCopy(snap, self._on_copy_freed)
        del snap, leaves
        if persist:
            with self._persist_mu:
                self._persist_requested = max(
                    self._persist_requested, int(step)
                )
        submitted = self._stager.submit(int(step), box, extras, persist)
        if submitted is not True:
            box.free()
            if submitted == "busy":
                # a queued storage snapshot blocks a fresher one: keep the
                # promise synchronously instead of dropping the newer state
                logger.warning(
                    "async %s save step=%d: stager busy; sync fallback",
                    "storage" if persist else "memory", step,
                )
                return self._sync_fallback(step, state, extras, persist,
                                           layout, block_on_busy=True)
            logger.warning(
                "async snapshot step=%d dropped: stager stopped", step
            )
            self.save_paths.append((int(step), "skipped"))
            return -1.0
        blocked = time.time() - t0
        self.save_paths.append((int(step), "async"))
        self._events.instant(
            TrainerEvents.CKPT_SAVE,
            {"step": int(step), "blocked_s": round(blocked, 4),
             "storage": persist, "async": True},
        )
        return blocked

    def _device_copy(self, leaves: List[Dict]) -> Dict:
        """Enqueue the copy of every leaf into the reused device buffer
        (fp32 cast to bf16 under the bf16 policy) on the current stream,
        then record an event.  Leaves that are not on the engine's device
        (the Python ints) are copied on the host.  The buffer's views are
        kept for the next save of a state of the same layout."""
        cast = self._snapshot_dtype == "bf16"
        layout = tuple(
            (leaf["path"], data.dtype, tuple(data.shape),
             data.device == self.device)
            for leaf in leaves for data in (leaf["shards"][0]["data"],))
        if self._copy_views is None or self._copy_views[0] != layout:
            self._copy_views = None
            self._copy_buf = None  # free the old buffer first
            self._copy_views = (layout, self._buffer_views(layout, cast))
        views = self._copy_views[1]
        copies = []
        with torch.no_grad():
            for leaf, view in zip(leaves, views):
                data = leaf["shards"][0]["data"]
                if view is None:
                    copy = data.clone()
                else:
                    copy = view
                    copy.copy_(data, non_blocking=True)
                copies.append({
                    "path": leaf["path"],
                    "dtype": snapshot.dtype_name(copy.dtype),
                    "gshape": leaf["gshape"],
                    "shards": [{"index": leaf["shards"][0]["index"],
                                "data": copy}],
                })
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return {"leaves": copies, "event": event}

    def _buffer_views(self, layout, cast: bool) -> List[Optional[torch.Tensor]]:
        """Allocate the device buffer for a layout; one view per leaf on
        the device (None for a host leaf), at aligned offsets."""
        spans, total = [], 0
        for _, dtype, shape, on_device in layout:
            if cast and dtype == torch.float32:
                dtype = torch.bfloat16
            if not on_device:
                spans.append(None)
                continue
            spans.append((total, dtype, shape))
            nbytes = math.prod(shape) * dtype.itemsize
            total += -(-nbytes // _COPY_ALIGN) * _COPY_ALIGN
        self._copy_buf = torch.empty(total, dtype=torch.uint8,
                                     device=self.device)
        return [None if span is None else
                self._copy_buf[span[0]:span[0] + math.prod(span[2])
                               * span[1].itemsize].view(span[1]).view(span[2])
                for span in spans]

    def _stage_snapshot(self, step, box, extras, persist: bool):
        """Stager thread body: stage the device copy into shm, maybe
        emit the persist event.

        Streaming (default): the shm layout is precomputed, the buffer
        lock is taken for the WHOLE stream, and each paced D2H chunk lands
        directly at its final offset.  Two-phase (opt-out): host-stage the
        whole copy first, then lock briefly for one packed write."""
        self._ensure_registered()
        snap = box.take()
        leaves, event = snap["leaves"], snap["event"]
        del snap
        if not self._stream_staging:
            with record_function("ckpt_device_to_host"):
                snapshot._to_host(leaves, throttled=True, pacer=None,
                                  wait_event=event)
            # the device copy is host-staged: free the slot so the next
            # async save may dispatch while we write shm
            box.free()
        persist_step = step if persist else None
        staged = False
        with self._buffer_write_lock(self._lock_timeout_s) as held:
            if held:
                try:
                    meta = snapshot.read_snapshot_meta(self._shm)
                    if meta and meta["step"] > step:
                        # a newer snapshot already landed (e.g. a sync-
                        # fallback save raced ahead of this stager item);
                        # overwriting would regress the recovery point.
                        # A persist item keeps its durability promise by
                        # persisting the NEWER content.
                        if persist:
                            persist_step = int(meta["step"])
                        logger.info(
                            "async snapshot step=%d obsolete (shm at "
                            "%d)%s", step, meta["step"],
                            "; persisting the newer snapshot"
                            if persist else "",
                        )
                        step = int(meta["step"])
                    elif not (meta and meta["step"] == step):
                        if self._stream_staging:
                            pacer = snapshot.StagePacer()
                            pacer.clock.staging_started()
                            try:
                                with record_function("ckpt_stream_stage"):
                                    snapshot.stream_snapshot(
                                        self._shm, step, leaves, extras,
                                        pacer=pacer, wait_event=event,
                                    )
                            finally:
                                pacer.clock.staging_finished()
                        else:
                            with record_function("ckpt_shm_write"):
                                snapshot.write_snapshot(
                                    self._shm, step, leaves, extras
                                )
                    staged = True
                finally:
                    del leaves
                    box.free()
        if not staged:
            box.free()
            self._reconcile_dropped_stage(step, persist)
            return
        self.latest_memory_step = max(self.latest_memory_step, step)
        self.last_staged_at = time.time()
        self._announce(step)
        if persist_step is not None:
            self._queue.put(self._save_event(persist_step), timeout=60)
            # only now is the persist in flight; the exit barrier may
            # safely wait on it
            with self._persist_mu:
                self._last_storage_step = max(
                    self._last_storage_step, persist_step
                )
        logger.info(
            "flash-ckpt async snapshot step=%d staged (training not "
            "blocked)", step,
        )

    def _reconcile_dropped_stage(self, step: int, persist: bool):
        """A staging item was dropped on the buffer-lock timeout.  For a
        memory snapshot that only ages the recovery point; for
        ``persist=True`` it breaks a durability promise: persist whatever
        committed snapshot the shm holds, without masking the failure —
        unless the shm snapshot is at or beyond the requested step,
        ``_persist_requested`` keeps the broken target and the exit
        barrier reports False."""
        logger.error(
            "snapshot step=%d: buffer busy after %.0fs; staging dropped",
            step, self._lock_timeout_s,
        )
        if not persist:
            return
        meta = snapshot.read_snapshot_meta(self._shm)
        got = int(meta["step"]) if meta is not None else -1
        with self._persist_mu:
            already_durable = got <= self._last_storage_step
        if meta is not None and not already_durable:
            self._queue.put(self._save_event(got), timeout=60)
            with self._persist_mu:
                self._last_storage_step = max(self._last_storage_step, got)
        if got >= step:
            return
        logger.error(
            "durability promise for step %d is BROKEN (buffer-lock "
            "timeout dropped the staging); %s — the exit barrier will "
            "report this failure", step,
            f"persisted the older shm snapshot at step {got} as a "
            "fallback" if got >= 0 else
            "no committed shm snapshot existed to persist in its place",
        )

    def _flush_async(self, timeout: float = 600.0) -> bool:
        """Wait for queued/in-flight background staging to finish."""
        return self._stager.flush(timeout)

    def _save_event(self, step: int) -> Dict:
        event = {
            "type": "save",
            "step": int(step),
            "shm": self._shm.name,
            "lock": self._lock_name,
            "ckpt_dir": self.checkpoint_dir,
            "process_id": self.process_id,
            "num_processes": self.num_processes,
        }
        if self._dist_persist and self._dist_owned is not None:
            event["dist"] = True
            event["owned"] = self._dist_owned
        return event

    def _ensure_registered(self):
        """Tell the agent-side saver about our shm so save-on-failure can
        persist snapshots that never saw a storage event.  Thread-safe:
        called from both the training thread and the async stager."""
        with self._register_mu:
            if self._registered:
                return
            self._queue.put(
                {
                    "type": "register",
                    "shm": self._shm.name,
                    "lock": self._lock_name,
                    "ckpt_dir": self.checkpoint_dir,
                    "process_id": self.process_id,
                    "num_processes": self.num_processes,
                    "step": -1,
                    # save-on-failure must speak the commit protocol the
                    # dir uses; with no ownership map the saver persists
                    # every local shard (extra bytes, a correct manifest)
                    "dist": self._dist_persist,
                },
                timeout=30,
            )
            self._registered = True

    # -- load --------------------------------------------------------------

    def _storage_step_candidates(self) -> List[int]:
        """Storage steps newest-first, the tracked step first."""
        candidates: List[int] = []
        tracked = read_tracker(self.checkpoint_dir, self._storage)
        if tracked is not None:
            candidates.append(tracked)
        for name in self._storage.listdir(self.checkpoint_dir):
            if name.isdigit() and int(name) not in candidates:
                candidates.append(int(name))
        candidates.sort(reverse=True)
        if tracked is not None and candidates and candidates[0] != tracked:
            candidates.remove(tracked)
            candidates.insert(0, tracked)
        return candidates

    def storage_leaf_sums(self, paths: List[str],
                          step: int) -> Optional[Dict[str, np.ndarray]]:
        """``{path: sum of the leaf over its leading axis}`` (fp32 numpy)
        for ``paths``, read from storage step ``step`` onto the host one
        leaf at a time, so the host holds one leaf's stack at once: the
        dp-stacked error-feedback residuals of ``Trainer.load_state`` (the
        reference's ``storage_leaves_to_host`` with the one transform its
        caller passes).

        ``step`` is the one a collective load already agreed on: scanning
        for another here could diverge the ranks.  Paths absent from the
        step are omitted (a dp shrink can make leaves shardable that the
        old degree never stored); a step holding none of them, or
        unreadable, gives None."""
        step_dir = os.path.join(self.checkpoint_dir, str(step))
        try:
            loaded = self._index_maps_from_storage(step_dir)
        except (ValueError, OSError, KeyError):
            return None
        if loaded is None:
            return None
        maps, _ = loaded
        present = [p for p in paths if p in maps]
        if not present:
            return None
        out = {}
        try:
            for p in present:
                stack = maps[p].read(tuple(slice(0, d)
                                           for d in maps[p].gshape))
                out[p] = np.asarray(stack.numpy(), np.float32).sum(axis=0)
        except (ValueError, OSError):
            return None
        return out

    def load(self, target: Any, layout: Optional[Layout] = None,
             layouts: Optional[Sequence[Layout]] = None,
             ) -> Tuple[Optional[Any], int]:
        """Restore ``(state, step)`` into ``target``: shm fast path,
        storage fallback; ``(None, -1)`` when there is no checkpoint.

        ``target`` is a state of the saved structure with its tensors on
        the engine's device (e.g. ``Trainer.create_state()``); ``layout``
        places its local tensors in their global leaves
        (``Trainer.state_layout``), and may differ from the layout saved:
        a storage restore reshards.  Its tensors are filled IN PLACE (cast
        to their own dtypes) and returned in a rebuilt tree whose ints
        (step, counts) are the checkpoint's.  Over a world of ranks the
        choice of shm, storage or a fresh start is agreed collectively
        (module docstring): every rank calls ``load``, with its
        ``layout`` (``_check_layout``).  A restore that fails after it
        began to fill the target raises rather than report "no
        checkpoint".  ``layouts``: every rank's layout of ``target``, from
        which a peer recovery names the replica group whose donors the
        broker lists first (``peer_restore._replica_group``)."""
        self._check_layout(layout)
        self._raise_background_error()
        self._check_device(target)
        from dlrover_tpu_torch.observability import metrics as obs_metrics
        from dlrover_tpu_torch.observability import trace

        t0, step_out = time.monotonic(), -1
        try:
            with trace.span("flash.restore") as sp, \
                    record_function("flash.load"):
                state, step_out = self._load(
                    target, target_boxes(target, layout), layouts)
                sp.set_attr("step", int(step_out))
            return state, step_out
        finally:
            obs_metrics.observe_ckpt_phase(
                "restore", time.monotonic() - t0, ok=step_out >= 0
            )

    def _load(self, target: Any, boxes: Dict,
              layouts: Optional[Sequence[Layout]] = None,
              ) -> Tuple[Optional[Any], int]:
        from dlrover_tpu_torch import chaos

        chaos.point("flash.restore")  # exception/delay kinds
        # a restore must see the latest snapshot, not race the stager
        self._flush_async()
        self._raise_background_error()
        # extras describe the checkpoint restored: a memory candidate that
        # loses the agreement must not leave its extras behind
        self.last_extras = {}
        self.last_read_stats = {}
        load_span = self._events.duration(TrainerEvents.CKPT_LOAD).begin()
        self.last_recovery = {}
        mem_step, maps, extras, gen0 = self._memory_candidate(boxes)
        agreed = self.agree_on_step(mem_step)
        if agreed < 0 and self._replica is not None:
            # a replaced process has an empty segment, and its successor
            # holds a replica: one collective exchange restores it, then
            # the memory agreement is retried.  The verdict above is the
            # same on every rank, so every rank makes the same collectives
            maps = None  # views of the segment the exchange may rewrite
            if self._replica.restore_from_peers():
                self._shm.close()
                self._shm = SharedMemoryBuffer(self._shm.name)
            mem_step, maps, extras, gen0 = self._memory_candidate(boxes)
            agreed = self.agree_on_step(mem_step)
        if agreed < 0 and self._peer_restore:
            # the lost shards from the survivors' segments into this one
            # (a survivor fetches nothing), then the agreement once more
            from dlrover_tpu_torch.trainer.flash_checkpoint import (
                peer_restore,
            )

            maps = None
            try:
                peer_restore.try_engine_recover(self, target, layouts)
            except Exception as e:  # noqa: BLE001 - the fast path must
                # never make a recovery worse than the storage restore
                logger.warning("peer restore failed (%s); using storage", e)
            mem_step, maps, extras, gen0 = self._memory_candidate(boxes)
            agreed = self.agree_on_step(mem_step)
        touched = False
        if agreed >= 0 and agreed == mem_step and maps is not None:
            with self._buffer_write_lock(60) as _held:
                # the maps are views of the shm itself: the seqlock
                # generation must not have moved by the end of the copies
                state = self._assemble(target, maps, boxes)
                moved = snapshot.read_generation(self._shm) != gen0
            # the verdict is agreed as well: one rank falling back to
            # storage alone would diverge the ranks
            if self.agree_on_step(-1 if moved else agreed) == agreed:
                self.last_extras = extras
                logger.info("restored step %d from shared memory", agreed)
                load_span.end(step=agreed, source="memory")
                return state, agreed
            logger.warning(
                "shm snapshot generation moved during the restore; "
                "restoring from storage instead"
            )
            touched = True
        maps = None  # drop the views of the shm before reading storage
        state, step = self._load_from_storage(target, boxes, touched)
        load_span.end(
            step=step, source="storage" if step >= 0 else "fresh"
        )
        return state, step

    def agree_on_step(self, step: int) -> int:
        """The step every process reports, when they all report the same
        non-negative one; else -1.  One ``all_gather`` of one int64 over
        the world (a CPU tensor under gloo, a CUDA one under NCCL)."""
        if self.num_processes <= 1:
            return step
        try:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if str(dist.get_backend()) == "nccl" else "cpu")
            mine = torch.tensor([int(step)], dtype=torch.int64,
                                device=device)
            gathered = [torch.empty_like(mine)
                        for _ in range(self.num_processes)]
            dist.all_gather(gathered, mine)
            steps = [int(t.item()) for t in gathered]
        except Exception as e:  # noqa: BLE001 - agreement must not crash
            logger.warning("restore agreement failed (%s); using storage", e)
            return -1
        if all(s == steps[0] for s in steps) and steps[0] >= 0:
            return steps[0]
        if max(steps) >= 0:
            logger.info("processes disagree on the restore step (%s)",
                        steps)
        return -1

    def _memory_candidate(self, boxes: Dict):
        """``(step, maps, extras, generation)``: this process's committed
        shm snapshot when it covers every target box, else
        ``(-1, None, {}, generation)``.  A pure read: the extras are kept
        only once the candidate wins the agreement."""
        with self._buffer_write_lock(60) as _held:
            # _held may be False when the saver is persisting: read
            # lock-free anyway; the seqlock generation check rejects a
            # torn read
            gen0 = snapshot.read_generation(self._shm)
            loaded = self._index_maps_from_shm()
        if loaded is None:
            return -1, None, {}, gen0
        maps, step, extras = loaded
        if not self._covers_all(boxes, maps):
            return -1, None, {}, gen0
        return int(step), maps, extras or {}, gen0

    def _index_maps_from_shm(self) -> Optional[Tuple[Dict, int, Dict]]:
        """Index maps over views of the committed shm snapshot (no
        copy); None when there is none or it is torn."""
        meta = snapshot.read_snapshot_meta(self._shm)
        if meta is None:
            return None
        maps: Dict[str, ShardIndexMap] = {}
        for leaf in meta["leaves"]:
            m = ShardIndexMap(leaf["dtype"], leaf["gshape"])
            for shard_meta in leaf["shards"]:
                m.add(shard_meta["index"],
                      snapshot.shard_view(self._shm, shard_meta,
                                          leaf["dtype"]))
            maps[leaf["path"]] = m
        return maps, meta["step"], meta.get("extras", {})

    def _try_dist_restore(self, target, boxes: Dict, floor: int):
        """Restore from a sealed distributed commit when one exists and is
        at least as new as the best legacy candidate (``floor``).  Returns
        ``(state, step, touched)``: ``(None, -1, touched)`` to fall
        through, ``touched`` when a failed restore had begun to fill the
        target.  The sealed COMMITTED pointer is job-global, but over a
        world the dist-vs-legacy CHOICE is agreed all the same (a
        shared-FS race on the pointer could send some ranks here and
        others to the legacy scan): one agreement on every rank,
        unconditionally, so collective counts stay equal."""
        from dlrover_tpu_torch.trainer.flash_checkpoint import distributed

        try:
            dist_step = distributed.read_committed_step(
                self.checkpoint_dir, self._storage)
        except Exception:  # noqa: BLE001 - a probe must not kill restore
            dist_step = -1
        probe = dist_step if 0 <= floor <= dist_step else -1
        if self.num_processes > 1:
            probe = self.agree_on_step(probe)
        if probe < 0:
            return None, -1, False
        engine = distributed.DistributedCheckpointEngine(
            self.checkpoint_dir, process_id=self.process_id,
            num_processes=self.num_processes, storage=self._storage)
        try:
            state, step = engine.load_boxes(target, boxes, step=probe)
        except (OSError, ValueError, KeyError) as e:
            if self.num_processes > 1:
                # the agreement already happened: one rank falling back
                # alone would diverge the ranks
                raise
            logger.error(
                "distributed restore of sealed step %d failed (%s); "
                "falling back to legacy step candidates", probe, e,
            )
            return None, -1, engine.fill_started
        if state is not None:
            self.last_extras = engine.last_extras
            self.last_read_stats = engine.last_read_stats
            logger.info(
                "restored step %d from a distributed commit (read "
                "%.1f/%.1f MB)", step,
                engine.last_read_stats.get("bytes_read", 0) / 1e6,
                engine.last_read_stats.get("bytes_total", 0) / 1e6,
            )
        return state, step, False

    def _load_from_storage(self, target, boxes: Dict, touched: bool):
        # tracked step first, then older committed steps as fallbacks if
        # the tracked one is unreadable (partially deleted / corrupted)
        candidates = self._storage_step_candidates()
        # a sealed distributed commit at or past the best legacy step
        # wins: with DLROVER_TPU_DIST_PERSIST the shards/manifests/
        # COMMITTED layout is the only place new saves land
        state, step, dist_touched = self._try_dist_restore(
            target, boxes, floor=candidates[0] if candidates else 0)
        if state is not None:
            return state, step
        touched = touched or dist_touched
        excluded: set = set()
        while True:
            # this process's newest fully covering step, then ONE
            # agreement: a fixed collective count per load (the retry below
            # re-enters only for a single process, whose agreement is local)
            best_step, best_maps, best_extras = -1, None, {}
            for step in candidates:
                if step in excluded:
                    continue
                step_dir = os.path.join(self.checkpoint_dir, str(step))
                try:
                    loaded = self._index_maps_from_storage(step_dir)
                except (ValueError, OSError, KeyError) as e:
                    logger.warning(
                        "checkpoint step %d unreadable (%s)", step, e
                    )
                    continue
                if loaded is None:
                    continue
                maps, extras = loaded
                if self._covers_all(boxes, maps):
                    best_step, best_maps, best_extras = step, maps, extras
                    break
            agreed = self.agree_on_step(best_step)
            if agreed < 0 or agreed != best_step or best_maps is None:
                # nothing here, or the processes disagree (a shared-FS
                # race, one host's corruption): every one starts fresh
                if best_step >= 0 or agreed >= 0:
                    logger.warning(
                        "storage restore not agreed (mine=%d agreed=%d); "
                        "starting fresh", best_step, agreed,
                    )
                if touched:
                    raise RuntimeError(
                        "flash checkpoint restore failed after it had "
                        "begun to fill the target state, and no older "
                        "checkpoint is readable: the target is not a "
                        "consistent state")
                self.last_extras = {}
                return None, -1
            try:
                state = self._assemble(target, best_maps, boxes)
            except (OSError, ValueError) as e:
                # lazy reads surfaced corruption (CRC mismatch, vanished
                # range) only at assembly.  One process falls back to the
                # next older candidate, which overwrites every leaf again;
                # over a world the agreement already happened, and one
                # rank falling back alone would diverge the ranks
                if self.num_processes > 1:
                    raise
                logger.error(
                    "checkpoint step %d failed integrity checks at "
                    "assembly (%s); trying an older step", best_step, e,
                )
                touched = True
                excluded.add(best_step)
                continue
            self.last_extras = best_extras
            logger.info("restored step %d from storage", best_step)
            return state, best_step

    @staticmethod
    def _covers_all(boxes: Dict, maps: Dict) -> bool:
        """Whether the stored shards cover every target leaf's box on this
        rank, in a leaf of the same global shape."""
        for path, (gshape, box) in boxes.items():
            index_map = maps.get(path)
            if index_map is None:
                return False
            if [int(d) for d in index_map.gshape] != gshape:
                # a different tensor, not a resharding: a dp-stacked
                # residual saved at another dp degree may well cover a
                # smaller target's rows, and assembling that corner would
                # be silent corruption
                return False
            if not index_map.covers(tuple(slice(a, b) for a, b in box)):
                return False
        return True

    def _verify_chunks(self, bin_path: str, chunks: List[Dict]):
        """Check recorded per-chunk CRC32s against the stored payload
        (eager mode: whole payload at probe time).  A mismatch raises
        OSError — rejecting the candidate at probe time."""
        for chunk in chunks:
            off, n = int(chunk["offset"]), int(chunk["nbytes"])
            data = self._storage.read_range(bin_path, off, n)
            if data is None or len(data) != n:
                raise OSError(f"chunk vanished: {bin_path}@{off}+{n}")
            crc = zlib.crc32(memoryview(np.ascontiguousarray(data)))
            if crc != int(chunk["crc32"]):
                raise OSError(
                    f"chunk checksum mismatch: {bin_path}@{off}+{n} "
                    f"(stored {chunk['crc32']:#010x}, got {crc:#010x})"
                )

    def _index_maps_from_storage(self, step_dir: str):
        import json

        metas = [
            f for f in self._storage.listdir(step_dir)
            if f.startswith("meta_") and f.endswith(".json")
        ]
        if not metas:
            return None
        crc_mode = envs.get_str("DLROVER_TPU_VERIFY_CRC").lower()
        maps: Dict[str, ShardIndexMap] = {}
        extras: Dict = {}
        for meta_file in metas:
            raw = self._storage.read(os.path.join(step_dir, meta_file))
            if raw is None:
                raise OSError(f"meta file vanished: {meta_file}")
            meta = json.loads(raw)
            if meta.get("extras"):
                extras = meta["extras"]
            bin_path = os.path.join(step_dir, meta["bin_file"])
            # missing or TRUNCATED payloads must lose at probe time
            blob_size = self._storage.size(bin_path)
            if blob_size is None:
                raise OSError(f"shard payload missing: {bin_path}")
            needed = max(
                (
                    int(s["offset"]) + int(s["nbytes"])
                    for leaf in meta["leaves"]
                    for s in leaf["shards"]
                ),
                default=0,
            )
            if blob_size < needed:
                raise OSError(
                    f"shard payload truncated: {bin_path} has "
                    f"{blob_size} bytes, needs {needed}"
                )
            # CRC32s: "eager" verifies the recorded writer chunks over the
            # whole payload at probe time; "lazy" (default) verifies each
            # shard's own CRC against exactly the bytes its read fetches
            chunk_list = meta.get("chunks") or []
            if chunk_list and crc_mode == "eager":
                self._verify_chunks(bin_path, chunk_list)
            lazy_verify = crc_mode == "lazy"
            for leaf in meta["leaves"]:
                m = maps.setdefault(
                    leaf["path"], ShardIndexMap(leaf["dtype"], leaf["gshape"])
                )
                for shard_meta in leaf["shards"]:
                    def load(
                        _path=bin_path,
                        _start=shard_meta["offset"],
                        _nbytes=shard_meta["nbytes"],
                        _dtype=leaf["dtype"],
                        _shape=tuple(shard_meta["shape"]),
                        _crc=(
                            shard_meta.get("crc32")
                            if lazy_verify else None
                        ),
                    ):
                        buf = self._storage.read_range(
                            _path, _start, _nbytes
                        )
                        if buf is None:
                            raise OSError(
                                f"shard payload vanished: {_path}"
                            )
                        if _crc is not None:
                            got = zlib.crc32(memoryview(
                                np.ascontiguousarray(buf)
                            ))
                            if got != int(_crc):
                                raise OSError(
                                    "shard checksum mismatch: "
                                    f"{_path}@{_start}+{_nbytes} (stored "
                                    f"{int(_crc):#010x}, got {got:#010x})"
                                )
                        return snapshot.tensor_from_bytes(buf, _dtype, _shape)

                    m.add_lazy(shard_meta["index"], load)
        return maps, extras

    @staticmethod
    def _assemble(target, maps: Dict, boxes: Dict):
        """Fill the target's tensors in place, each from the stored shard
        of exactly its box or else from the slices of the shards it
        overlaps (host-to-device copies, cast to each tensor's dtype);
        ints come back as the checkpoint's."""

        def fill(path, leaf):
            index_map = maps.get(path)
            if index_map is None:
                raise ValueError(f"checkpoint missing leaf {path}")
            box = boxes[path][1]
            src = index_map.exact(box)
            if src is None:
                src = index_map.read(tuple(slice(a, b) for a, b in box))
            if isinstance(leaf, torch.Tensor):
                with torch.no_grad():
                    leaf.copy_(src.reshape(leaf.shape))
                return leaf
            return type(leaf)(src.reshape(()).item())

        return map_with_path(fill, target)

    # -- misc --------------------------------------------------------------

    def latest_step(self) -> int:
        """Max of shm step and storage tracker."""
        self._flush_async()
        mem = -1
        meta = snapshot.read_snapshot_meta(self._shm)
        if meta:
            mem = meta["step"]
        disk = read_tracker(self.checkpoint_dir, self._storage)
        return max(mem, disk if disk is not None else -1)

    def wait_saving_complete(self, timeout: float = 600.0) -> bool:
        """Block until the saver persisted this process's latest storage
        save (exit barrier).  False on a timeout or a dropped persist;
        raises when the stager or the in-process saver failed."""
        deadline = time.time() + timeout
        # an async storage save only enqueues its persist event once the
        # stager finishes; the barrier must wait for that first
        if not self._flush_async(timeout):
            logger.warning(
                "exit barrier timed out waiting for snapshot staging"
            )
            return False
        self._raise_background_error()
        with self._persist_mu:
            requested = self._persist_requested
            target = self._last_storage_step
        if target < requested:
            # a requested persist never made it to the event queue (lock
            # timeout): that checkpoint is gone — report failure now
            logger.error(
                "async storage save step=%d was dropped (persisted "
                "through step %d)", requested, target,
            )
            return False
        if self._local_saver is not None:
            if not self._local_saver.wait_idle(
                    max(0.0, deadline - time.time())):
                return False
            self._raise_background_error()
            # idle is not durable: the step must have committed
            if target < 0 or self._local_saver.persisted_step(
                    self.process_id) >= target:
                return True
            logger.error("saver idle, but step %d was not persisted",
                         target)
            return False
        while time.time() < deadline:
            try:
                done = self._progress.get(str(self.process_id))
            except (TimeoutError, RuntimeError):  # agent may be gone
                done = None
            if target < 0 or (done is not None and done >= target):
                return True
            time.sleep(0.5)
        return False

    def close(self):
        """Stop the stager, the in-process saver and the peer endpoint
        this engine started, release the device copy buffer, the lock and
        the mappings (the segments stay: see ``unlink_memory``)."""
        if self._peer_endpoint is not None:
            from dlrover_tpu_torch.trainer.flash_checkpoint import (
                peer_restore,
            )

            peer_restore.release_endpoint(self._peer_endpoint)
            self._peer_endpoint = None
        if self._replica is not None:
            self._replica.close()
        stopped = self._stager.stop(timeout=60)
        saver_idle = True
        if self._local_saver is not None:
            self._local_saver.stop()
            saver_idle = self._local_saver.idle()
            self._queue.close()
        self._copy_views = None
        self._copy_buf = None
        if stopped and saver_idle:
            # a persist still in flight releases this lock when it ends
            self._lock.close()
        self._forget_shm_provider()
        if stopped:
            self._shm.close()
        else:
            # the stager thread may still be writing the buffer; leaking
            # the mapping beats a use-after-close crash in that thread
            logger.warning(
                "stager still staging at close(); leaving shm mapped"
            )

    def unlink_memory(self):
        """Drop the shm snapshot and the replica this process keeps of
        its predecessor's (call after a clean job completion — leaving
        them would make a future unrelated run 'resume')."""
        if self._replica is not None:
            self._replica.unlink_backup()
        self._forget_shm_provider()
        if not self._shm.attach():
            return
        self._shm.unlink()

    def _forget_shm_provider(self):
        try:
            from dlrover_tpu_torch.observability import memscope

            memscope.scope().deregister_host_provider(
                f"ckpt_shm:{self._shm.name}")
        except Exception:  # noqa: BLE001 - telemetry only
            pass
