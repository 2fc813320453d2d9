"""Checkpoint storage abstraction + deletion strategies.

Copy of ``dlrover_tpu/common/storage.py`` (``CheckpointStorage``,
``PosixDiskStorage``, ``write_chunks``/``chunk_spans`` and the deletion
strategies), with its chaos points ``storage.write`` and
``storage.write_chunk``.  The agent's async saver talks only to this
interface.  Left out: the fsspec backend for URL paths (ROADMAP queue 1
item 7): ``get_checkpoint_storage`` refuses a URL path.
"""

import os
import shutil
import uuid
import zlib
from abc import ABC, abstractmethod
from typing import Dict, List, Optional

from dlrover_tpu_torch import chaos
from dlrover_tpu_torch.common.log import logger


def _chaos_write(path: str):
    """``storage.write`` chaos point: delay = slow NFS/GCS stall,
    exception = transport failure; ``torn_write``/``drop`` are returned
    for the write implementations to act on (truncate the payload /
    skip the write)."""
    return chaos.point("storage.write", path=path)


def _chaos_chunk(content, path: str, offset: int):
    """``storage.write_chunk`` chaos point, fired per persist chunk.
    ``torn_write`` corrupts the chunk bytes ON DISK while the CRC
    record still describes the intended bytes — exactly what a torn
    page-cache writeback looks like to a later restore.  The chunk is
    only copied when a fault actually fires."""
    fault = chaos.point("storage.write_chunk", path=path, offset=offset)
    if fault is not None and fault.kind == chaos.TORN_WRITE:
        torn = bytearray(content)
        # flip the middle byte: detectable by CRC, invisible to size
        # checks — the silent-corruption shape CRC verification exists
        # for
        if torn:
            torn[len(torn) // 2] ^= 0xFF
        return bytes(torn)
    return content


def chunk_spans(total: int, chunk_bytes: int) -> List[tuple]:
    """[(offset, nbytes), ...] covering [0, total) in fixed-size chunks
    (the last one ragged).  Shared by writers and CRC verifiers so both
    sides always agree on chunk boundaries."""
    chunk_bytes = max(1, int(chunk_bytes))
    return [
        (off, min(chunk_bytes, total - off))
        for off in range(0, total, chunk_bytes)
    ]


class CheckpointDeletionStrategy(ABC):
    @abstractmethod
    def clean_up(self, step: int, delete_func):
        """Given a newly committed step, delete obsolete checkpoint dirs."""


class KeepLatestStepStrategy(CheckpointDeletionStrategy):
    """Keep only the newest ``max_to_keep`` step directories."""

    def __init__(self, max_to_keep: int, checkpoint_dir: str):
        self._max_to_keep = max(1, max_to_keep)
        self._checkpoint_dir = checkpoint_dir
        self._steps: List[int] = []

    def clean_up(self, step: int, delete_func):
        if step in self._steps:
            return
        self._steps.append(step)
        self._steps.sort()
        while len(self._steps) > self._max_to_keep:
            rm_step = self._steps.pop(0)
            delete_func(os.path.join(self._checkpoint_dir, str(rm_step)))


class KeepStepIntervalStrategy(CheckpointDeletionStrategy):
    """Keep steps that are multiples of ``keep_interval``, delete the rest."""

    def __init__(self, keep_interval: int, checkpoint_dir: str):
        self._keep_interval = max(1, keep_interval)
        self._checkpoint_dir = checkpoint_dir

    def clean_up(self, step: int, delete_func):
        if step % self._keep_interval == 0:
            return
        delete_func(os.path.join(self._checkpoint_dir, str(step)))


class CheckpointStorage(ABC):
    """write/read primitives + commit marker used by the async saver."""

    @abstractmethod
    def write(self, content, path: str):
        ...

    @abstractmethod
    def write_bytes(self, content: bytes, path: str):
        ...

    def write_atomic(self, content, path: str):
        """Write ``path`` so readers never see a torn PREFIX of the new
        content.  The base implementation stages to a tmp name and
        moves; its atomicity is only as good as the backend's
        remove+move (a crash between them can leave the file missing —
        recoverable, unlike a half-written step number).  Both shipped
        backends override with genuinely atomic primitives: posix with
        fsync + rename, fsspec with a single-object PUT."""
        tmp = f"{path}.tmp.{uuid.uuid4().hex[:8]}"
        self.write(content, tmp)
        self.safe_move_replace(tmp, path)

    def safe_move_replace(self, src_path: str, dst_path: str):
        """Move that REPLACES an existing destination (the atomic-write
        commit step; plain ``safe_move`` refuses to overwrite)."""
        self.safe_remove(dst_path)
        self.safe_move(src_path, dst_path)

    def write_chunks(
        self, content, path: str, chunk_bytes: int, writers: int = 1
    ) -> List[Dict]:
        """Write ``content`` (bytes-like/memoryview) to ``path`` in
        fixed-size chunks, returning per-chunk integrity records
        ``[{"offset", "nbytes", "crc32"}, ...]``.

        The base implementation streams sequentially through one handle
        — correct for object stores, which lack random writes (a
        concurrent multipart upload would slot in here).  Posix
        overrides with a parallel positional-write pool.

        Chaos parity with the posix pool: the whole-payload
        ``storage.write`` point fires FIRST (same call ordering), a DROP
        returns intact CRC records with nothing on the store (lost
        PUT), and a TORN_WRITE uploads only the first half of the
        payload (killed mid-upload leaves a truncated object — restore's
        size probe catches it, where posix leaves a full-size file with
        zeroed tail for the CRC probe).  Per-chunk ``storage.
        write_chunk`` faults corrupt chunk bytes while records stay
        intact, identically to posix."""
        fault = _chaos_write(path)
        view = memoryview(content).cast("B")
        total = len(view)
        records: List[Dict] = []
        out = view
        for off, n in chunk_spans(total, chunk_bytes):
            records.append({
                "offset": off,
                "nbytes": n,
                "crc32": zlib.crc32(view[off : off + n]),
            })
            if chaos.is_active():
                # same per-chunk injection point as the posix pool, so a
                # chaos plan behaves identically across backends
                mv = view[off : off + n]
                torn = _chaos_chunk(mv, path, off)
                if torn is not mv:
                    if out is view:
                        out = bytearray(view)
                    out[off : off + n] = torn
        if fault is not None and fault.kind == chaos.DROP:
            # injected lost PUT: intact CRC records, nothing stored
            return records
        if fault is not None and fault.kind == chaos.TORN_WRITE:
            out = memoryview(out).cast("B")[: max(1, total // 2)]
        self._write_payload(out, path)
        return records

    def _write_payload(self, content, path: str):
        """Raw single-object write used by the base ``write_chunks`` —
        the whole-payload chaos point already fired there, so backends
        whose ``write`` injects faults override this with a fault-free
        write to avoid double-charging the chaos schedule."""
        self.write_bytes(content, path)

    @abstractmethod
    def read(self, path: str, mode: str = "r"):
        ...

    def read_binary(self, path: str):
        """Shard payload as a uint8 buffer (np.ndarray/memmap) or None.

        Posix maps the file (zero-copy restore); remote backends read the
        object into memory."""
        data = self.read(path, mode="rb")
        if data is None:
            return None
        import numpy as np

        return np.frombuffer(data, dtype=np.uint8)

    def read_range(self, path: str, offset: int, nbytes: int):
        """One shard's byte range as a uint8 buffer, or None.

        Restore reads ONLY the ranges its target sharding needs through
        this — a resharded multi-host restore must not pull every hosts'
        full blobs (posix memmaps lazily; object stores use ranged GETs)."""
        blob = self.read_binary(path)
        if blob is None:
            return None
        return blob[offset : offset + nbytes]

    def size(self, path: str) -> Optional[int]:
        """Object size in bytes, or None if missing.  Lets restore detect
        TRUNCATED payloads (killed writer, partial upload) at candidate-
        probe time, where falling back to an older step is still possible."""
        data = self.read(path, mode="rb")
        return None if data is None else len(data)

    @abstractmethod
    def safe_rmtree(self, dir_path: str):
        ...

    @abstractmethod
    def safe_remove(self, path: str):
        ...

    @abstractmethod
    def safe_makedirs(self, dir_path: str):
        ...

    @abstractmethod
    def safe_move(self, src_path: str, dst_path: str):
        ...

    @abstractmethod
    def commit(self, step: int, success: bool):
        """Called once a whole step's shards are persisted."""

    @abstractmethod
    def exists(self, path: str) -> bool:
        ...

    @abstractmethod
    def listdir(self, path: str) -> List[str]:
        ...


class PosixDiskStorage(CheckpointStorage):
    """Local disk / NFS / FUSE-mounted GCS storage."""

    def __init__(
        self,
        deletion_strategy: Optional[CheckpointDeletionStrategy] = None,
    ):
        self._deletion_strategy = deletion_strategy
        self._mmap_cache: dict = {}

    def write(self, content, path: str):
        fault = _chaos_write(path)
        if fault is not None and fault.kind == chaos.DROP:
            return  # injected silent write loss
        self.safe_makedirs(os.path.dirname(path))
        mode = "wb" if isinstance(content, (bytes, bytearray, memoryview)) else "w"
        if fault is not None and fault.kind == chaos.TORN_WRITE:
            content = content[: max(1, len(content) // 2)]
        with open(path, mode) as f:
            f.write(content)
            f.flush()
            os.fsync(f.fileno())

    def write_bytes(self, content: bytes, path: str):
        self.write(content, path)

    def write_atomic(self, content, path: str):
        """tmp + fsync + rename: a crash at any point leaves either the
        complete old file or the complete new one (rename is atomic on
        posix), never a torn prefix — the tracker-file requirement."""
        self.safe_makedirs(os.path.dirname(path))
        tmp = f"{path}.tmp.{uuid.uuid4().hex[:8]}"
        mode = (
            "wb" if isinstance(content, (bytes, bytearray, memoryview))
            else "w"
        )
        try:
            with open(tmp, mode) as f:
                f.write(content)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise

    def write_chunks(
        self, content, path: str, chunk_bytes: int, writers: int = 1
    ) -> List[Dict]:
        """Parallel positional writes: the file is pre-sized, then
        ``writers`` threads pwrite disjoint chunks concurrently (pwrite
        releases the GIL, so page-cache memcpys genuinely overlap) while
        each computes its chunk's CRC32.  One fsync at the end."""
        fault = _chaos_write(path)
        view = memoryview(content).cast("B")
        total = len(view)
        spans = chunk_spans(total, chunk_bytes)
        if fault is not None and fault.kind == chaos.DROP:
            # injected silent write loss: return intact CRC records with
            # NOTHING on disk — restore's size/CRC probes must catch it
            return [
                {"offset": off, "nbytes": n,
                 "crc32": zlib.crc32(view[off : off + n])}
                for off, n in spans
            ]
        # torn_write at whole-payload granularity: the file keeps its
        # full size (pre-truncated) but bytes past the midpoint never
        # land — what a killed writer leaves behind.  Per-chunk
        # corruption is the `storage.write_chunk` point's job.
        write_limit = (
            max(1, total // 2)
            if fault is not None and fault.kind == chaos.TORN_WRITE
            else total
        )
        self.safe_makedirs(os.path.dirname(path))
        fd = os.open(path, os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o644)
        try:
            if total:
                os.ftruncate(fd, total)

            def _write_one(span) -> Dict:
                off, n = span
                mv = view[off : off + n]
                crc = zlib.crc32(mv)
                data = _chaos_chunk(mv, path, off) if \
                    chaos.is_active() else mv
                written = 0
                limit = max(0, min(n, write_limit - off))
                while written < limit:
                    written += os.pwrite(
                        fd, data[written:limit], off + written
                    )
                return {"offset": off, "nbytes": n, "crc32": crc}

            if writers <= 1 or len(spans) <= 1:
                records = [_write_one(s) for s in spans]
            else:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(
                    max_workers=min(writers, len(spans)),
                    thread_name_prefix="ckpt-chunk",
                ) as pool:
                    records = list(pool.map(_write_one, spans))
            os.fsync(fd)
        finally:
            os.close(fd)
        return records

    def read(self, path: str, mode: str = "r"):
        if not os.path.exists(path):
            return None
        with open(path, mode) as f:
            return f.read()

    def safe_rmtree(self, dir_path: str):
        try:
            shutil.rmtree(dir_path, ignore_errors=True)
        except OSError as e:  # pragma: no cover
            logger.warning("rmtree %s failed: %s", dir_path, e)

    def safe_remove(self, path: str):
        try:
            if os.path.exists(path):
                os.remove(path)
        except OSError as e:  # pragma: no cover
            logger.warning("remove %s failed: %s", path, e)

    def safe_makedirs(self, dir_path: str):
        if dir_path:
            os.makedirs(dir_path, exist_ok=True)

    def safe_move(self, src_path: str, dst_path: str):
        try:
            if os.path.exists(src_path) and not os.path.exists(dst_path):
                shutil.move(src_path, dst_path)
        except OSError as e:  # pragma: no cover
            logger.warning("move %s -> %s failed: %s", src_path, dst_path, e)

    def commit(self, step: int, success: bool):
        if success and self._deletion_strategy:
            self._deletion_strategy.clean_up(step, self.safe_rmtree)

    def read_binary(self, path: str):
        import numpy as np

        try:
            return np.memmap(path, dtype=np.uint8, mode="r")
        except (OSError, ValueError):
            return None

    def read_range(self, path: str, offset: int, nbytes: int):
        # cache the memmap per path: restores issue one read per shard,
        # and a fresh mmap+fd per read would exhaust descriptors.  The
        # cache key includes (mtime, size) — a re-saved step replaces the
        # file at the same path and a stale mapping of the old inode
        # would silently restore old tensor data.
        try:
            st = os.stat(path)
            stamp = (st.st_mtime_ns, st.st_size)
        except OSError:
            return None
        cached = self._mmap_cache.get(path)
        if cached is None or cached[0] != stamp:
            mm = self.read_binary(path)
            if mm is None:
                return None
            if len(self._mmap_cache) > 64:
                self._mmap_cache.clear()
            self._mmap_cache[path] = (stamp, mm)
        else:
            mm = cached[1]
        return mm[offset : offset + nbytes]

    def size(self, path: str) -> Optional[int]:
        try:
            return os.path.getsize(path)
        except OSError:
            return None

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def listdir(self, path: str) -> List[str]:
        try:
            return sorted(os.listdir(path))
        except OSError:
            return []


def refuse_url_path(path: str) -> None:
    """Raise for a URL checkpoint dir (gs://..., s3://...): the
    reference's fsspec backend is not ported."""
    if "://" in (path or ""):
        raise NotImplementedError(
            f"checkpoint dir {path!r} is a URL: the fsspec storage backend "
            "is not ported yet (ROADMAP queue 1 item 7)")


def get_checkpoint_storage(
    deletion_strategy: Optional[CheckpointDeletionStrategy] = None,
    path: str = "",
) -> CheckpointStorage:
    """Local/NFS posix storage; a URL path raises."""
    refuse_url_path(path)
    return PosixDiskStorage(deletion_strategy)
