"""Host snapshots of the train state: the shm staging format.

Port of ``dlrover_tpu/trainer/flash_checkpoint/snapshot.py``.  Each process
copies the tensors of its train state into one POSIX shared-memory segment.
The layout is byte-compatible with the reference's::

    [0:8)    meta length (big-endian u64); 0 = no committed snapshot
    [8:16)   generation (big-endian u64); odd = write in progress / torn
    [16:16+L) meta JSON: step, extras, per-leaf dtype/global-shape and
             per-shard global index + byte offset
    [...]    raw shard bytes, C-contiguous

Dtype strings are the reference's numpy names (``"float32"``,
``"bfloat16"``, ...), mapped to torch dtypes by a table; bytes move as
``uint8`` views, so bf16 needs no numpy extension type.  Leaves are keyed by
the port's own paths (``common/pytree.py``), such as
``params/layers.0.attn.q_proj.weight``.

The device side is the port's own.  Each rank writes its own local tensors
into its own segment.  A leaf that ``layout`` names (``{path: (global shape,
index box)}``, from ``Trainer.state_layout``) is one shard of that global
shape at that box: an FSDP2 shard, a Megatron tp shard, a ZeRO-1 moment
chunk, or a rank's row ``[r, r + 1)`` of the dp-stacked error-feedback
residual.  Any other tensor is one shard whose index is the whole tensor,
``[[0, d], ...]``: a replicated leaf is written by every rank, as the
reference's per-process path does.  A Python int of the state (the step, an
optimizer count) is a 0-d ``int64`` leaf.

Two write paths share the format:

- ``write_snapshot``: the two-phase path.  ``extract_host_shards`` copies
  every tensor device-to-host with ``non_blocking=True`` into pinned memory
  and synchronizes once; ``write_snapshot`` then packs the host tensors into
  shm.
- ``plan_shards`` + ``stream_snapshot``: the streaming path.  The layout is
  computed from shapes before any transfer; each shard goes device-to-host
  in pacer-sized chunks on a side CUDA stream into one of two pinned bounce
  buffers, and from there into shm at the chunk's final offset while the
  next chunk's transfer runs.  That is one host copy per chunk (the
  zero-copy invariant, counted through ``set_copy_observer``).

Every host copy is a torch ``copy_`` between CPU tensors, one of them a view
of the shm buffer: it runs on torch's threads with the GIL released.  Both
paths run the seqlock-style generation commit: the generation word goes ODD
before any byte of meta or payload changes and back to EVEN only after the
meta length is restored.  A writer killed mid-stream leaves an odd
generation; readers treat that as "no snapshot".
"""

import json
import math
import struct
import time
import warnings
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np
import torch

from dlrover_tpu_torch.chaos import point as _chaos_point
from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.multi_process import SharedMemoryBuffer
from dlrover_tpu_torch.common.pytree import flatten_with_path

# shm prefix layout (see module docstring).  _HEADER is the meta-length
# word: zeroing it invalidates the snapshot (tests rely on that).
_HEADER = 8
_GEN_OFF = 8
_META_OFF = 16

_MIN_CHUNK = 1 << 20  # 1 MiB: below this, per-transfer overhead dominates
_MAX_CHUNK = 256 << 20
_DEFAULT_CHUNK = 8 << 20
# Step baselines below this are not real device step times: a loop that
# never blocks on device results dispatches steps in microseconds, and
# pacing against that collapsed baseline would read routine scheduler
# jitter as "inflation" and throttle staging to a crawl.  Below the
# floor the pacer runs unpaced instead.
_MIN_BASELINE_S = 0.005

# where each named leaf's local tensor sits in its global tensor: path ->
# (global shape, index box [[start, stop], ...] per dim)
Layout = Mapping[str, Tuple[Sequence[int], Sequence[Sequence[int]]]]

# the reference's dtype names (numpy's) for the torch dtypes a state holds
DTYPE_NAMES = {
    torch.float32: "float32", torch.float64: "float64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
    torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
}
TORCH_DTYPES = {name: dtype for dtype, name in DTYPE_NAMES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    try:
        return DTYPE_NAMES[dtype]
    except KeyError:
        raise ValueError(f"no snapshot dtype name for {dtype}") from None


def torch_dtype(name: str) -> torch.dtype:
    try:
        return TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"snapshot dtype {name!r} has no torch dtype") \
            from None


class StagePacer:
    """Closed-loop throttle for background device->host staging.

    Transfers are CHUNKED so a concurrently dispatched train step ever
    waits behind at most one chunk, and the chunk size is chosen from the
    measured link bandwidth and the observed step-time baseline so that
    the wait stays within ``(factor - 1)`` of a step (default factor 1.5,
    env ``DLROVER_TPU_STAGE_FACTOR``).  Observed step inflation then trims
    the chunk size and inserts duty-cycle sleeps if the bound is still
    exceeded; when the step clock reports training idle, staging runs at
    full speed with maximal chunks.  ``DLROVER_TPU_STAGE_PACE`` (sleep =
    pace x transfer time between chunks) is a manual override.
    """

    # fraction of the (factor-1) step slack one chunk may occupy —
    # headroom for dispatch overhead and queueing jitter
    _SLACK_MARGIN = 0.6

    def __init__(self, factor: Optional[float] = None, clock=None):
        from dlrover_tpu_torch.utils.step_clock import get_step_clock

        self.clock = clock if clock is not None else get_step_clock()
        self.manual_pace = envs.get_float("DLROVER_TPU_STAGE_PACE")
        if factor is None:
            factor = envs.get_float("DLROVER_TPU_STAGE_FACTOR")
        self.factor = max(1.05, factor)
        self.chunk_bytes = _DEFAULT_CHUNK
        self.sleep_ratio = 0.0  # sleep = ratio * last chunk transfer time
        self.best_bw = 0.0  # bytes/s, max observed (robust to overhead)
        self.last_chunk_s = 0.0
        self._mark = time.monotonic()
        self._calibrated = False

    # -- feedback ----------------------------------------------------------

    def note_transfer(self, nbytes: int, seconds: float) -> None:
        self.last_chunk_s = seconds
        if seconds > 0:
            self.best_bw = max(self.best_bw, nbytes / seconds)
        if not self._calibrated:
            self._calibrate()

    def _calibrate(self) -> None:
        """Jump straight to the bandwidth-derived chunk size: converging
        by halving alone would blow the step budget for the handful of
        steps the bound exists to protect."""
        base = self.clock.baseline()
        if not self.best_bw or base is None:
            return
        if base < _MIN_BASELINE_S:
            self.chunk_bytes = _MAX_CHUNK
            self.sleep_ratio = 0.0
            self._calibrated = True
            logger.info(
                "stage pacer: step baseline %.2gs below the %.0fms floor "
                "(non-blocking training loop); staging unpaced",
                base, _MIN_BASELINE_S * 1e3,
            )
            return
        slack = (self.factor - 1.0) * base * self._SLACK_MARGIN
        self.chunk_bytes = int(
            min(_MAX_CHUNK, max(_MIN_CHUNK, self.best_bw * slack))
        )
        self._calibrated = True
        logger.info(
            "stage pacer calibrated: bw=%.1f MB/s step=%.3fs chunk=%d KiB",
            self.best_bw / 1e6, base, self.chunk_bytes // 1024,
        )

    def _adjust(self) -> None:
        steps = self.clock.steps_since(self._mark)
        if not steps:
            return
        self._mark = time.monotonic()
        base = self.clock.baseline()
        if base is None:
            # no baseline to judge against: pace conservatively
            self.sleep_ratio = max(self.sleep_ratio, 1.0)
            return
        if base < _MIN_BASELINE_S:
            # collapsed baseline = meaningless cadence signal; never
            # escalate sleeps against scheduler jitter
            self.sleep_ratio = 0.0
            return
        med = sorted(steps)[len(steps) // 2]
        if med > self.factor * base:
            if self.chunk_bytes > _MIN_CHUNK:
                self.chunk_bytes = max(_MIN_CHUNK, self.chunk_bytes // 2)
            else:
                self.sleep_ratio = min(8.0, max(0.5, self.sleep_ratio * 1.6))
        elif med < max(1.0, 0.8 * self.factor) * base:
            # comfortably under the bound: recover staging throughput
            if self.sleep_ratio > 0.05:
                self.sleep_ratio *= 0.6
            else:
                self.sleep_ratio = 0.0
                self.chunk_bytes = min(_MAX_CHUNK, self.chunk_bytes * 2)

    def gate(self) -> None:
        """Call before dispatching each chunk: applies the duty-cycle
        sleep and adapts chunking to the latest observed steps."""
        if self.manual_pace > 0:
            if self.last_chunk_s > 0:
                time.sleep(
                    min(30.0, self.manual_pace * self.last_chunk_s)
                )
            return
        if self.clock.idle():
            # nothing is training: drain at full speed
            self.sleep_ratio = 0.0
            self.chunk_bytes = min(_MAX_CHUNK, self.chunk_bytes * 2)
            return
        self._adjust()
        if self.sleep_ratio > 0 and self.last_chunk_s > 0:
            time.sleep(min(10.0, self.sleep_ratio * self.last_chunk_s))


# -- instrumentation hooks ---------------------------------------------------
#
# The zero-copy invariant of the streaming path ("at most one host-side
# copy per shard chunk") is cheap to break silently — any refactor that
# re-introduces an intermediate host buffer still produces bit-exact
# snapshots, just with 2x the memory traffic.  Every host-side buffer
# copy in this module therefore reports through the observer, and a
# tier-1 test asserts copies == chunks on the streaming path.
_copy_observer: Optional[Callable[[str, int], None]] = None


def set_copy_observer(fn: Optional[Callable[[str, int], None]]) -> None:
    """``fn(event, nbytes)`` with event in {"chunk", "host_copy"}."""
    global _copy_observer
    _copy_observer = fn


def set_stream_fault(fn: Optional[Callable[[int], None]]) -> None:
    """Torn-snapshot fault hook, a ``callback`` fault on the
    ``snapshot.stream_chunk`` chaos point: ``fn(chunk_idx)`` is called
    with the 0-based index of each chunk ``stream_snapshot`` lands in shm;
    raising aborts the stream mid-write, leaving the seqlock generation
    dirty, and blocking holds the stager.  ``None`` clears it.  New code
    injects a spec on ``snapshot.stream_chunk`` directly (any kind,
    nth-call scheduling, seeded traces)."""
    from dlrover_tpu_torch import chaos

    chaos.clear("snapshot.stream_chunk")
    if fn is not None:
        chaos.inject(
            chaos.FaultSpec(
                point="snapshot.stream_chunk",
                kind=chaos.CALLBACK,
                callback=lambda chunk=0: fn(chunk),
            )
        )


def _note(event: str, nbytes: int) -> None:
    if _copy_observer is not None:
        _copy_observer(event, nbytes)


# -- byte views ----------------------------------------------------------------


def byte_view(data: torch.Tensor) -> torch.Tensor:
    """Flat ``uint8`` view of a tensor (made contiguous if needed): how
    every dtype, bf16 included, moves through shm."""
    return data.contiguous().reshape(-1).view(torch.uint8)


def tensor_from_bytes(buf, dtype: str, shape) -> torch.Tensor:
    """A CPU tensor over a read-only uint8 buffer (a memmap range), of the
    stored dtype and shape; no copy."""
    with warnings.catch_warnings():
        # torch warns that it cannot mark the tensor read-only; the
        # restore only reads it
        warnings.simplefilter("ignore", UserWarning)
        raw = torch.from_numpy(np.asarray(buf))
    return raw.view(torch_dtype(dtype)).reshape(shape)


def _shm_bytes(buf, offset: int, nbytes: int) -> torch.Tensor:
    """A ``uint8`` tensor over ``nbytes`` of the shm buffer at ``offset``.
    It holds an export of the buffer: drop it before the segment is
    closed."""
    return torch.frombuffer(buf, dtype=torch.uint8, count=nbytes,
                            offset=offset)


def _copy_into(buf, offset: int, src: torch.Tensor) -> None:
    """Copy a flat ``uint8`` CPU tensor into shm at ``offset``."""
    if src.numel():
        _shm_bytes(buf, offset, src.numel()).copy_(src)


# -- shard enumeration and device->host ---------------------------------------


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    # the step and optimizer counts: 0-d int64, as np.asarray makes them
    return torch.from_numpy(np.asarray(leaf))


def structure(state: Any) -> Tuple:
    """The state's leaf paths with each local tensor's shape and dtype:
    what a layout of it depends on besides the mesh."""
    return tuple((path, tuple(getattr(leaf, "shape", ())),
                  str(getattr(leaf, "dtype", type(leaf))))
                 for path, leaf in flatten_with_path(state))


def _enumerate_shards(state: Any, layout: Optional[Layout] = None
                      ) -> List[Dict]:
    """Flatten the state into its shard list WITHOUT any device->host
    transfer: ``shard['data']`` stays the tensor (on its device), viewed
    with its box's extents.  A leaf ``layout`` names is one shard at its
    box of its global shape; any other is one shard covering the whole
    tensor."""
    layout = layout or {}
    leaves = []
    for path, leaf in flatten_with_path(state):
        data = _as_tensor(leaf)
        if path in layout:
            gshape, index = layout[path]
            gshape = [int(d) for d in gshape]
            index = [[int(a), int(b)] for a, b in index]
            extents = [b - a for a, b in index]
            if len(index) != len(gshape) or \
                    math.prod(extents) != data.numel():
                raise ValueError(
                    f"leaf {path} of shape {tuple(data.shape)} does not fill "
                    f"its box {index} of {gshape}")
            data = data.reshape(extents)
        else:
            gshape = [int(d) for d in data.shape]
            index = [[0, d] for d in gshape]
        leaves.append({
            "path": path,
            "dtype": dtype_name(data.dtype),
            "gshape": gshape,
            "shards": [{"index": index, "data": data}],
        })
    return leaves


def _device_shards(leaves: List[Dict]) -> List[Dict]:
    return [shard for leaf in leaves for shard in leaf["shards"]
            if shard["data"].is_cuda]


def _chunked_to_host(data: torch.Tensor, pacer: StagePacer) -> torch.Tensor:
    """Device->host copy of one shard in pacer-sized chunks, each landing
    directly at its offset of one pinned host tensor (no host copy), so a
    train step dispatched mid-staging waits behind at most one chunk."""
    src = byte_view(data)
    host = torch.empty(src.numel(), dtype=torch.uint8, pin_memory=True)
    pos = 0
    while pos < src.numel():
        n = min(pacer.chunk_bytes, src.numel() - pos)
        pacer.gate()
        t0 = time.perf_counter()
        host[pos:pos + n].copy_(src[pos:pos + n])
        pacer.note_transfer(n, time.perf_counter() - t0)
        _note("chunk", n)
        pos += n
    return host.view(data.dtype).reshape(data.shape)


def _to_host(leaves: List[Dict], throttled: bool,
             pacer: Optional[StagePacer],
             wait_event: Optional[torch.cuda.Event] = None) -> List[Dict]:
    """Replace every device shard's data by a host copy (in place)."""
    shards = _device_shards(leaves)
    if not shards:
        return leaves
    if wait_event is not None:
        wait_event.synchronize()
    if throttled:
        pacer = pacer or StagePacer()
        pacer.clock.staging_started()
        try:
            for shard in shards:
                shard["data"] = _chunked_to_host(shard["data"], pacer)
        finally:
            pacer.clock.staging_finished()
        return leaves
    # blocking save: every D2H enqueued at once into pinned memory, then
    # one synchronize — the transfers overlap maximally
    for shard in shards:
        data = shard["data"]
        host = torch.empty(data.shape, dtype=data.dtype, pin_memory=True)
        host.copy_(data, non_blocking=True)
        shard["data"] = host
    torch.cuda.synchronize()
    return leaves


def extract_host_shards(
    state: Any, throttled: bool = False,
    pacer: Optional["StagePacer"] = None,
    layout: Optional[Layout] = None,
) -> List[Dict]:
    """Flatten the state into its shard list with every tensor on the
    host.

    ``throttled=False`` (the blocking save path) copies every device
    tensor with ``non_blocking=True`` into pinned memory, then
    synchronizes once.  ``throttled=True`` (the background stager's
    two-phase path) copies through the auto-pacing ``StagePacer`` in
    chunks, so a train step dispatched mid-staging waits behind at most one
    chunk.  Host tensors are kept as they are.  ``layout``: as
    ``_enumerate_shards``."""
    return _to_host(_enumerate_shards(state, layout), throttled, pacer)


def snapshot_nbytes(leaves: List[Dict]) -> int:
    return sum(_shard_nbytes(shard["data"]) for leaf in leaves
               for shard in leaf["shards"])


def _shard_nbytes(data: torch.Tensor) -> int:
    return data.numel() * data.element_size()


def plan_shards(state: Any, layout: Optional[Layout] = None) -> List[Dict]:
    """Enumerate the shards with NO device->host transfer — the first
    half of the streaming path.  Shapes/dtypes come from tensor metadata,
    so the full shm layout can be computed before a payload byte moves."""
    return _enumerate_shards(state, layout)


def compute_layout(
    step: int, leaves: List[Dict], extras: Optional[Dict] = None
) -> Tuple[bytes, List[Tuple[int, Any]], int]:
    """Precompute the exact shm layout from shapes.

    Returns ``(meta_bytes, placements, total)`` where ``placements`` is
    a flat ``[(payload_offset, shard_dict), ...]`` in storage order and
    ``total`` is the full segment size (prefix + meta + payload).  The
    meta is the reference's, key for key, so readers cannot tell which
    path (or package) staged a snapshot."""
    meta_leaves = []
    placements: List[Tuple[int, Any]] = []
    offset = 0
    for leaf in leaves:
        shard_metas = []
        for shard in leaf["shards"]:
            data = shard["data"]
            nbytes = _shard_nbytes(data)
            shard_metas.append(
                {
                    "index": shard["index"],
                    "offset": offset,
                    "nbytes": int(nbytes),
                    # 0-d scalars are stored as [1], as the reference's
                    # writers store them
                    "shape": [int(d) for d in data.shape] or [1],
                }
            )
            placements.append((offset, shard))
            offset += nbytes
        meta_leaves.append(
            {
                "path": leaf["path"],
                "dtype": leaf["dtype"],
                "gshape": leaf["gshape"],
                "shards": shard_metas,
            }
        )
    meta = {
        "step": int(step),
        "extras": extras or {},
        "leaves": meta_leaves,
        "payload_bytes": offset,
    }
    meta_bytes = json.dumps(meta).encode("utf-8")
    total = _META_OFF + len(meta_bytes) + offset
    return meta_bytes, placements, total


def read_generation(shm: SharedMemoryBuffer) -> Optional[int]:
    """The seqlock generation word, or None when no segment/too small."""
    if not shm.attach() or shm.size < _META_OFF:
        return None
    return struct.unpack(">Q", bytes(shm.buf[_GEN_OFF : _GEN_OFF + 8]))[0]


def is_torn(shm: SharedMemoryBuffer) -> bool:
    """True when a writer died mid-write (odd generation): the payload
    is part old snapshot, part new — unusable, and distinguishable from
    'no snapshot was ever taken'."""
    gen = read_generation(shm)
    return gen is not None and gen % 2 == 1


def _begin_write(buf) -> int:
    """Invalidate the snapshot and mark the generation dirty.  Order
    matters: the generation goes odd FIRST, so a reader can never see a
    valid-looking meta length over a half-written payload."""
    (gen,) = struct.unpack(">Q", bytes(buf[_GEN_OFF : _GEN_OFF + 8]))
    if gen % 2 == 0:
        gen += 1
    buf[_GEN_OFF : _GEN_OFF + 8] = struct.pack(">Q", gen)
    buf[0:_HEADER] = struct.pack(">Q", 0)
    return gen


def _commit_write(buf, gen: int, meta_len: int) -> None:
    """Publish: meta length first, then the even generation LAST — the
    reverse of ``_begin_write``, completing the seqlock protocol."""
    buf[0:_HEADER] = struct.pack(">Q", meta_len)
    buf[_GEN_OFF : _GEN_OFF + 8] = struct.pack(">Q", gen + 1)


class _ChunkLander:
    """Lands chunks in shm in submission order and fires the per-chunk
    hooks.  Device chunks go device-to-host on a side CUDA stream into one
    of two pinned bounce buffers, and chunk ``i + 1``'s transfer runs while
    chunk ``i`` is copied into shm; host chunks are copied directly."""

    def __init__(self, buf, pacer: StagePacer,
                 wait_event: Optional[torch.cuda.Event]):
        self._buf = buf
        self._pacer = pacer
        self._wait_event = wait_event
        self._stream: Optional[torch.cuda.Stream] = None
        self._bounce: List[Optional[torch.Tensor]] = [None, None]
        # per bounce slot: (start event, end event, shm offset, nbytes,
        # source chunk)
        self._pending: List[Optional[Tuple]] = [None, None]
        self._turn = 0
        self.chunks = 0

    def _landed(self, nbytes: int) -> None:
        _note("chunk", nbytes)
        _note("host_copy", nbytes)
        self.chunks += 1
        _chaos_point("snapshot.stream_chunk", chunk=self.chunks - 1)

    def host(self, src: torch.Tensor, dst_off: int) -> None:
        """Copy a host chunk into shm (in order after pending chunks)."""
        self.drain()
        _copy_into(self._buf, dst_off, src)
        self._landed(src.numel())

    def device(self, src: torch.Tensor, dst_off: int) -> None:
        """Start a device chunk's transfer; the chunk two before it (the
        one holding this bounce slot) lands first, while the chunk just
        before it stays in flight."""
        slot = self._turn
        self._turn ^= 1
        self._land(slot)
        if self._stream is None:
            self._stream = torch.cuda.Stream(src.device)
            if self._wait_event is not None:
                self._stream.wait_event(self._wait_event)
        n = src.numel()
        bounce = self._bounce[slot]
        if bounce is None or bounce.numel() < n:
            bounce = self._bounce[slot] = torch.empty(
                max(n, self._pacer.chunk_bytes), dtype=torch.uint8,
                pin_memory=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._stream):
            start.record()
            bounce[:n].copy_(src, non_blocking=True)
            end.record()
        # ``src`` stays referenced until its chunk has landed: the caching
        # allocator does not see the side stream, and would otherwise hand
        # a released shard's memory to the training stream mid-transfer
        self._pending[slot] = (start, end, dst_off, n, src)

    def _land(self, slot: int) -> None:
        pending = self._pending[slot]
        if pending is None:
            return
        self._pending[slot] = None
        start, end, dst_off, n, _src = pending
        end.synchronize()
        self._pacer.note_transfer(n, start.elapsed_time(end) / 1e3)
        _copy_into(self._buf, dst_off, self._bounce[slot][:n])
        self._landed(n)

    def drain(self) -> None:
        # the slot to be used next holds the older chunk
        self._land(self._turn)
        self._land(self._turn ^ 1)

    def close(self) -> None:
        """Wait for any transfer still in flight (after an abort), so no
        DMA writes a bounce buffer after it is released."""
        if self._stream is not None:
            self._stream.synchronize()
        self._pending = [None, None]
        self._bounce = [None, None]


def _stream_shard(lander: _ChunkLander, dst_off: int, data: torch.Tensor,
                  pacer: StagePacer, chunk_override: int) -> None:
    """Stream one shard into its final shm offset, chunk by chunk: byte
    ranges of the shard's flat view, each landing with one bounded copy
    at ``dst_off + pos``.  A shard of at most one chunk (or 2 MiB) goes
    whole."""
    src = byte_view(data)
    nbytes = src.numel()
    whole = (nbytes <= (chunk_override or pacer.chunk_bytes)
             or nbytes <= 2 * _MIN_CHUNK)
    land = lander.device if src.is_cuda else lander.host
    pos = 0
    while pos < nbytes:
        n = nbytes - pos if whole else min(
            chunk_override or pacer.chunk_bytes, nbytes - pos)
        pacer.gate()
        land(src[pos:pos + n], dst_off + pos)
        pos += n


def stream_snapshot(
    shm: SharedMemoryBuffer,
    step: int,
    leaves: List[Dict],
    extras: Optional[Dict] = None,
    pacer: Optional["StagePacer"] = None,
    chunk_bytes: int = 0,
    release_shards: bool = True,
    wait_event: Optional[torch.cuda.Event] = None,
) -> int:
    """Streaming write: precomputed layout, paced device->host chunks
    landing at their final shm offsets, seqlock commit.

    ``leaves`` comes from ``plan_shards`` (tensors still on their device).
    ``wait_event``: the side stream waits for it before its first transfer
    (the event recorded after the async save's device copy).
    ``release_shards`` drops each shard's reference once it is streamed.
    Returns total segment bytes.  Raising mid-stream (fault, kill) leaves
    the generation dirty — readers fall back to storage candidates."""
    if pacer is None:
        pacer = StagePacer()
    if not chunk_bytes:
        chunk_bytes = envs.get_int("DLROVER_TPU_STREAM_CHUNK_BYTES")
    meta_bytes, placements, total = compute_layout(step, leaves, extras)
    shm.init(total)
    buf = shm.buf
    gen = _begin_write(buf)
    buf[_META_OFF : _META_OFF + len(meta_bytes)] = meta_bytes
    base = _META_OFF + len(meta_bytes)
    lander = _ChunkLander(buf, pacer, wait_event)
    try:
        for offset, shard in placements:
            _stream_shard(lander, base + offset, shard["data"], pacer,
                          chunk_bytes)
            if release_shards:
                shard["data"] = None
        lander.drain()
    finally:
        lander.close()
    _commit_write(buf, gen, len(meta_bytes))
    return total


def write_snapshot(
    shm: SharedMemoryBuffer,
    step: int,
    leaves: List[Dict],
    extras: Optional[Dict] = None,
) -> int:
    """Two-phase pack of host-staged leaves into shm; returns total
    bytes used.  (The streaming path is ``plan_shards`` +
    ``stream_snapshot``; this one serves the blocking save, whose tensors
    were already host-staged with maximally overlapped D2H.)"""
    meta_bytes, placements, total = compute_layout(step, leaves, extras)
    shm.init(total)
    buf = shm.buf
    # seqlock invalidate -> write -> commit: a process killed mid-write
    # leaves an odd generation and a zero meta length, which reads as "no
    # snapshot" instead of step-N metadata over torn payload bytes
    gen = _begin_write(buf)
    buf[_META_OFF : _META_OFF + len(meta_bytes)] = meta_bytes
    base = _META_OFF + len(meta_bytes)
    for offset, shard in placements:
        src = byte_view(shard["data"])
        _copy_into(buf, base + offset, src)
        _note("host_copy", src.numel())
    # commit: only a fully-written snapshot ever becomes readable
    _commit_write(buf, gen, len(meta_bytes))
    return total


def read_snapshot_meta(shm: SharedMemoryBuffer) -> Optional[Dict]:
    if not shm.attach():
        return None
    buf = shm.buf
    if shm.size < _META_OFF:
        return None
    if is_torn(shm):
        return None  # writer died mid-stream: meta may cover torn bytes
    (meta_len,) = struct.unpack(">Q", bytes(buf[0:_HEADER]))
    if meta_len == 0 or _META_OFF + meta_len > shm.size:
        return None
    try:
        return json.loads(bytes(buf[_META_OFF : _META_OFF + meta_len]))
    except ValueError:
        return None


def read_meta_bytes(shm: SharedMemoryBuffer) -> Optional[bytes]:
    """The committed meta's raw JSON bytes (None when absent or torn).
    The peer-restore endpoint ships them verbatim, so a fetcher can
    crc-check exactly what the donor's seqlock committed."""
    if not shm.attach() or shm.size < _META_OFF or is_torn(shm):
        return None
    (meta_len,) = struct.unpack(">Q", bytes(shm.buf[0:_HEADER]))
    if meta_len == 0 or _META_OFF + meta_len > shm.size:
        return None
    return bytes(shm.buf[_META_OFF : _META_OFF + meta_len])


def read_payload_range(
    shm: SharedMemoryBuffer, offset: int, nbytes: int
) -> Optional[bytes]:
    """``nbytes`` of the committed payload from the payload-relative
    ``offset`` (None when absent, torn or out of range).  The caller pins
    the seqlock generation around the read: the range itself promises no
    atomicity."""
    if not shm.attach() or shm.size < _META_OFF or is_torn(shm):
        return None
    start = payload_base(shm) + int(offset)
    end = start + int(nbytes)
    if offset < 0 or nbytes < 0 or end > shm.size:
        return None
    return bytes(shm.buf[start:end])


def payload_base(shm: SharedMemoryBuffer) -> int:
    """Byte offset where the payload starts (after prefix + meta)."""
    (meta_len,) = struct.unpack(">Q", bytes(shm.buf[0:_HEADER]))
    return _META_OFF + int(meta_len)


def read_shard_bytes(shm: SharedMemoryBuffer, meta: Dict, shard_meta: Dict,
                     dtype: str) -> torch.Tensor:
    """One shard as a CPU tensor of its dtype (a copy out of shm)."""
    out = torch.empty(shard_meta["nbytes"], dtype=torch.uint8)
    if out.numel():
        out.copy_(_shm_bytes(shm.buf, payload_base(shm)
                             + shard_meta["offset"], out.numel()))
    return out.view(torch_dtype(dtype)).reshape(shard_meta["shape"])


def shard_view(shm: SharedMemoryBuffer, shard_meta: Dict,
               dtype: str) -> torch.Tensor:
    """One shard as a CPU tensor over the shm bytes themselves (no copy).
    It holds an export of the buffer: drop it before the segment is
    closed."""
    n = shard_meta["nbytes"]
    raw = (_shm_bytes(shm.buf, payload_base(shm) + shard_meta["offset"], n)
           if n else torch.empty(0, dtype=torch.uint8))
    return raw.view(torch_dtype(dtype)).reshape(shard_meta["shape"])


class ShardIndexMap:
    """Assemble arbitrary slices of a leaf from stored global-index
    shards (torch CPU tensors).

    A box added twice (a replicated leaf, written by every rank into its
    own file) is kept once: the pieces then never overlap, which the
    coverage count relies on."""

    def __init__(self, dtype: str, gshape: List[int]):
        self.dtype = torch_dtype(dtype)
        self.gshape = gshape
        self._pieces: List[Tuple[List[List[int]], Any]] = []
        self._boxes: set = set()

    def _new_box(self, index) -> bool:
        key = tuple(tuple(int(i) for i in box) for box in index)
        if key in self._boxes:
            return False
        self._boxes.add(key)
        return True

    def add(self, index: List[List[int]], data: torch.Tensor):
        if self._new_box(index):
            self._pieces.append((index, data))

    def add_lazy(self, index: List[List[int]], loader):
        """Register a shard whose bytes are fetched only if a ``read``
        actually needs it.  ``loader`` is a zero-arg callable returning
        the shard tensor."""
        if self._new_box(index):
            self._pieces.append((index, loader))

    def covers(self, target: Tuple[slice, ...]) -> bool:
        """Cheap coverage check (no copying) for the given slice."""
        try:
            self._check_coverage(target)
            return True
        except ValueError:
            return False

    def _bounds(self, target: Tuple[slice, ...]) -> List[Tuple[int, int]]:
        tgt = []
        for dim, sl in enumerate(target):
            start = sl.start if sl.start is not None else 0
            stop = sl.stop if sl.stop is not None else self.gshape[dim]
            tgt.append((int(start), int(stop)))
        return tgt

    def _check_coverage(self, target: Tuple[slice, ...]):
        tgt = self._bounds(target)
        need = math.prod(b - a for a, b in tgt) if tgt else 1
        got = 0
        for index, _ in self._pieces:
            overlap = 1
            for (ts, te), (ss, se) in zip(tgt, index):
                lo, hi = max(ts, ss), min(te, se)
                if lo >= hi:
                    overlap = 0
                    break
                overlap *= hi - lo
            got += overlap
        # pieces never overlap each other (distinct shard indices), so
        # summed overlap == need implies full coverage
        if got < need:
            raise ValueError(f"coverage {got}/{need}")

    def _load(self, pos: int) -> torch.Tensor:
        index, data = self._pieces[pos]
        if callable(data):
            # materialize once; a piece may serve several reads
            data = data()
            self._pieces[pos] = (index, data)
        return data

    def whole(self) -> Optional[torch.Tensor]:
        """The leaf itself when one shard covers all of it: no assembly
        copy."""
        return self.exact([[0, int(d)] for d in self.gshape])

    def exact(self, box: Sequence[Sequence[int]]) -> Optional[torch.Tensor]:
        """The stored shard whose box is exactly ``box`` (a restore onto
        the mesh it was saved from), or None."""
        box = [[int(a), int(b)] for a, b in box]
        for pos, (index, _) in enumerate(self._pieces):
            if [list(map(int, i)) for i in index] == box:
                return self._load(pos).reshape([b - a for a, b in box])
        return None

    def read(self, target: Tuple[slice, ...]) -> torch.Tensor:
        tgt = self._bounds(target)
        out = torch.zeros([b - a for a, b in tgt], dtype=self.dtype)
        filled = 0
        for pos, (index, _) in enumerate(self._pieces):
            src_slices, dst_slices = [], []
            ok = True
            for (ts, te), (ss, se) in zip(tgt, index):
                lo, hi = max(ts, ss), min(te, se)
                if lo >= hi:
                    ok = False
                    break
                src_slices.append(slice(lo - ss, hi - ss))
                dst_slices.append(slice(lo - ts, hi - ts))
            if ok:
                piece = self._load(pos)[tuple(src_slices)]
                out[tuple(dst_slices)] = piece.reshape(
                    out[tuple(dst_slices)].shape
                )
                filled += math.prod(
                    s.stop - s.start for s in dst_slices
                ) if dst_slices else out.numel()
        if filled < out.numel():
            raise ValueError(
                f"checkpoint does not cover requested slice (filled "
                f"{filled}/{out.numel()} elements)"
            )
        return out
