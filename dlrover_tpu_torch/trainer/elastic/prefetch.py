"""Device prefetch: overlap host batch prep + H2D with device compute.

Copy of ``dlrover_tpu/trainer/elastic/prefetch.py``, the counterpart of
the reference loader's prefetch/queue knobs (``prefetch_count`` rides the
paral-config wire; torch DataLoader workers prefetch host-side).  On the
card the win is hiding the host->HBM copy behind the step: a worker
thread takes batch N+1 through ``sharding.shard_batch``, copies its
arrays into pinned host tensors and from there, with
``copy_(non_blocking=True)`` on a dedicated ``torch.cuda.Stream``, onto
the card, and records a ``torch.cuda.Event`` after the copies.  The
consumer's ``__next__`` makes its current stream wait for that event and
calls ``record_stream`` on every staged tensor, so the caching allocator
does not hand a staged block to the side stream again while the step
still reads it.  The pinned tensors stay referenced until the batch is
handed out; the host allocator keeps their blocks until the copies that
read them have finished.  On the CPU (``device="cpu"``) it is the same
code without streams.

A ``__next__`` that finds the queue empty measures how long the device
then stood idle for want of input: on the card, the gap between a timing
event recorded before the wait and one recorded after it on the
consumer's stream (zero when the device never drained), on the CPU the
wait itself.  That gap accumulates in ``idle_wait_s``, and one of at
least ``DLROVER_TPU_DATA_STARVED_MIN_S`` is charged to the goodput
ledger's ``input_blocked`` claim (reported as ``input_starved``), which
the trainer's compute claim over the same inter-step gap does not take.
"""

import queue
import threading
import time
from typing import Any, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.device import DeviceLike, resolve_device
from dlrover_tpu_torch.observability import goodput

_END = object()


def _host_tensor(value) -> torch.Tensor:
    if torch.is_tensor(value):
        return value.detach().cpu()
    return torch.as_tensor(np.asarray(value))


class DevicePrefetcher:
    """Wrap a host batch iterator; yield device-staged batches ``depth``
    ahead.

    ``depth`` bounds the number of staged batches alive at once (each
    holds device memory — keep it small; 2 hides one step of latency).
    The worker thread performs ``fetch -> shard_batch -> stage`` for
    upcoming batches; exceptions it hits (a failed CUDA copy included:
    there is no CPU fallback) are re-raised to the consumer at the
    position they occurred, and ``close()`` releases the worker and the
    queued buffers promptly (safe to call mid-epoch, e.g. on an elastic
    restart).

    ``mesh`` is the trainer's ``DeviceMesh`` (its batch goes through the
    port's ``sharding.shard_batch``: a rank's own rows, its sequence chunk
    under cp), or None on one device.  ``device``: the card by default
    (pinned to its index), ``"cpu"`` when asked for.

    Data-position bookkeeping rides CONSUMPTION, not production: call
    ``sampler.record_batch`` (or save the loader offset) after
    ``train_step`` consumes a batch — up to ``depth`` staged batches
    are in flight ahead of the trained position, and a restart must
    replay them, not skip them."""

    def __init__(
        self,
        batches: Iterable[Any],
        mesh=None,
        depth: int = 2,
        device: DeviceLike = None,
    ):
        from dlrover_tpu_torch.parallel.sharding import shard_batch

        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            # tensors report cuda:N: a bare "cuda" would compare unequal
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._stream = (torch.cuda.Stream(device=dev)
                        if dev.type == "cuda" else None)
        self._source = iter(batches)
        self._mesh = mesh
        self._shard = shard_batch
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._done = False
        #: seconds the device stood idle while ``__next__`` waited
        self.idle_wait_s = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, daemon=True, name="device-prefetch"
        )
        self._thread.start()

    def _stage(self, batch: Dict[str, Any]):
        """(staged tensors, the event after their copies or None, the
        pinned host tensors they were copied from)."""
        if self._mesh is not None:
            batch = self._shard(self._mesh, batch)
        if self._stream is None:
            return {k: _host_tensor(v).to(self.device)
                    for k, v in batch.items()}, None, None
        pinned = {k: _host_tensor(v).pin_memory() for k, v in batch.items()}
        with torch.cuda.stream(self._stream):
            staged = {k: torch.empty_like(v, device=self.device)
                      for k, v in pinned.items()}
            for k, v in pinned.items():
                staged[k].copy_(v, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return staged, event, pinned

    def _worker(self):
        try:
            if self._stream is not None:
                # the current device is per thread
                torch.cuda.set_device(self.device)
            for batch in self._source:
                if self._stop.is_set():
                    return
                staged = self._stage(batch)
                # blocking put bounds staged device memory; poll the
                # stop flag so close() never deadlocks against a full
                # queue nobody is draining
                while not self._stop.is_set():
                    try:
                        self._queue.put(staged, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    # stopped while waiting for a slot: exit WITHOUT
                    # pulling another source item (an elastic restart
                    # must not advance the host data stream further)
                    return
            if not self._stop.is_set():
                self._queue.put(_END)
        except BaseException as e:  # noqa: BLE001 - forward to consumer
            if not self._stop.is_set():
                try:
                    self._queue.put(e)
                except Exception:  # noqa: BLE001
                    logger.exception("prefetch error lost")

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        if self._stop.is_set() or self._done:
            raise StopIteration
        item = self._get()
        if item is _END:
            self._done = True  # iterating again must not block forever
            raise StopIteration
        if isinstance(item, BaseException):
            self.close()
            raise item
        staged, event, _pinned = item
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for tensor in staged.values():
                tensor.record_stream(current)
        return staged

    def _get(self) -> Any:
        """The queue's next item, and on an empty queue the device-idle
        part of the wait, charged when it reaches the starvation floor."""
        if not self._queue.empty():
            return self._queue.get()
        t0 = time.time()
        mark = None
        if self._stream is not None:
            current = torch.cuda.current_stream(self.device)
            mark = torch.cuda.Event(enable_timing=True)
            mark.record(current)
        item = self._queue.get()
        now = time.time()
        idle = now - t0
        if mark is not None:
            # nothing was enqueued during the wait: once ``mark`` has
            # completed, ``done`` completes at once, and the device
            # clock between them is the idle gap; a ``mark`` still
            # pending means the device never went idle
            idle = 0.0
            if mark.query():
                done = torch.cuda.Event(enable_timing=True)
                done.record(current)
                done.synchronize()
                idle = mark.elapsed_time(done) / 1e3
        self.idle_wait_s += idle
        if idle >= envs.get_float("DLROVER_TPU_DATA_STARVED_MIN_S"):
            goodput.charge("input_blocked", idle, end_ts=now)
        return item

    def close(self):
        """Stop the worker and drop staged batches (their device
        buffers free once the consumer releases its references).  Join
        BEFORE draining: a worker blocked in put() could otherwise
        re-insert a staged batch after the drain, pinning its buffers
        until GC."""
        self._stop.set()
        self._thread.join(timeout=10)
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.close()
        return None
