"""Servicer admission control: bounded concurrency with backpressure.

Copy of ``dlrover_tpu/master/admission.py``, its imports the port's, with
the chaos point of admission (``servicer.admission``: a DROP or FLAP is a
forced shed).

The master is one process serving every agent in the job; without a
bound, a 10k-agent herd turns each RPC into a lock convoy and p99
collapses for *everyone*.  Admission control keeps the served set small
enough to stay fast and converts the overflow into explicit
backpressure: a rejected request gets ``BaseResponse(reason=OVERLOADED,
retry_after_s=...)`` and the client's :class:`RetryPolicy` honors the
hint (``common/retry.py``), so load sheds into politely-spaced retries
instead of timeouts.

Two pools, because the two request classes cost differently:

* ``work`` — ordinary dispatch.  Held for the (short) time the handler
  runs; the cap bounds lock contention on the managers behind the
  servicer.  Requests over the cap queue briefly (bounded by
  ``DLROVER_TPU_SERVICER_QUEUE_TIMEOUT_S``, the "bounded work queue");
  only when the queue wait times out is the request rejected.
* ``wait`` — long-polls (``KVStoreWaitRequest`` / ``RdzvWaitRequest`` /
  blocking ``TaskBatchRequest``).  Held for up to the long-poll chunk
  (~30s) but blocked on a Condition, so the cap is larger; it exists to
  bound the master's blocked-thread population (the "no unbounded
  thread growth" invariant — observable as the
  ``dlrover_tpu_servicer_inflight{pool="wait"}`` gauge).

The servicer pairs this with :class:`common.coalesce.WaitHub` to
coalesce identical in-flight kv waits: when N agents long-poll the same
key (every barrier does exactly this), one leader drives the store's
Condition and N-1 followers park on a private Event, so the store sees
one waiter per key regardless of fleet size.
"""

import threading
import time
from typing import Optional, Tuple

from dlrover_tpu_torch.observability import metrics as obs_metrics
from dlrover_tpu_torch.observability import trace

#: admission pools (label value on the inflight/queue gauges)
WORK_POOL = "work"
WAIT_POOL = "wait"


class _Pool:
    """One bounded admission pool with a short queueing window."""

    def __init__(self, name: str, cap_knob: str, queue_timeout_knob: str):
        self.name = name
        self._cap_knob = cap_knob
        self._queue_timeout_knob = queue_timeout_knob
        self._cond = threading.Condition()
        self._inflight = 0
        self._queued = 0
        # pull gauges: evaluated at scrape/snapshot time, so admit and
        # release never touch the metrics registry on the hot path
        reg = obs_metrics.registry()
        reg.gauge_fn(
            "dlrover_tpu_servicer_inflight",
            lambda: self.depth()[0],
            help="requests currently admitted by the servicer",
            pool=name,
        )
        reg.gauge_fn(
            "dlrover_tpu_servicer_queue_depth",
            lambda: self.depth()[1],
            help="requests queued at admission waiting for a slot",
            pool=name,
        )

    def _cap(self) -> int:
        from dlrover_tpu_torch.common import envs

        return envs.get_int(self._cap_knob)

    def _queue_timeout(self) -> float:
        from dlrover_tpu_torch.common import envs

        return envs.get_float(self._queue_timeout_knob)

    def try_acquire(self) -> bool:
        """Admit now, queue briefly, or refuse (False = send overload)."""
        cap = self._cap()
        with self._cond:
            if cap <= 0 or self._inflight < cap:
                self._inflight += 1
                return True
            # bounded queue: wait a short window for a slot instead of
            # rejecting on the first collision — smooths bursts without
            # letting the backlog grow unboundedly
            self._queued += 1
            deadline = time.monotonic() + max(0.0, self._queue_timeout())
            try:
                while self._inflight >= cap:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    self._cond.wait(remaining)
                self._inflight += 1
                return True
            finally:
                self._queued -= 1

    def release(self) -> None:
        with self._cond:
            self._inflight = max(0, self._inflight - 1)
            self._cond.notify()

    def depth(self) -> Tuple[int, int]:
        with self._cond:
            return self._inflight, self._queued


class AdmissionController:
    """Gate every servicer request through the work/wait pools and
    price the overload response."""

    def __init__(self):
        self._work = _Pool(
            WORK_POOL,
            "DLROVER_TPU_SERVICER_MAX_INFLIGHT",
            "DLROVER_TPU_SERVICER_QUEUE_TIMEOUT_S",
        )
        self._wait = _Pool(
            WAIT_POOL,
            "DLROVER_TPU_SERVICER_MAX_WAITERS",
            "DLROVER_TPU_SERVICER_QUEUE_TIMEOUT_S",
        )

    def _pool(self, wait: bool) -> _Pool:
        return self._wait if wait else self._work

    def admit(self, method: str, wait: bool = False) -> Optional[_Pool]:
        """Returns the pool to release, or None when the request must be
        rejected with an overload response."""
        from dlrover_tpu_torch import chaos

        pool = self._pool(wait)
        fault = chaos.point("servicer.admission", method=method,
                            pool=pool.name)
        forced = fault is not None and fault.kind in (chaos.DROP, chaos.FLAP)
        if not forced and pool.try_acquire():
            return pool
        # mark the shed on the server span the servicer already opened,
        # so an OVERLOADED reply is attributable in the merged timeline
        trace.add_event("admission.reject", method=method, pool=pool.name,
                        forced=forced)
        obs_metrics.record_overload(method, pool.name)
        return None

    def retry_after_s(self, wait: bool = False) -> float:
        """Backpressure hint: base pause scaled by how crowded the pool
        is — deeper backlog, longer hint — so the shed load spreads out
        instead of returning as one synchronized wave."""
        from dlrover_tpu_torch.common import envs

        base = envs.get_float("DLROVER_TPU_SERVICER_RETRY_AFTER_S")
        pool = self._pool(wait)
        inflight, queued = pool.depth()
        crowd = queued / max(1.0, float(inflight + 1))
        return round(base * (1.0 + min(4.0, crowd)), 3)


