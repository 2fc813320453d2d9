"""Unified retry/deadline policy: exponential backoff + jitter +
overall deadline + circuit breaker.

Copy of ``dlrover_tpu/common/retry.py``, its imports the port's, with
the one policy the port's paths use, the agent's transport
(``master_rpc_policy``); the reference's cross-role, drill and respawn
policies come with the port of their callers.

One policy object replaces the repo's ad-hoc retry shapes (the
``@retry`` decorator in ``agent/master_client.py``, hand-rolled
``backoff = min(8, backoff*2)`` loops in ``unified/``, the goodput
drill's linear attempt loop).  Why each ingredient exists:

* **Jitter** (AWS-style; `full` = U[0, c], `equal` = U[c/2, c]).  A master
  restart is observed by EVERY agent at the same instant; a
  deterministic 0.5·2^n schedule then synchronizes all their retries
  into simultaneous waves that hammer the recovering master
  (thundering herd).  Jitter spreads the wave; policies sized to
  outlast a known outage window (the master transport) use ``equal``
  so the cumulative schedule keeps a guaranteed floor of half the
  deterministic budget.  ``jitter="none"`` restores the deterministic
  schedule for tests.
* **Overall deadline.**  Attempt counts bound *calls*, not *time*: a
  transport whose own timeout is 30s can stretch 8 attempts into
  minutes.  The deadline caps wall clock regardless of where time went,
  and the last sleep is trimmed to never overshoot it.
* **Circuit breaker.**  When a dependency is hard-down, retrying every
  call multiplies load and latency.  After ``cb_threshold`` consecutive
  exhausted calls the breaker opens and calls fail fast with
  :class:`CircuitOpenError` until ``cb_cooldown_s`` passes; the first
  call after cooldown is the half-open probe — success closes the
  breaker, failure re-opens it.  ``cb_threshold=0`` disables.

Budgets ride env knobs (registered in ``common/envs.py``) so operators
can tune without code changes: see ``master_rpc_policy()``.
"""

import random
import threading
import time
from typing import Callable, Iterator, Optional, Tuple, Type

from dlrover_tpu_torch.common.log import logger

_JITTERS = ("full", "equal", "none")


def _observe(kind: str, policy: str, what: str) -> None:
    """Fire a RED counter + a trace-span event for retry/breaker
    activity.  Best-effort by construction: observability must never
    change retry semantics."""
    try:
        from dlrover_tpu_torch.observability import metrics, trace

        if kind == "retry":
            metrics.record_retry(policy, what)
            trace.add_event("retry." + what, policy=policy)
        else:
            metrics.record_breaker(policy, what)
            trace.add_event("breaker." + what, policy=policy)
    except Exception:  # noqa: BLE001 - instrumentation only
        pass


class CircuitOpenError(RuntimeError):
    """Fail-fast signal: the breaker is open, the call was not tried."""


class OverloadedError(RuntimeError):
    """The server admitted nothing: its work queue was full and it
    answered with a retry-after hint instead of doing the work.  Raised
    by clients on an ``OVERLOADED`` response so the policy retries the
    call — and :meth:`RetryPolicy.call` honors ``retry_after_s`` as the
    next gap (jittered upward to spread the herd) instead of its own
    backoff schedule.  The request was NOT executed server-side, so
    retrying is always safe."""

    def __init__(self, message: str = "server overloaded",
                 retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class CircuitBreaker:
    """Consecutive-failure breaker shared by every call through one
    policy instance.  Thread-safe; failures here are *exhausted retry
    budgets*, not individual attempt errors."""

    def __init__(self, threshold: int, cooldown_s: float, name: str = ""):
        self.threshold = max(0, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self.name = name
        self._mu = threading.Lock()
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._probing = False

    def allow(self) -> bool:
        """True if a call may proceed (closed, or half-open probe)."""
        if self.threshold == 0:
            return True
        probe = False
        with self._mu:
            if self._opened_at is None:
                return True
            if time.monotonic() - self._opened_at >= self.cooldown_s:
                if not self._probing:
                    self._probing = True  # exactly one half-open probe
                    probe = True
        if probe:
            _observe("breaker", self.name, "half_open")
            return True
        return False

    def record_success(self) -> None:
        if self.threshold == 0:
            return
        with self._mu:
            was_open = self._opened_at is not None
            self._failures = 0
            self._opened_at = None
            self._probing = False
        if was_open:
            _observe("breaker", self.name, "closed")

    def abort_probe(self) -> None:
        """The half-open probe ended without a recorded outcome (the
        call raised outside the policy's retryable set).  Re-open the
        probe window so a later call can try again — without this the
        breaker would stay open forever."""
        if self.threshold == 0:
            return
        with self._mu:
            self._probing = False

    def record_failure(self) -> None:
        if self.threshold == 0:
            return
        opened = False
        with self._mu:
            self._failures += 1
            if self._failures >= self.threshold:
                if self._opened_at is None:
                    opened = True
                    logger.warning(
                        "circuit breaker OPEN after %d consecutive "
                        "failures (cooldown %.1fs)",
                        self._failures, self.cooldown_s,
                    )
                self._opened_at = time.monotonic()
                self._probing = False
        if opened:
            _observe("breaker", self.name, "open")

    @property
    def open(self) -> bool:
        with self._mu:
            return self._opened_at is not None


class RetryPolicy:
    """Exponential backoff with jitter, bounded by attempts AND a wall
    deadline, with an optional shared circuit breaker.

    ``attempts=8, base_s=0.5, multiplier=2, max_s=8`` reproduces the old
    master-client budget (worst-case sleeps 0.5+1+2+4+8+8+8 ≈ 31.5s;
    with jitter the expectation shrinks but equal jitter keeps a
    ≥half floor and the deadline still bounds the tail).
    """

    def __init__(
        self,
        attempts: int = 3,
        base_s: float = 1.0,
        multiplier: float = 2.0,
        max_s: float = 8.0,
        deadline_s: float = 0.0,
        jitter: str = "full",
        retry_on: Tuple[Type[BaseException], ...] = (Exception,),
        cb_threshold: int = 0,
        cb_cooldown_s: float = 30.0,
        name: str = "",
        rng: Optional[random.Random] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if jitter not in _JITTERS:
            raise ValueError(f"jitter {jitter!r} not in {_JITTERS}")
        self.attempts = max(1, int(attempts))
        self.base_s = max(0.0, float(base_s))
        self.multiplier = max(1.0, float(multiplier))
        self.max_s = float(max_s)
        self.deadline_s = float(deadline_s)
        self.jitter = jitter
        self.retry_on = retry_on
        self.name = name
        self.breaker = CircuitBreaker(cb_threshold, cb_cooldown_s, name=name)
        self._rng = rng or random.Random()
        self._sleep = sleep

    # -- schedule ----------------------------------------------------------

    def intervals(self) -> Iterator[float]:
        """The UNJITTERED backoff ceiling per retry gap (attempts-1
        values)."""
        interval = self.base_s
        for _ in range(self.attempts - 1):
            yield min(interval, self.max_s) if self.max_s else interval
            interval *= self.multiplier

    def _gap(self, ceiling: float) -> float:
        if self.jitter == "full":
            return self._rng.uniform(0.0, ceiling)
        if self.jitter == "equal":
            # AWS "equal jitter": U[c/2, c].  Half the spread of full
            # jitter, but the cumulative schedule keeps a guaranteed
            # floor of half the deterministic budget — policies sized to
            # ride out a known outage window (master restart) need that
            # minimum; pure full jitter's low tail can exhaust all
            # attempts in seconds
            return ceiling / 2.0 + self._rng.uniform(0.0, ceiling / 2.0)
        return ceiling

    def sleeps(self, deadline: Optional[float] = None) -> Iterator[float]:
        """Jittered sleep durations, deadline-trimmed.  For callers that
        drive their own loop (respawn supervisors): iterate and sleep —
        the iterator stops when the budget (attempts or deadline) is
        exhausted."""
        for ceiling in self.intervals():
            gap = self._gap(ceiling)
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                gap = min(gap, remaining)
            yield gap

    # -- calling -----------------------------------------------------------

    def call(self, fn: Callable, *args, **kwargs):
        """Run ``fn`` under this policy; re-raises the last error when
        the budget is exhausted."""
        if not self.breaker.allow():
            raise CircuitOpenError(
                f"{self.name or getattr(fn, '__name__', 'call')}: circuit "
                f"open (cooldown {self.breaker.cooldown_s:.1f}s)"
            )
        deadline = (
            time.monotonic() + self.deadline_s if self.deadline_s else None
        )
        last: Optional[BaseException] = None
        gaps = self.sleeps(deadline)
        for attempt in range(1, self.attempts + 1):
            try:
                result = fn(*args, **kwargs)
            except self.retry_on as e:
                last = e
                logger.warning(
                    "%s failed (attempt %d/%d): %s",
                    self.name or getattr(fn, "__name__", "call"),
                    attempt, self.attempts, e,
                )
                _observe(
                    "retry",
                    self.name or getattr(fn, "__name__", "call"),
                    "attempt_failed",
                )
                if attempt >= self.attempts:
                    break
                if deadline is not None and time.monotonic() >= deadline:
                    logger.warning(
                        "%s: retry deadline (%.1fs) exhausted after "
                        "attempt %d/%d",
                        self.name or getattr(fn, "__name__", "call"),
                        self.deadline_s, attempt, self.attempts,
                    )
                    break
                gap = next(gaps, None)
                if gap is None:
                    break
                hint = float(getattr(e, "retry_after_s", 0.0) or 0.0)
                if hint > 0:
                    # server backpressure wins over the local schedule:
                    # the master told us when its queue will have room.
                    # Jitter UPWARD only (the hint is a floor, not a
                    # target — arriving early re-overloads), trimmed to
                    # the wall deadline like every other gap.
                    gap = hint
                    if self.jitter != "none":
                        gap += self._rng.uniform(0.0, hint / 4.0)
                    if deadline is not None:
                        gap = min(gap, max(0.0, deadline - time.monotonic()))
                    _observe(
                        "retry",
                        self.name or getattr(fn, "__name__", "call"),
                        "retry_after_honored",
                    )
                if gap > 0:
                    self._sleep(gap)
            except BaseException:
                # not retryable under this policy: propagate — but a
                # half-open breaker probe must not be stranded without
                # an outcome, or the breaker stays open with no path
                # back to closed
                self.breaker.abort_probe()
                raise
            else:
                self.breaker.record_success()
                if attempt > 1:
                    _observe(
                        "retry",
                        self.name or getattr(fn, "__name__", "call"),
                        "recovered",
                    )
                return result
        if isinstance(last, OverloadedError):
            # an overload refusal is a LIVE master shedding load, not a
            # failing dependency: it must not open the breaker.  An
            # open breaker would convert backpressure into
            # CircuitOpenError, which the wait-loop ride-outs
            # (kv_store_wait / wait_comm_world / fetch_shard) do not
            # retry — sustained overload would hard-fail waits the
            # admission design promises to only slow down.  A breaker
            # already open from REAL failures still gets its half-open
            # probe window back.
            self.breaker.abort_probe()
        else:
            self.breaker.record_failure()
        _observe(
            "retry", self.name or getattr(fn, "__name__", "call"),
            "exhausted",
        )
        assert last is not None
        raise last

    def wrap(self, fn: Callable) -> Callable:
        """Decorator form: ``@policy.wrap``."""
        import functools

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)

        wrapped.__retry_policy__ = self
        return wrapped


# ---------------------------------------------------------------------------
# Named policies.  Budgets are env knobs so every deployment can tune
# them; defaults preserve the budgets the ad-hoc code shipped with.
# Policies are built per call (cheap) but each SITE should hold ONE
# instance when it wants a shared circuit breaker.
# ---------------------------------------------------------------------------


def master_rpc_policy(name: str = "master_rpc") -> RetryPolicy:
    """Agent->master transport: ride out a master restart-on-same-port
    (~30s worst case on a loaded box) yet fail finitely when the master
    is truly gone.  Matches the old ``@retry(8, 0.5, backoff=2, max=8)``
    budget, now with equal jitter (guaranteed ≥half-budget floor) and
    a hard wall deadline."""
    from dlrover_tpu_torch.common import envs

    return RetryPolicy(
        attempts=envs.get_int("DLROVER_TPU_RPC_RETRY_ATTEMPTS"),
        base_s=envs.get_float("DLROVER_TPU_RPC_RETRY_BASE_S"),
        multiplier=2.0,
        max_s=envs.get_float("DLROVER_TPU_RPC_RETRY_MAX_S"),
        deadline_s=envs.get_float("DLROVER_TPU_RPC_RETRY_DEADLINE_S"),
        # equal jitter, not full: the schedule is sized to outlast a
        # master restart window, so it must keep a guaranteed floor
        # (half the deterministic ~31.5s) while still spreading the herd
        jitter=(
            "equal" if envs.get_bool("DLROVER_TPU_RETRY_JITTER") else "none"
        ),
        cb_threshold=envs.get_int("DLROVER_TPU_RETRY_CB_THRESHOLD"),
        cb_cooldown_s=envs.get_float("DLROVER_TPU_RETRY_CB_COOLDOWN_S"),
        name=name,
    )
