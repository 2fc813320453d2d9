"""Process-global training-step clock: the feedback signal for paced
checkpoint staging.

Copy of ``dlrover_tpu/utils/step_clock.py``; the port's ``Trainer.
train_step`` ticks it.

``Trainer.train_step`` records the wall-time between successive step
dispatches; the flash-checkpoint stager's auto-pacer
(``trainer/flash_checkpoint/snapshot.py``) reads it to keep step-latency
inflation during device->host staging under a bounded factor instead of
relying on a hand-set pacing knob.

Limitation (documented, inherent): the clock sees the *training thread's*
cadence.  A loop that never blocks on device results (no metric fetch, no
``block_until_ready``) dispatches steps in microseconds regardless of
device load, so the calm baseline collapses toward zero — and against a
microsecond baseline, routine scheduler jitter looks like massive
"inflation".  The pacer therefore FLOORS the usable baseline
(``snapshot._MIN_BASELINE_S``): below the floor it treats the cadence
signal as meaningless and stages unpaced (the trainer is not waiting on
the device, so staging speed costs it nothing observable).  Every
in-tree loop (Trainer users fetch the loss each step) provides a real
baseline naturally.
"""

import threading
import time
from collections import deque
from typing import List, Optional

_MAX_CALM = 32
_MAX_RECENT = 64


class StepClock:
    def __init__(self):
        self._mu = threading.Lock()
        # (monotonic_ts, duration) of steps recorded while NOT staging
        self._calm = deque(maxlen=_MAX_CALM)
        # all recent steps, staging or not
        self._recent = deque(maxlen=_MAX_RECENT)
        self._staging = 0
        self._last_ts: Optional[float] = None

    # -- producer (Trainer) ------------------------------------------------

    def record(self, duration: float) -> None:
        now = time.monotonic()
        with self._mu:
            self._last_ts = now
            self._recent.append((now, duration))
            if self._staging == 0:
                self._calm.append(duration)

    def reset(self) -> None:
        """Forget history — call when the step function changes (new
        model/mesh/accumulation), so a stale baseline from a different
        program never judges the new one."""
        with self._mu:
            self._calm.clear()
            self._recent.clear()
            self._last_ts = None

    # -- staging bookkeeping ----------------------------------------------

    def staging_started(self) -> None:
        with self._mu:
            self._staging += 1

    def staging_finished(self) -> None:
        with self._mu:
            self._staging = max(0, self._staging - 1)

    # -- consumer (pacer) --------------------------------------------------

    def baseline(self) -> Optional[float]:
        """Median calm step seconds; None until >=2 samples exist."""
        with self._mu:
            calm = sorted(self._calm)
        if len(calm) < 2:
            return None
        return calm[len(calm) // 2]

    def steps_since(self, ts: float) -> List[float]:
        with self._mu:
            return [d for t, d in self._recent if t > ts]

    def idle(self, now: Optional[float] = None) -> bool:
        """True when training appears paused: no step recorded within
        max(5s, 4x baseline) — the pacer may then run at full speed."""
        now = time.monotonic() if now is None else now
        with self._mu:
            last = self._last_ts
        if last is None:
            return True
        base = self.baseline()
        window = max(5.0, 4.0 * base) if base else 5.0
        return (now - last) > window


_clock: Optional[StepClock] = None
_clock_mu = threading.Lock()


def get_step_clock() -> StepClock:
    global _clock
    with _clock_mu:
        if _clock is None:
            _clock = StepClock()
        return _clock
