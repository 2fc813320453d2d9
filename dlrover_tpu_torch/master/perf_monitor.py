"""Training performance monitor (goodput accounting).

Copy of ``dlrover_tpu/master/perf_monitor.py``, its imports the port's.

The JAX package's counterpart of DLRover's ``dlrover/python/master/monitor/perf_monitor.py``
(``collect_global_step:84``, ``running_speed:132``) — collects global-step
reports from workers, derives throughput, tracks world-size changes, and
feeds hang detection (no step progress) and the resource optimizer.
"""

import threading
import time
from dataclasses import dataclass
from typing import List, Optional

from dlrover_tpu_torch.common import envs

@dataclass
class GlobalStepRecord:
    timestamp: float
    step: int
    worker_num: int


def _default_stall_threshold() -> float:
    """Env-tunable floor for counting a step-report gap as downtime
    (``DLROVER_TPU_STALL_THRESHOLD``).  Fast-cadence drills lower it so
    short recoveries are charged honestly instead of hiding under the
    15s default."""
    return envs.get_float("DLROVER_TPU_STALL_THRESHOLD")


class PerfMonitor:
    def __init__(self, max_records: int = 600,
                 stall_threshold_secs: Optional[float] = None):
        if stall_threshold_secs is None:
            stall_threshold_secs = _default_stall_threshold()
        self._lock = threading.Lock()
        self._max_records = max_records
        self.stall_threshold_secs = stall_threshold_secs
        self._records: List[GlobalStepRecord] = []
        self._worker_num = 0
        self._start_training_time = 0.0
        self._total_downtime = 0.0
        self._init_time = time.time()

    def set_worker_num(self, num: int):
        with self._lock:
            self._worker_num = num

    def add_running_worker(self):
        with self._lock:
            self._worker_num += 1

    def remove_running_worker(self):
        with self._lock:
            self._worker_num = max(0, self._worker_num - 1)

    @property
    def worker_num(self) -> int:
        return self._worker_num

    def collect_global_step(self, step: int, timestamp: Optional[float] = None):
        with self._lock:
            ts = timestamp or time.time()
            if not self._records and self._start_training_time == 0.0:
                self._start_training_time = ts
            if self._records and ts <= self._records[-1].timestamp:
                # an out-of-order report (a slow worker's queued
                # pre-stall report landing AFTER the recovery report):
                # resetting the gap baseline backwards would charge the
                # same stall window twice on the next report.  Keep the
                # step watermark, drop the stale timestamp.
                last = self._records[-1]
                if step > last.step:
                    self._records[-1] = GlobalStepRecord(
                        last.timestamp, step, last.worker_num
                    )
                return
            if self._records:
                # downtime accrues automatically from report gaps: a gap
                # far beyond the recent step cadence is a stall/restart
                # (worker crash -> rendezvous -> resume), and the excess
                # over one normal interval is lost wall-clock.  This is
                # what makes goodput() a real number instead of 1.0 —
                # the reference's headline metric (README.md:61-67,
                # goodput 69%->95%) is exactly this accounting.
                gap = ts - self._records[-1].timestamp
                cadence = self._recent_interval_locked()
                threshold = max(self.stall_threshold_secs, 5.0 * cadence)
                if cadence > 0 and gap > threshold:
                    self._total_downtime += gap - cadence
            self._records.append(GlobalStepRecord(ts, step, self._worker_num))
            if len(self._records) > self._max_records:
                self._records.pop(0)

    def _recent_interval_locked(self, window: int = 8) -> float:
        """Median interval between recent step reports (0 if unknown)."""
        recent = self._records[-window:]
        gaps = [
            b.timestamp - a.timestamp
            for a, b in zip(recent, recent[1:])
            if b.timestamp > a.timestamp
        ]
        if not gaps:
            return 0.0
        gaps.sort()
        return gaps[len(gaps) // 2]

    def running_speed(self, window: int = 10) -> float:
        """Steps/second over the trailing window of reports."""
        with self._lock:
            if len(self._records) < 2:
                return 0.0
            recent = self._records[-window:]
            dt = recent[-1].timestamp - recent[0].timestamp
            dstep = recent[-1].step - recent[0].step
            return dstep / dt if dt > 0 else 0.0

    @property
    def completed_global_step(self) -> int:
        with self._lock:
            return self._records[-1].step if self._records else 0

    def last_step_time(self) -> float:
        with self._lock:
            return self._records[-1].timestamp if self._records else 0.0

    def step_stalled(self, downtime_secs: float) -> bool:
        """True if steps were being reported but stopped for downtime_secs."""
        with self._lock:
            if not self._records:
                return False
            return time.time() - self._records[-1].timestamp > downtime_secs

    def worker_num_changed(self, window: int = 5) -> bool:
        with self._lock:
            recent = self._records[-window:]
            return len({r.worker_num for r in recent}) > 1

    def add_downtime(self, secs: float):
        with self._lock:
            self._total_downtime += secs

    def goodput(self) -> float:
        """Fraction of wall-clock spent making step progress.

        Lost time = startup (job launch -> first step report) + every
        stall window inferred from step-report gaps + explicit
        ``add_downtime`` charges."""
        with self._lock:
            wall = time.time() - self._init_time
            if wall <= 0:
                return 0.0
            lost = self._total_downtime
            if self._start_training_time > 0:
                lost += self._start_training_time - self._init_time
            else:
                lost = wall  # never trained: everything so far is lost
            return max(0.0, min(1.0, (wall - lost) / wall))

    def training_goodput(self) -> float:
        """Goodput over the TRAINING window: first step report -> last
        step report, charged with every inferred stall.

        The headline ``goodput()`` includes job startup, which the
        reference's production number (README.md:61-67, 69%->95%)
        amortizes over days — a minutes-long fault drill would be
        measuring startup, not fault tolerance.  This window isolates
        what fault handling actually controls: how much of the training
        span was spent making step progress."""
        with self._lock:
            if self._start_training_time <= 0 or not self._records:
                return 0.0
            wall = self._records[-1].timestamp - self._start_training_time
            if wall <= 0:
                return 0.0
            return max(
                0.0, min(1.0, (wall - self._total_downtime) / wall)
            )
