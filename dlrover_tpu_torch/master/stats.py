"""Job runtime stats records.

Copy of ``LocalStatsReporter`` from ``dlrover_tpu/master/stats.py``, the
counterpart of DLRover's ``dlrover/python/master/stats/reporter.py:99``:
a bounded list of throughput/goodput/world-size records kept on the
master, which the dashboard's ``/stats`` reads.  The reference's
``BrainReporter`` and ``JobMetricCollector`` wait for the brain and the
distributed master that create them (ROADMAP item 11, the rest).
"""

import threading
from typing import Dict, List


class LocalStatsReporter:
    def __init__(self, max_records: int = 1000):
        self._records: List[Dict] = []
        self._max = max_records
        self._lock = threading.Lock()

    def report(self, record: Dict):
        with self._lock:
            self._records.append(record)
            if len(self._records) > self._max:
                self._records.pop(0)

    def records(self) -> List[Dict]:
        with self._lock:
            return list(self._records)
