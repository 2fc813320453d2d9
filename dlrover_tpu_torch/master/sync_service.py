"""Named barrier / join synchronization across workers.

Copy of ``dlrover_tpu/master/sync_service.py``, its imports the port's.

The JAX package's counterpart of DLRover's
``dlrover/python/master/elastic_training/sync_service.py:117``.
"""

import threading
from typing import Dict, Set


class SyncService:
    def __init__(self):
        self._lock = threading.Lock()
        self._syncs: Dict[str, Set[int]] = {}
        self._finished_syncs: Set[str] = set()
        self._barriers: Set[str] = set()

    def join_sync(self, sync_name: str, node_id: int, expected: int) -> bool:
        """A worker joins a named sync; returns True once all expected did."""
        with self._lock:
            members = self._syncs.setdefault(sync_name, set())
            members.add(node_id)
            if len(members) >= expected:
                self._finished_syncs.add(sync_name)
            return sync_name in self._finished_syncs

    def sync_finished(self, sync_name: str) -> bool:
        with self._lock:
            return sync_name in self._finished_syncs

    def finish_sync(self, sync_name: str):
        with self._lock:
            self._finished_syncs.add(sync_name)

    def notify_barrier(self, barrier_name: str):
        with self._lock:
            self._barriers.add(barrier_name)

    def barrier_ready(self, barrier_name: str) -> bool:
        with self._lock:
            return barrier_name in self._barriers

    def remove_barrier(self, barrier_name: str):
        with self._lock:
            self._barriers.discard(barrier_name)
