"""Master-side key-value store.

Copy of ``dlrover_tpu/master/kv_store.py``, its imports the port's. Its
three chaos points (``kv_server.set``, ``.get``, ``.wait``) are comments
where they would fire: the port has no chaos engine yet (ROADMAP item 7,
the rest).

The JAX package's counterpart of DLRover's
``dlrover/python/master/elastic_training/kv_store_service.py:45``.  On GPU
this backs the torchelastic c10d Store; here it is the coordination
substrate under ``jax.distributed.initialize`` bootstrap (workers publish /
discover the coordinator address and barrier tokens through it) and under
user-level barriers.
"""

import threading
import time
import uuid
from typing import Dict, List

from dlrover_tpu_torch.observability import trace

# Reserved key holding a random id minted when THIS store instance was
# constructed.  The store lives in the master process, so the epoch
# changes exactly when a master recovery re-seeds the per-key seq
# counters — consumers (RoleChannel, RoleRpcServer) compare it to detect
# a reset even when post-recovery publishes have already pushed a
# counter back to (or past) their in-memory watermark.
KV_EPOCH_KEY = "__kv_epoch__"


class KVStoreService:
    def __init__(self):
        self._lock = threading.Lock()
        self._store: Dict[str, bytes] = {
            KV_EPOCH_KEY: uuid.uuid4().hex.encode()
        }
        self._cond = threading.Condition(self._lock)

    def set(self, key: str, value: bytes):
        # child of the servicer's server span (same thread/context):
        # master-side kv latency becomes visible under the RPC it served
        with trace.span("kv_server.set", attrs={"key": key}):
            # chaos point "kv_server.set" (DROP/FLAP: a lost write; item 7)
            with self._cond:
                self._store[key] = value
                self._cond.notify_all()

    def get(self, key: str) -> bytes:
        with trace.span("kv_server.get", attrs={"key": key}):
            # chaos point "kv_server.get" (DROP/FLAP: key absent; item 7)
            with self._lock:
                return self._store.get(key, b"")

    def wait(self, key: str, timeout: float = 60.0,
             min_value: int = 0) -> bytes:
        """Block until the key exists (rendezvous-style).

        ``min_value > 0`` waits on a *counter* instead: the slot must
        exist AND parse to an int >= ``min_value`` (the exit-barrier /
        ``add`` companion).  Every mutation notifies the store's
        Condition, so this is the server half of the long-poll protocol
        — one blocked RPC replaces a client's sleep-poll loop."""
        # the master-side kv wait IS the stall a blocked consumer sees:
        # trace it so a rendezvous hang points at the key it waited on
        with trace.span("kv_server.wait", attrs={"key": key}) as sp:
            # chaos point "kv_server.wait" (DROP/FLAP: a timeout; item 7)
            deadline = time.time() + timeout
            with self._cond:
                while not self._ready(key, min_value):
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        sp.add_event(
                            "kv.wait_timeout", key=key, timeout_s=timeout
                        )
                        return b""
                    self._cond.wait(remaining)
                return self._store[key]

    def _ready(self, key: str, min_value: int) -> bool:
        """Wait predicate; caller holds the lock."""
        if key not in self._store:
            return False
        if min_value <= 0:
            return True
        try:
            return int(self._store[key] or b"0") >= min_value
        except ValueError:
            return True  # non-counter slot: existence is readiness

    def add(self, key: str, amount: int) -> int:
        """Atomic counter add; value stored as decimal ASCII."""
        with self._cond:
            current = int(self._store.get(key, b"0") or b"0")
            current += amount
            self._store[key] = str(current).encode()
            self._cond.notify_all()
            return current

    def put_indexed(self, key: str, value: bytes) -> int:
        """Atomically assign the next sequence number for ``key`` and
        store ``seq|value`` in the slot — one critical section, so
        concurrent producers can never regress the slot to an older
        payload (the RoleChannel latest-wins contract).  Returns the
        assigned seq."""
        with self._cond:
            seq = int(self._store.get(key + "/seq", b"0") or b"0") + 1
            self._store[key + "/seq"] = str(seq).encode()
            self._store[key] = str(seq).encode() + b"|" + value
            self._cond.notify_all()
            return seq

    def multi_get(self, keys: List[str]) -> Dict[str, bytes]:
        with self._lock:
            return {k: self._store.get(k, b"") for k in keys}

    def multi_set(self, kvs: Dict[str, bytes]):
        with self._cond:
            self._store.update(kvs)
            self._cond.notify_all()

    def delete(self, key: str) -> bool:
        with self._lock:
            return self._store.pop(key, None) is not None

    def clear(self):
        with self._lock:
            self._store.clear()
            # a cleared-and-reused store resets every seq counter exactly
            # like a master recovery does; re-seed a FRESH epoch so
            # consumers' epoch-based reset detection fires instead of
            # reading an empty epoch as "no signal" and falling back to
            # the lossier seq-regression heuristic
            self._store[KV_EPOCH_KEY] = uuid.uuid4().hex.encode()
