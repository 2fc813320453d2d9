"""Coalescing for identical concurrent blocking waits.

Copy of ``dlrover_tpu/common/coalesce.py``, its imports the port's.

Shared by both ends of the long-poll protocol: the master's servicer
(N agents long-polling one kv key drive ONE store wait) and the client
(N threads in one process waiting the same key share ONE in-flight
RPC).  Group keys are tuples whose first element names the wait kind
(``("kv", key, min_value)``) — the kind labels the coalesced counter.
"""

import threading
from typing import Any, Callable, Dict


class WaitHub:
    """``wait(key, leader_fn, timeout)``: the first caller per key
    becomes the *leader* and runs ``leader_fn`` (the real blocking
    wait); every concurrent caller with the same key parks on the
    group's Event and receives the leader's result.  A follower whose
    own timeout expires first returns ``default`` (an expired long-poll
    chunk — the caller re-issues, possibly as the new leader).  If the
    leader raises, followers get ``default`` and re-poll: nothing is
    silently dropped, the retry path just runs."""

    def __init__(self):
        self._mu = threading.Lock()
        self._groups: Dict[Any, Dict[str, Any]] = {}

    def wait(
        self,
        key: Any,
        leader_fn: Callable[[], Any],
        timeout: float,
        default: Any = b"",
    ) -> Any:
        from dlrover_tpu_torch.observability import metrics as obs_metrics

        with self._mu:
            group = self._groups.get(key)
            if group is None:
                group = {"event": threading.Event(), "result": default}
                self._groups[key] = group
                leader = True
            else:
                leader = False
        if leader:
            try:
                group["result"] = leader_fn()
            finally:
                with self._mu:
                    self._groups.pop(key, None)
                group["event"].set()
            return group["result"]
        obs_metrics.record_longpoll_coalesced(str(key[0]))
        if group["event"].wait(max(0.0, timeout)):
            return group["result"]
        return default
