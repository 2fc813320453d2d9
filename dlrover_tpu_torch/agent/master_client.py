"""The single RPC client used by agent AND training processes.

Copy of ``dlrover_tpu/agent/master_client.py``, itself the counterpart of
DLRover's ``dlrover/python/elastic_agent/master_client.py``
(``MasterClient:46``, ``join_rendezvous:393``, ``report_heart_beat:238``,
``kv_store_*:89-118``, ``build_master_client:721``, ``HttpMasterClient:610``):
one typed facade over the master's report/get demux, with gRPC (default)
and HTTP flavors.  The wire is the reference's (the envelope, the
``/report`` and ``/get`` routes, the ``dlrover_tpu.Master`` gRPC
service), so a port agent talks to a reference master and back.

What differs from the copy: the chaos points are comments where they
would fire (the port has no chaos engine, ROADMAP item 7, the rest), and
``grpc`` is imported inside ``GrpcMasterClient`` as in the reference.
"""

import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from dlrover_tpu_torch.common import coalesce
from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.common import retry as retry_mod
from dlrover_tpu_torch.common.serialize import (
    deserialize_message,
    serialize_message,
)
from dlrover_tpu_torch.observability import trace
from dlrover_tpu_torch.common.constants import (
    CommunicationType,
    NodeEnv,
    NodeType,
    RendezvousName,
    GRPC_MAX_MESSAGE_LENGTH,
)
from dlrover_tpu_torch.common.log import logger


def ride_out_overload(
    e: retry_mod.OverloadedError, deadline: Optional[float] = None
) -> None:
    """An :class:`OverloadedError` escaping a wait RPC means the retry
    policy's attempt budget burned out on admission refusals — seconds
    of hint-paced attempts.  That is NOT a failure of the WAIT: the
    master is alive (it answered with a hint) and the wait has its own,
    much longer deadline.  Sleep the hint (jittered upward — the hint
    is a floor, arriving early re-overloads) and let the caller
    re-issue until ITS deadline; without this, a sustained overload
    hard-fails every overflow agent's rendezvous/barrier wait in
    seconds instead of degrading gracefully."""
    gap = max(0.25, e.retry_after_s)
    gap += random.uniform(0.0, gap / 4.0)
    if deadline is not None:
        gap = min(gap, deadline - time.time())
    if gap > 0:
        t0 = time.time()
        time.sleep(gap)
        try:
            from dlrover_tpu_torch.observability import goodput

            goodput.charge_interval("overload_rideout", t0, time.time())
        except Exception:  # noqa: BLE001 - the ledger must never break
            pass  # an overload ride-out


def pace_reissue(t0: float, floor: float) -> None:
    """An error reply to a long-poll comes back WITHOUT blocking
    server-side (dispatch failure, chaos drop, master restarting);
    re-issuing immediately would turn every waiter into a full-speed
    RPC storm — exactly the herd long-poll exists to kill.  Sleep out
    the remainder of the legacy poll interval (``floor``) measured
    from ``t0``; a genuinely-blocked chunk already consumed it."""
    gap = floor - (time.time() - t0)
    if gap > 0:
        time.sleep(gap)


class MasterClient:
    """Base client: subclasses implement the two raw calls."""

    _instance: Optional["MasterClient"] = None
    _instance_lock = threading.Lock()

    def __init__(self, master_addr: str, node_id: int,
                 node_type: str = NodeType.WORKER):
        self._master_addr = master_addr
        self._node_id = node_id
        self._node_type = node_type
        # One policy instance per client: the circuit breaker (when the
        # DLROVER_TPU_RETRY_CB_* knobs enable it) must see EVERY call's
        # outcome, and equal jitter (U[c/2, c]: herd spread with a
        # guaranteed half-budget floor) desynchronizes the agents' retries
        # when they all observe the same master restart.  The budget
        # (8 attempts, 0.5s base doubling to an 8s cap — ~30s worst
        # case) rides out a master restart-on-same-port yet still fails
        # finitely when the master is truly gone.
        self._retry = retry_mod.master_rpc_policy(
            name=f"master_rpc[{node_type}:{node_id}]"
        )
        # transport accounting: every raw call counts here (fleet_bench
        # reads these to compare poll vs long-poll RPC volume); on_rpc
        # is an optional per-call hook (method, dur_s, ok)
        self.rpc_count = 0
        self._rpc_mu = threading.Lock()
        self.on_rpc: Optional[Any] = None
        # flips False the first time the server answers a long-poll
        # request with "unknown get request" — an older master; every
        # wait then falls back to the legacy sleep-poll loop
        self._server_longpoll = True
        # threads of THIS process waiting the same key share one
        # in-flight long-poll RPC
        self._wait_hub = coalesce.WaitHub()

    def _note_rpc(self, method: str, dur_s: float, ok: bool) -> None:
        with self._rpc_mu:
            self.rpc_count += 1
        cb = self.on_rpc
        if cb is not None:
            try:
                cb(method, dur_s, ok)
            except Exception:  # noqa: BLE001 - accounting only
                pass

    @staticmethod
    def _raise_if_overloaded(resp: Any) -> None:
        """An OVERLOADED refusal becomes a typed, retryable error so the
        policy waits out the server's hint instead of its own schedule."""
        if (
            isinstance(resp, comm.BaseResponse)
            and not resp.success
            and resp.reason == comm.OVERLOADED
        ):
            raise retry_mod.OverloadedError(
                "master overloaded",
                retry_after_s=getattr(resp, "retry_after_s", 0.0),
            )

    # -- raw transport (subclass) -----------------------------------------

    def _report_raw(self, envelope: bytes) -> bytes:
        raise NotImplementedError

    def _get_raw(self, envelope: bytes) -> bytes:
        raise NotImplementedError

    # -- envelope helpers --------------------------------------------------

    def _envelope(self, payload: Any) -> bytes:
        msg = comm.Message(
            node_type=self._node_type,
            node_id=self._node_id,
            # the traceparent of the LIVE span — _once builds the
            # envelope inside the attempt span, so the master's server
            # span parents to the exact attempt that reached it
            trace_ctx=trace.current_traceparent(),
        )
        msg.pack(payload)
        return msg.to_json()

    def _report(self, payload: Any) -> comm.BaseResponse:
        method = type(payload).__name__

        def _once() -> comm.BaseResponse:
            # each attempt is a CHILD span and the envelope is rebuilt
            # under it: a retried call shows N attempt spans and the
            # server links to the one that got through.  The chaos
            # point "master_client.transport" would sit here, inside the
            # retried unit (ROADMAP item 7, the rest).
            t0, sent = time.monotonic(), False
            try:
                with trace.span(
                    f"rpc.attempt/{method}", kind=trace.CLIENT
                ):
                    envelope = self._envelope(payload)
                    reply = comm.Message.from_json(
                        self._report_raw(envelope)
                    )
                    sent = True
            finally:
                self._note_rpc(method, time.monotonic() - t0, sent)
            resp = reply.unpack()
            self._raise_if_overloaded(resp)
            if not isinstance(resp, comm.BaseResponse):
                return comm.BaseResponse(
                    success=False, reason="bad response type"
                )
            return resp

        with trace.span(
            f"rpc.report/{method}", kind=trace.CLIENT,
            attrs={"node_id": self._node_id},
        ):
            return self._retry.call(_once)

    def _get(self, payload: Any) -> Any:
        method = type(payload).__name__

        def _once() -> Any:
            t0, sent = time.monotonic(), False
            try:
                with trace.span(
                    f"rpc.attempt/{method}", kind=trace.CLIENT
                ):
                    envelope = self._envelope(payload)
                    # chaos point "master_client.transport" (op="get")
                    reply = comm.Message.from_json(self._get_raw(envelope))
                    sent = True
            finally:
                self._note_rpc(method, time.monotonic() - t0, sent)
            resp = reply.unpack()
            self._raise_if_overloaded(resp)
            return resp

        with trace.span(
            f"rpc.get/{method}", kind=trace.CLIENT,
            attrs={"node_id": self._node_id},
        ):
            return self._retry.call(_once)

    # -- typed API ---------------------------------------------------------

    @property
    def master_addr(self) -> str:
        return self._master_addr

    @property
    def node_id(self) -> int:
        return self._node_id

    # rendezvous

    def join_rendezvous(
        self,
        node_rank: int,
        local_world_size: int = 1,
        rdzv_name: str = RendezvousName.TRAINING,
        node_ip: str = "",
        slice_id: int = 0,
        node_unit: int = 1,
    ) -> int:
        resp = self._get(
            comm.JoinRendezvousRequest(
                node_id=self._node_id,
                node_rank=node_rank,
                local_world_size=local_world_size,
                node_ip=node_ip,
                rdzv_name=rdzv_name,
                slice_id=slice_id,
                node_unit=node_unit,
            )
        )
        return resp.round if isinstance(resp, comm.JoinRendezvousResponse) else 0

    def get_comm_world(
        self, rdzv_name: str = RendezvousName.TRAINING
    ) -> comm.CommWorld:
        resp = self._get(
            comm.CommWorldRequest(rdzv_name=rdzv_name, node_id=self._node_id)
        )
        if isinstance(resp, comm.CommWorld):
            return resp
        return comm.CommWorld()

    def wait_comm_world(
        self,
        rdzv_name: str = RendezvousName.TRAINING,
        timeout: float = 60.0,
    ) -> comm.CommWorld:
        """Block (bounded) until a world including this node seals.
        Long-polls the master in DLROVER_TPU_LONGPOLL_MAX_S chunks; on
        an older master, degrades to the legacy 1s get_comm_world poll.
        Returns an empty CommWorld on timeout."""
        deadline = time.time() + max(0.0, timeout)
        world = comm.CommWorld(rdzv_name=rdzv_name)
        while True:
            remaining = deadline - time.time()
            if remaining <= 0:
                return world
            try:
                if self._longpoll_enabled():
                    chunk = min(
                        remaining,
                        envs.get_float("DLROVER_TPU_LONGPOLL_MAX_S"),
                    )
                    t0 = time.time()
                    resp = self._get(comm.RdzvWaitRequest(
                        rdzv_name=rdzv_name,
                        node_id=self._node_id,
                        timeout=chunk,
                    ))
                    if isinstance(resp, comm.CommWorld):
                        world = resp
                        if world.world:
                            return world
                        continue  # chunk expired; re-issue
                    if self._mark_longpoll_unsupported(resp):
                        continue  # re-enter as the legacy poll loop
                    pace_reissue(t0, 1.0)
                    continue
                world = self.get_comm_world(rdzv_name)
                if world.world:
                    return world
                time.sleep(1.0)
            except retry_mod.OverloadedError as e:
                # the wait outlives the RPC retry budget: keep
                # re-issuing at the server's pace until OUR deadline
                ride_out_overload(e, deadline)

    def num_nodes_waiting(
        self, rdzv_name: str = RendezvousName.TRAINING
    ) -> int:
        resp = self._get(
            comm.WaitingNodeNumRequest(
                node_id=self._node_id, rdzv_name=rdzv_name
            )
        )
        return resp.waiting_num if isinstance(resp, comm.WaitingNodeNum) else 0

    # network check

    def report_network_check_result(
        self, normal: bool, elapsed_time: float, err_message: str = ""
    ) -> bool:
        return self._report(
            comm.NetworkCheckResultRequest(
                node_id=self._node_id,
                normal=normal,
                elapsed_time=elapsed_time,
                err_message=err_message,
            )
        ).success

    def check_network_ready(self) -> comm.NetworkStatus:
        resp = self._get(comm.NetworkReadyRequest())
        return resp if isinstance(resp, comm.NetworkStatus) else comm.NetworkStatus()

    def get_network_check_status(self) -> comm.NetworkCheckStatus:
        resp = self._get(comm.StragglerExistRequest())
        if isinstance(resp, comm.NetworkCheckStatus):
            return resp
        return comm.NetworkCheckStatus()

    # kv store
    #
    # The reference's chaos points here model what a kv consumer sees: a
    # dropped get reads as "key not there yet", a dropped set reports
    # failure without reaching the store (ROADMAP item 7, the rest).

    def kv_store_set(self, key: str, value: bytes) -> bool:
        with trace.span("kv.set", kind=trace.CLIENT, attrs={"key": key}):
            # chaos point "kv_store.set" (DROP/FLAP: returns False)
            return self._report(
                comm.KeyValuePair(key=key, value=value)
            ).success

    def kv_store_get(self, key: str) -> bytes:
        with trace.span("kv.get", kind=trace.CLIENT, attrs={"key": key}):
            # chaos point "kv_store.get" (DROP/FLAP: returns b"")
            resp = self._get(comm.KVStoreGetRequest(key=key))
            return resp.value if isinstance(resp, comm.KeyValuePair) else b""

    def _longpoll_enabled(self) -> bool:
        return self._server_longpoll and envs.get_bool("DLROVER_TPU_LONGPOLL")

    def _mark_longpoll_unsupported(self, resp: Any) -> bool:
        """True when ``resp`` is an older master refusing a long-poll
        request type; flips the client to the legacy poll path."""
        if (
            isinstance(resp, comm.BaseResponse)
            and not resp.success
            and "unknown get request" in resp.reason
        ):
            if self._server_longpoll:
                logger.info(
                    "master does not speak long-poll; falling back to "
                    "client-side polling"
                )
            self._server_longpoll = False
            return True
        return False

    def _kv_wait_rpc(self, key: str, timeout: float,
                     min_value: int) -> Optional[bytes]:
        """One long-poll chunk; None = server too old (caller falls
        back).  Identical concurrent waits from this process share the
        in-flight RPC through the client-side WaitHub."""

        def _issue() -> Optional[bytes]:
            resp = self._get(comm.KVStoreWaitRequest(
                key=key, timeout=timeout, min_value=min_value
            ))
            if isinstance(resp, comm.KeyValuePair):
                return resp.value
            if self._mark_longpoll_unsupported(resp):
                return None
            return b""

        return self._wait_hub.wait(
            ("kv", key, min_value), _issue, timeout, default=b""
        )

    def kv_store_wait(self, key: str, timeout: float = 120.0,
                      poll: float = 0.5, min_value: int = 0) -> bytes:
        """Bounded wait for ``key`` (or, with ``min_value``, for its
        counter to reach a threshold).  Long-poll by default: the server
        blocks on its store Condition and one RPC covers up to
        DLROVER_TPU_LONGPOLL_MAX_S of waiting; against an older master
        this degrades to the legacy ``poll``-interval get loop."""
        # ONE span for the whole bounded wait: "how long did the agent
        # sit on this key" is the latency a stalled rendezvous shows
        with trace.span(
            "kv.wait", kind=trace.CLIENT, attrs={"key": key}
        ) as sp:
            deadline = time.time() + timeout
            polls = 0
            while time.time() < deadline:
                try:
                    if self._longpoll_enabled():
                        chunk = min(
                            deadline - time.time(),
                            envs.get_float("DLROVER_TPU_LONGPOLL_MAX_S"),
                        )
                        # chaos point "kv_store.wait" (DROP/FLAP: the
                        # chunk "expires")
                        t0 = time.time()
                        value = self._kv_wait_rpc(key, chunk, min_value)
                        if value == b"":
                            pace_reissue(t0, min(chunk, poll))
                        if value is None:
                            continue  # legacy master: re-enter as poll loop
                        polls += 1
                        if value:
                            sp.set_attr("polls", polls)
                            return value
                        continue  # chunk expired; re-issue until deadline
                    # the legacy-master fallback: kv_store_wait is the
                    # bounded-wait primitive; reads are idempotent
                    value = self.kv_store_get(key)
                    polls += 1
                    if value and (
                        min_value <= 0
                        or self._counter_at_least(value, min_value)
                    ):
                        sp.set_attr("polls", polls)
                        return value
                    time.sleep(poll)
                except retry_mod.OverloadedError as e:
                    # the wait outlives the RPC retry budget: keep
                    # re-issuing at the server's pace until OUR deadline
                    sp.add_event("kv.wait_overloaded", key=key)
                    ride_out_overload(e, deadline)
            sp.set_attr("polls", polls)
            sp.add_event("kv.wait_timeout", key=key, timeout_s=timeout)
            return b""

    @staticmethod
    def _counter_at_least(value: bytes, min_value: int) -> bool:
        try:
            return int(value or b"0") >= min_value
        except ValueError:
            return True  # non-counter slot: existence is readiness

    def kv_store_add(self, key: str, amount: int) -> int:
        resp = self._get(comm.KVStoreAddRequest(key=key, amount=amount))
        return resp.value if isinstance(resp, comm.KVStoreAddResponse) else 0

    def kv_store_delete(self, key: str) -> bool:
        resp = self._get(comm.KVStoreDeleteRequest(key=key))
        return bool(
            resp.value if isinstance(resp, comm.KVStoreAddResponse) else 0
        )

    def kv_store_put_indexed(self, key: str, value: bytes) -> int:
        """Atomic publish with a server-assigned sequence number; the
        slot at ``key`` holds ``seq|value`` afterwards."""
        resp = self._get(
            comm.KVStorePutIndexedRequest(key=key, value=value)
        )
        return resp.value if isinstance(resp, comm.KVStoreAddResponse) else 0

    def kv_store_multi_get(self, keys: List[str]) -> Dict[str, bytes]:
        resp = self._get(comm.KVStoreMultiGetRequest(keys=keys))
        return resp.kvs if isinstance(resp, comm.KeyValuePairs) else {}

    def kv_store_multi_set(self, kvs: Dict[str, bytes]) -> bool:
        return self._report(comm.KeyValuePairs(kvs=kvs)).success

    # data shards

    def report_dataset_shard_params(self, **kwargs) -> bool:
        return self._report(comm.DatasetShardParams(**kwargs)).success

    def get_task(self, dataset_name: str) -> comm.Task:
        resp = self._get(comm.TaskRequest(dataset_name=dataset_name))
        return resp if isinstance(resp, comm.Task) else comm.Task()

    def get_task_batch(
        self,
        dataset_name: str,
        count: int = 1,
        wait_timeout: float = 0.0,
    ) -> Optional[Tuple[List[comm.Task], bool]]:
        """Batched shard lease: up to ``count`` tasks in one envelope,
        optionally long-polling ``wait_timeout`` seconds server-side for
        the first one.  Returns (tasks, dataset_finished), or None when
        the master is too old for the batch protocol (caller falls back
        to get_task).  DLROVER_TPU_LONGPOLL=0 disables the whole r11
        protocol — batching included — so None is also returned then."""
        if not self._longpoll_enabled():
            return None
        resp = self._get(comm.TaskBatchRequest(
            dataset_name=dataset_name,
            count=count,
            wait_timeout=wait_timeout,
        ))
        if isinstance(resp, comm.TaskBatch):
            return list(resp.tasks), resp.finished
        if self._mark_longpoll_unsupported(resp):
            return None
        return [], False

    def report_task_result(
        self, dataset_name: str, task_id: int, err_message: str = ""
    ) -> bool:
        return self._report(
            comm.TaskResult(
                dataset_name=dataset_name,
                task_id=task_id,
                err_message=err_message,
            )
        ).success

    def report_task_results(
        self, dataset_name: str, task_ids: List[int],
        err_message: str = ""
    ) -> bool:
        """Batched completion ack (one envelope for N shard ids)."""
        if not task_ids:
            return True
        return self._report(
            comm.TaskResults(
                dataset_name=dataset_name,
                task_ids=list(task_ids),
                err_message=err_message,
            )
        ).success

    def get_shard_checkpoint(self, dataset_name: str) -> str:
        resp = self._get(comm.ShardCheckpointRequest(dataset_name=dataset_name))
        return resp.content if isinstance(resp, comm.ShardCheckpoint) else ""

    def report_shard_checkpoint(self, content: str) -> bool:
        return self._report(comm.ShardCheckpoint(content=content)).success

    def get_dataset_epoch(self, dataset_name: str) -> int:
        resp = self._get(comm.DatasetEpochRequest(dataset_name=dataset_name))
        return resp.epoch if isinstance(resp, comm.DatasetEpoch) else 0

    # lifecycle / monitoring

    def report_heart_beat(
        self, ts: Optional[float] = None,
        digest: Optional[Dict[str, float]] = None,
    ) -> List[dict]:
        """One heartbeat; ``digest`` piggybacks this node's step-time/
        ckpt-busy summary (``comm.HeartBeat.digest``) so the master's
        straggler and checkpoint-stall screens get per-rank evidence
        without an extra RPC."""
        resp = self._get(
            comm.HeartBeat(
                node_id=self._node_id,
                timestamp=ts or time.time(),
                digest=dict(digest or {}),
            )
        )
        if isinstance(resp, comm.HeartbeatResponse):
            return resp.diagnosis_actions
        return []

    def report_incident_dump(self, incident_id: str, payload: str) -> bool:
        """Deliver this process's flight-recorder snapshot into the
        named incident (the agent's answer to a broadcast
        ``flight_dump`` action)."""
        return self._report(
            comm.IncidentDumpReport(
                incident_id=incident_id,
                node_id=self._node_id,
                payload=payload,
            )
        ).success

    def report_brain_ack(self, action_ids: List[str],
                         job: str = "") -> bool:
        """Acknowledge processed Brain v2 actions (by the ids from
        their ``extra["brain"]["id"]`` envelopes) — completes the
        tracked delivery so the fleet arbiter's watchdog neither
        re-targets nor expires them."""
        if not action_ids:
            return True
        return self._report(
            comm.BrainActionAck(
                job=job,
                node_id=self._node_id,
                action_ids=list(action_ids),
            )
        ).success

    # distributed checkpoint commit

    def report_ckpt_manifest(
        self, ckpt_dir: str, step: int, num_processes: int,
        manifest_json: str, process_id: Optional[int] = None,
    ) -> bool:
        """Phase-1 of the distributed checkpoint commit: deliver one
        host process's shard manifest to the master's commit
        coordinator.  ``process_id`` defaults to this client's node id,
        but multi-process-per-node savers MUST pass the real process id
        — the coordinator keys manifests by it, and two processes
        colliding on one node id would overwrite each other and never
        seal."""
        return self._report(
            comm.CkptManifestReport(
                ckpt_dir=ckpt_dir,
                step=step,
                process_id=(
                    self._node_id if process_id is None else int(process_id)
                ),
                num_processes=num_processes,
                manifest=manifest_json,
            )
        ).success

    def get_ckpt_commit_status(
        self, ckpt_dir: str, step: int = -1
    ) -> comm.CkptCommitStatus:
        resp = self._get(
            comm.CkptCommitStatusRequest(ckpt_dir=ckpt_dir, step=step)
        )
        if isinstance(resp, comm.CkptCommitStatus):
            return resp
        return comm.CkptCommitStatus(step=step)

    def wait_ckpt_commit(
        self, ckpt_dir: str, step: int, timeout: float = 600.0,
        poll: float = 0.5,
    ) -> bool:
        """Bounded wait for the coordinator to seal ``step`` (phase-2).
        Status polls are cheap reads; overload refusals ride the same
        ride-out path as the other waits."""
        deadline = time.time() + max(0.0, timeout)
        while True:
            try:
                status = self.get_ckpt_commit_status(ckpt_dir, step)
                if status.sealed or status.committed_step >= step >= 0:
                    return True
            except retry_mod.OverloadedError as e:
                ride_out_overload(e, deadline)
            if time.time() >= deadline:
                return False
            time.sleep(min(poll, max(0.02, deadline - time.time())))

    # peer-replicated restore (checkpoint-free fast recovery)

    def report_peer_announce(
        self, scope: str, step: int, addr: str, num_processes: int = 1,
        process_id: Optional[int] = None,
    ) -> bool:
        """Advertise a committed shm snapshot this host can serve (the
        broker keys announcements by ``process_id``, same contract as
        ``report_ckpt_manifest``)."""
        return self._report(
            comm.PeerSnapshotAnnounce(
                scope=scope,
                process_id=(
                    self._node_id if process_id is None else int(process_id)
                ),
                num_processes=num_processes,
                step=step,
                addr=addr,
            )
        ).success

    def get_peer_assignment(
        self, scope: str, step: int = -1,
        group: Optional[List[int]] = None,
        process_id: Optional[int] = None,
    ) -> comm.PeerAssignment:
        """Ask the broker who serves this process's lost shards
        (ordered donors, replica-group members first)."""
        resp = self._get(
            comm.PeerAssignmentRequest(
                scope=scope,
                process_id=(
                    self._node_id if process_id is None else int(process_id)
                ),
                step=step,
                group=[int(g) for g in (group or [])],
            )
        )
        if isinstance(resp, comm.PeerAssignment):
            return resp
        return comm.PeerAssignment(step=-1)

    def report_recovery(self, report: comm.RecoveryReport) -> bool:
        """Deliver one finished recovery's priced report (ladder rung,
        MTTR, peer bandwidth) to the master."""
        if report.process_id < 0:
            report.process_id = self._node_id
        return self._report(report).success

    def report_node_event(
        self, event_type: str, reason: str = "", message: str = ""
    ) -> bool:
        return self._report(
            comm.NodeEventRequest(
                node_id=self._node_id,
                node_type=self._node_type,
                event_type=event_type,
                reason=reason,
                message=message,
            )
        ).success

    def report_failure(
        self, error_data: str, level: str = "", restart_count: int = 0
    ) -> bool:
        return self._report(
            comm.NodeFailureRequest(
                node_id=self._node_id,
                error_data=error_data,
                level=level,
                restart_count=restart_count,
            )
        ).success

    def report_global_step(
        self, step: int, elapsed_time_per_step: float = 0.0
    ) -> bool:
        return self._report(
            comm.GlobalStep(
                timestamp=time.time(),
                step=step,
                elapsed_time_per_step=elapsed_time_per_step,
            )
        ).success

    def report_checkpoint_ready(self, ready: bool) -> bool:
        """Gate/ungate the training rendezvous on checkpoint conversion
        (reference UcpRdzvManager semantics)."""
        return self._report(
            comm.CheckpointReadyRequest(node_id=self._node_id, ready=ready)
        ).success

    def report_hang(self, hung: bool, last_active_ts: float,
                    detail: str = "") -> bool:
        return self._report(
            comm.HangDetectionReport(
                node_id=self._node_id,
                hung=hung,
                last_active_ts=last_active_ts,
                detail=detail,
            )
        ).success

    def report_resource_stats(
        self, cpu_percent: float, memory_mb: int,
        tpu_stats: Optional[List[Dict[str, float]]] = None,
        step: int = -1,
    ) -> bool:
        return self._report(
            comm.ResourceStats(
                cpu_percent=cpu_percent,
                memory_mb=memory_mb,
                tpu_stats=tpu_stats or [],
                step=step,
            )
        ).success

    def report_model_info(self, **kwargs) -> bool:
        return self._report(comm.ModelInfo(**kwargs)).success

    def report_succeeded(self) -> bool:
        return self._report(
            comm.SucceededRequest(
                node_id=self._node_id, node_type=self._node_type
            )
        ).success

    def report_paral_config(self, config: comm.ParallelConfig) -> bool:
        return self._report(config).success

    def get_paral_config(self) -> comm.ParallelConfig:
        resp = self._get(comm.ParallelConfigRequest())
        if isinstance(resp, comm.ParallelConfig):
            return resp
        return comm.ParallelConfig()

    def get_pre_check_result(self) -> str:
        resp = self._get(comm.PreCheckRequest(node_id=self._node_id))
        return resp.status if isinstance(resp, comm.PreCheckResponse) else ""

    def get_training_status(self) -> int:
        resp = self._get(comm.TrainingStatusRequest())
        return resp.status if isinstance(resp, comm.TrainingStatus) else 3

    def get_elastic_run_config(self) -> Dict[str, str]:
        resp = self._get(comm.ElasticRunConfigRequest())
        return resp.configs if isinstance(resp, comm.ElasticRunConfig) else {}

    def get_node_count(self) -> int:
        resp = self._get(comm.NodeCountRequest())
        return resp.count if isinstance(resp, comm.NodeCount) else 0

    def barrier(self, name: str, notify: bool = False) -> bool:
        with trace.span(
            "barrier", kind=trace.CLIENT,
            attrs={"name": name, "notify": notify},
        ):
            # chaos point "master_client.barrier" (DROP/FLAP: False)
            if notify:
                return self._report(
                    comm.SyncBarrierRequest(barrier_name=name, notify=True)
                ).success
            resp = self._get(comm.SyncBarrierRequest(barrier_name=name))
            return (
                resp.success if isinstance(resp, comm.BaseResponse) else False
            )

    def batch(self, payloads: List[Any]) -> List[Any]:
        """Send several requests in ONE envelope (one admission charge,
        one round-trip); replies are positional.  Mixed get/report
        payloads are fine — the server demuxes per item.  Against an
        older master (or with DLROVER_TPU_LONGPOLL=0, which disables
        the whole r11 protocol), falls back to issuing the calls
        individually."""
        if not payloads:
            return []
        if not self._longpoll_enabled():
            return self._issue_individually(payloads)
        resp = self._get(comm.BatchRequest(
            items=[serialize_message(p) for p in payloads]
        ))
        if isinstance(resp, comm.BatchResponse):
            return [deserialize_message(raw) for raw in resp.items]
        if self._mark_longpoll_unsupported(resp):
            return self._issue_individually(payloads)
        return [resp] * len(payloads)

    def _issue_individually(self, payloads: List[Any]) -> List[Any]:
        """Legacy fallback for :meth:`batch` with the SAME positional-
        failure contract as the server's ``_dispatch_batch``: one item
        failing yields a failed BaseResponse in its slot, the rest
        still execute.  Raising mid-list would discard completed
        replies and invite a whole-envelope retry that re-executes
        non-idempotent siblings (a barrier's add double-counted)."""
        replies: List[Any] = []
        for p in payloads:
            try:
                replies.append(
                    self._report(p)
                    if comm.is_report_message(p)
                    else self._get(p)
                )
            except retry_mod.OverloadedError as e:
                # keep the backpressure typed: the item was refused,
                # never executed, and safe to retry at the hinted pace
                # — flattening it to a generic failure would read as an
                # execution error
                logger.warning(
                    "batch fallback item %s overloaded: %s",
                    type(p).__name__, e,
                )
                replies.append(comm.BaseResponse(
                    success=False, reason=comm.OVERLOADED,
                    retry_after_s=e.retry_after_s,
                ))
            except Exception as e:  # noqa: BLE001 - positional failure
                logger.warning(
                    "batch fallback item %s failed: %s",
                    type(p).__name__, e,
                )
                replies.append(
                    comm.BaseResponse(success=False, reason=str(e))
                )
        return replies

    def join_sync(self, sync_name: str, node_rank: int = -1) -> bool:
        return self._report(
            comm.SyncJoin(
                sync_name=sync_name,
                node_id=self._node_id,
                node_rank=node_rank,
            )
        ).success

    # -- singleton ---------------------------------------------------------

    @classmethod
    def singleton_instance(cls) -> Optional["MasterClient"]:
        if MasterClient._instance is None:
            with MasterClient._instance_lock:
                if MasterClient._instance is None:
                    MasterClient._instance = build_master_client()
        return MasterClient._instance

    @classmethod
    def reset_singleton(cls):
        with MasterClient._instance_lock:
            MasterClient._instance = None


def _transport_timeout() -> float:
    """Raw-call timeout: must sit ABOVE the long-poll chunk ceiling, or
    a server legitimately blocking for one full chunk races the
    transport deadline and reads as a spurious failure."""
    return envs.get_float("DLROVER_TPU_LONGPOLL_MAX_S") + 15.0


class GrpcMasterClient(MasterClient):
    def __init__(self, master_addr: str, node_id: int,
                 node_type: str = NodeType.WORKER):
        super().__init__(master_addr, node_id, node_type)
        import grpc

        self._channel = grpc.insecure_channel(
            master_addr,
            options=[
                ("grpc.max_send_message_length", GRPC_MAX_MESSAGE_LENGTH),
                ("grpc.max_receive_message_length", GRPC_MAX_MESSAGE_LENGTH),
            ],
        )
        self._report_rpc = self._channel.unary_unary(
            "/dlrover_tpu.Master/report",
            request_serializer=lambda x: x,
            response_deserializer=lambda x: x,
        )
        self._get_rpc = self._channel.unary_unary(
            "/dlrover_tpu.Master/get",
            request_serializer=lambda x: x,
            response_deserializer=lambda x: x,
        )

    def _report_raw(self, envelope: bytes) -> bytes:
        return self._report_rpc(envelope, timeout=_transport_timeout())

    def _get_raw(self, envelope: bytes) -> bytes:
        return self._get_rpc(envelope, timeout=_transport_timeout())

    def close(self):
        self._channel.close()


class HttpMasterClient(MasterClient):
    def __init__(self, master_addr: str, node_id: int,
                 node_type: str = NodeType.WORKER):
        super().__init__(master_addr, node_id, node_type)
        self._base = f"http://{master_addr}"

    def _post(self, path: str, envelope: bytes) -> bytes:
        import urllib.request

        req = urllib.request.Request(
            self._base + path, data=envelope, method="POST"
        )
        with urllib.request.urlopen(
            req, timeout=_transport_timeout()
        ) as r:
            return r.read()

    def _report_raw(self, envelope: bytes) -> bytes:
        return self._post("/report", envelope)

    def _get_raw(self, envelope: bytes) -> bytes:
        return self._post("/get", envelope)


class LocalMasterClient(MasterClient):
    """In-process client wired straight to a servicer (tests, local mode)."""

    def __init__(self, servicer, node_id: int,
                 node_type: str = NodeType.WORKER):
        super().__init__("local", node_id, node_type)
        self._servicer = servicer

    def _report_raw(self, envelope: bytes) -> bytes:
        return self._servicer.report(comm.Message.from_json(envelope)).to_json()

    def _get_raw(self, envelope: bytes) -> bytes:
        return self._servicer.get(comm.Message.from_json(envelope)).to_json()


def build_master_client(
    master_addr: Optional[str] = None,
    node_id: Optional[int] = None,
    node_type: Optional[str] = None,
    service_type: Optional[str] = None,
    timeout: float = 30.0,
) -> Optional[MasterClient]:
    """Factory mirroring reference ``build_master_client`` (:721)."""
    master_addr = master_addr or envs.get_str(NodeEnv.MASTER_ADDR)
    if node_id is None:
        node_id = envs.get_int(
            NodeEnv.NODE_ID, default=envs.get_int(NodeEnv.NODE_RANK)
        )
    node_type = node_type or envs.get_str(NodeEnv.NODE_TYPE, default=NodeType.WORKER)
    service_type = service_type or envs.get_str(
        NodeEnv.MASTER_SERVICE_TYPE, default=CommunicationType.GRPC
    )
    if not master_addr:
        return None
    if service_type == CommunicationType.HTTP:
        return HttpMasterClient(master_addr, node_id, node_type)
    return GrpcMasterClient(master_addr, node_id, node_type)
