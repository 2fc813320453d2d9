"""Master-side elastic rendezvous.

Copy of ``dlrover_tpu/master/rdzv_manager.py``, its imports the port's,
with the chaos point of a join (``rdzv.join``: a DROP or FLAP swallows the
join, and the agent's poll loop re-joins).

The JAX package's counterpart of DLRover's
``dlrover/python/master/elastic_training/rdzv_manager.py`` (RendezvousManager
``:69``, completion rule ``:183``, join ``:325``, get_comm_world ``:448``,
ElasticTrainingRendezvousManager ``:497``, NetworkCheckRendezvousManager
``:599``).

Differences from the reference, by TPU design:
  * The agreed world is a set of hosts that will call
    ``jax.distributed.initialize(coordinator, num_processes, process_id)``;
    the comm world therefore carries a coordinator address (rank-0 host)
    instead of a torch process-group spec.
  * Completion respects ``node_unit`` (hosts per TPU slice): a multi-host
    slice is usable all-or-nothing, so the completed world size is always a
    multiple of node_unit (reference: rdzv_manager.py:159-181).
  * Rank assignment keeps each slice's hosts contiguous (SliceContiguousSorter)
    so mesh axes over process ranks ride ICI, crossing DCN only between
    slices.
"""

import copy
import threading
import time
from abc import ABC
from typing import Dict, List, Optional, Set, Tuple

from dlrover_tpu_torch.common.comm import NodeMeta
from dlrover_tpu_torch.common.constants import NetworkFailureReason, RendezvousName
from dlrover_tpu_torch.common.global_context import Context
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.master.net_topology import SliceContiguousSorter


class RendezvousParameters:
    def __init__(
        self,
        min_nodes: int,
        max_nodes: int,
        waiting_timeout: float = 30.0,
        rdzv_timeout: float = 600.0,
        node_unit: int = 1,
    ):
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        self.waiting_timeout = waiting_timeout
        self.rdzv_timeout = rdzv_timeout
        self.node_unit = max(1, node_unit)


class RendezvousManager(ABC):
    """Collects joining hosts into rounds and publishes agreed worlds."""

    def __init__(self, name: str = RendezvousName.TRAINING):
        self._name = name
        self._lock = threading.Lock()
        # long-poll waiters block here; joins, completions, and gate
        # releases notify so an agent learns its world the instant the
        # round seals instead of probing once a second
        self._cond = threading.Condition(self._lock)
        self._params = RendezvousParameters(0, 0)
        self._waiting_nodes: Dict[int, NodeMeta] = {}
        self._rdzv_nodes: Dict[int, NodeMeta] = {}  # rank -> meta
        self._latest_rdzv_nodes: Dict[int, NodeMeta] = {}
        self._alive_nodes: Set[int] = set()
        self._node_unit = 1
        self._rdzv_round = 0
        self._lastcall_time = 0.0
        self._start_rdzv_time = 0.0
        self._sorter = SliceContiguousSorter()
        self._rdzv_events: List[Tuple[float, str]] = []
        self._blocked_reason = ""
        self._blockers: Set[int] = set()

    @property
    def name(self) -> str:
        return self._name

    @property
    def rdzv_round(self) -> int:
        return self._rdzv_round

    def update_rdzv_params(
        self,
        min_nodes: int,
        max_nodes: int,
        waiting_timeout: float,
        node_unit: int,
    ):
        with self._lock:
            ctx = Context.singleton_instance()
            self._params = RendezvousParameters(
                min_nodes,
                max_nodes,
                waiting_timeout,
                ctx.rdzv_timeout_secs,
                node_unit,
            )
            self._node_unit = max(1, node_unit)

    def get_rdzv_params(self) -> RendezvousParameters:
        return self._params

    # -- membership from the job manager ----------------------------------

    def add_alive_node(self, node_id: int):
        with self._lock:
            self._alive_nodes.add(node_id)

    def remove_alive_node(self, node_id: int):
        unblock = False
        with self._lock:
            self._alive_nodes.discard(node_id)
            if node_id in self._waiting_nodes:
                del self._waiting_nodes[node_id]
            if node_id in getattr(self, "_blockers", set()):
                # a node that gated the rendezvous died mid-conversion;
                # a dead gate must never wedge the job
                unblock = True
            self._cond.notify_all()
        if unblock:
            self.unblock_rendezvous(node_id)

    # -- agent-facing API --------------------------------------------------

    def join_rendezvous(
        self,
        node_id: int,
        node_rank: int,
        local_world_size: int = 1,
        node_ip: str = "",
        slice_id: int = 0,
        topology_label: str = "",
        node_unit: int = 0,
    ) -> int:
        """Add a host to the waiting set; returns the round it will join.
        ``node_unit`` (hosts per slice) comes from the agent's launch config
        and overrides the manager default so worlds stay slice-aligned."""
        from dlrover_tpu_torch import chaos
        from dlrover_tpu_torch.observability import trace

        with trace.span(
            "rdzv.join", attrs={"node_id": node_id, "node_rank": node_rank}
        ):
            fault = chaos.point("rdzv.join", node_id=node_id)
            if fault is not None and fault.kind in (chaos.DROP, chaos.FLAP):
                # the join is swallowed (node flapped mid-rendezvous):
                # the agent's poll loop re-joins, the round seals without
                # losing the other members' progress
                with self._lock:
                    return self._rdzv_round
            with self._lock:
                if node_unit > 1:
                    self._node_unit = node_unit
                if not self._waiting_nodes:
                    self._start_rdzv_time = time.time()
                meta = NodeMeta(
                    node_id=node_id,
                    node_rank=node_rank,
                    process_unit=local_world_size,
                    addr=node_ip,
                    slice_id=slice_id,
                    topology_label=topology_label,
                )
                self._waiting_nodes[node_id] = meta
                self._lastcall_time = time.time()
                self._rdzv_events.append((time.time(), f"join:{node_id}"))
                self._cond.notify_all()
                return self._rdzv_round

    def _check_rdzv_completed(self) -> bool:
        """Completion rule (reference rdzv_manager.py:183): complete when
        all max_nodes joined, or when >= min_nodes have waited past the
        waiting_timeout — truncated down to a multiple of node_unit,
        and (r18) to WHOLE slices when the waiting set spans several
        pod slices: a multi-host slice is usable all-or-nothing, and a
        half-joined slice must not strand its peers in the world."""
        if getattr(self, "_blocked_reason", ""):
            return False
        waiting = len(self._waiting_nodes)
        if waiting == 0:
            return False
        params = self._params
        if params.max_nodes and waiting >= params.max_nodes:
            # the instant-seal path must honor the whole-slice rule
            # too: raw waiting can reach max_nodes while some slices
            # are still half-joined (a replacement host under a new
            # slice_id beside its short old slice) — falling through
            # to the timeout rule gives stragglers their window
            # instead of sealing slice fragments into the world
            if self._usable_waiting() >= params.max_nodes:
                self._complete_rdzv(params.max_nodes)
                return True
        since_lastcall = time.time() - self._lastcall_time
        if (
            params.min_nodes
            and waiting >= params.min_nodes
            and since_lastcall >= params.waiting_timeout
        ):
            usable = self._usable_waiting()
            if usable >= params.min_nodes:
                self._complete_rdzv(usable)
                return True
        return False

    def _usable_waiting(self) -> int:
        """Caller holds the lock: waiting nodes eligible to seal a
        round.  Single-slice worlds keep the legacy node_unit
        truncation; multi-slice worlds truncate each slice's waiters to
        node_unit multiples independently, so only whole slices count."""
        by_slice: Dict[int, int] = {}
        for meta in self._waiting_nodes.values():
            by_slice[meta.slice_id] = by_slice.get(meta.slice_id, 0) + 1
        if len(by_slice) <= 1:
            return (
                len(self._waiting_nodes) // self._node_unit
            ) * self._node_unit
        return sum(
            (count // self._node_unit) * self._node_unit
            for count in by_slice.values()
        )

    def _choose_waiting(self, node_count: int) -> List[NodeMeta]:
        """Caller holds the lock: pick ``node_count`` members for the
        sealing round.  Whole slices first, each slice's take CAPPED at
        its node_unit multiple (a partial slice sorted early must not
        displace a complete one, and a slice with stragglers beyond its
        unit must not leak the extras into the world — both would
        strand the two-level mesh on a broken slice), then the
        remainder in the legacy (slice_id, node_rank, node_id) order."""
        ordered = sorted(
            self._waiting_nodes.values(),
            key=lambda m: (m.slice_id, m.node_rank, m.node_id),
        )
        by_slice: Dict[int, int] = {}
        for meta in ordered:
            by_slice[meta.slice_id] = by_slice.get(meta.slice_id, 0) + 1
        if len(by_slice) <= 1:
            return ordered[:node_count]
        usable = {
            sid: (count // self._node_unit) * self._node_unit
            for sid, count in by_slice.items()
        }
        taken: Dict[int, int] = {}
        whole: List[NodeMeta] = []
        extra: List[NodeMeta] = []
        for meta in ordered:
            if taken.get(meta.slice_id, 0) < usable[meta.slice_id]:
                taken[meta.slice_id] = taken.get(meta.slice_id, 0) + 1
                whole.append(meta)
            else:
                extra.append(meta)
        return (whole + extra)[:node_count]

    def _complete_rdzv(self, node_count: int):
        chosen = self._choose_waiting(node_count)
        metas = [copy.deepcopy(m) for m in chosen]
        self._rdzv_nodes = self._sorter.sort(metas)
        self._latest_rdzv_nodes = self._rdzv_nodes
        for meta in self._rdzv_nodes.values():
            self._waiting_nodes.pop(meta.node_id, None)
        self._rdzv_round += 1
        elapsed = time.time() - self._start_rdzv_time
        # completion may happen lazily inside ONE waiter's predicate
        # check; the others are blocked on the condition and must be
        # woken or they'd sleep out their whole long-poll deadline
        self._cond.notify_all()
        groups = self._locked_slice_groups()
        logger.info(
            "%s rendezvous round %d completed with %d nodes in %.1fs"
            " (%d slice%s: %s)",
            self._name, self._rdzv_round, len(self._rdzv_nodes), elapsed,
            len(groups), "" if len(groups) == 1 else "s",
            {s: len(r) for s, r in groups.items()},
        )

    def _locked_slice_groups(self) -> Dict[int, List[int]]:
        return_groups: Dict[int, List[int]] = {}
        for rank, meta in sorted(self._rdzv_nodes.items()):
            return_groups.setdefault(meta.slice_id, []).append(rank)
        return return_groups

    def slice_groups(self) -> Dict[int, List[int]]:
        """Per-slice node groups of the CURRENT world: slice_id ->
        sorted world ranks.  The SliceContiguousSorter guarantees each
        group is a contiguous rank range, so mesh axes over process
        ranks ride ICI within a group and cross DCN only between
        groups — the layout ``parallel.mesh.build_slice_mesh`` assumes."""
        with self._lock:
            return self._locked_slice_groups()

    def get_comm_world(
        self, node_id: int
    ) -> Tuple[int, int, Dict[int, NodeMeta]]:
        """Poll for the agreed world.  Returns (round, group, world);
        empty world means keep polling."""
        with self._lock:
            return self._locked_comm_world(node_id)

    def _locked_comm_world(
        self, node_id: int
    ) -> Tuple[int, int, Dict[int, NodeMeta]]:
        """Single probe under the lock; shared by the poll and
        long-poll paths (subclasses override for grouped worlds)."""
        # Always try to complete a new round first: a node re-joining
        # after a restart must not be handed the stale previous world
        # while it still sits in the waiting set (that would livelock
        # every agent's "nodes waiting -> rescale" check).
        self._check_rdzv_completed()
        if self._rdzv_nodes and any(
            m.node_id == node_id for m in self._rdzv_nodes.values()
        ):
            if node_id in self._waiting_nodes:
                # joined for a NEXT round; don't serve the old world
                return self._rdzv_round, 0, {}
            return self._rdzv_round, 0, dict(self._rdzv_nodes)
        return self._rdzv_round, 0, {}

    def wait_comm_world(
        self, node_id: int, timeout: float = 30.0
    ) -> Tuple[int, int, Dict[int, NodeMeta]]:
        """Long-poll for the agreed world: block until a round including
        ``node_id`` seals or ``timeout`` passes (empty world).  Wakes on
        join/completion/unblock notifies; between notifies it sleeps
        exactly until the time-based completion rule (min_nodes past
        waiting_timeout) could fire, so the round seals on schedule with
        zero client polling."""
        deadline = time.time() + max(0.0, timeout)
        with self._cond:
            while True:
                round_, group, world = self._locked_comm_world(node_id)
                if world:
                    return round_, group, world
                remaining = deadline - time.time()
                if remaining <= 0:
                    return round_, group, {}
                self._cond.wait(self._completion_tick(remaining))

    def _completion_tick(self, remaining: float) -> float:
        """Caller holds the lock: seconds until the completion rule
        should be re-evaluated even without a notify.  Bounded by a 5s
        safety ceiling so a missed edge can only delay, never hang."""
        tick = min(remaining, 5.0)
        params = self._params
        if (
            self._waiting_nodes
            and params.min_nodes
            and len(self._waiting_nodes) >= params.min_nodes
        ):
            until_complete = (
                self._lastcall_time + params.waiting_timeout - time.time()
            )
            # only shorten the tick while the edge is still ahead: once
            # the rule is eligible but completion is refused (blocked
            # rendezvous, node_unit truncation) a short tick would
            # busy-spin the predicate under the manager lock
            if until_complete > 0:
                tick = min(tick, until_complete)
        return max(0.05, tick)

    def num_nodes_waiting(self) -> int:
        """Agents poll this: >0 during a live round means new hosts want in,
        which triggers a restart-to-rescale.

        Guarded by node_unit (reference rdzv_manager.py:406-419): a leftover
        host truncated out of the round can never complete a round alone, so
        it must NOT look like a scale event — that would stop/restart the
        in-world agents forever.  A re-joining member of the *current* world
        always counts (its peers must follow it into the next round)."""
        with self._lock:
            waiting = len(self._waiting_nodes)
            if waiting == 0:
                return 0
            current_ids = {m.node_id for m in self._rdzv_nodes.values()}
            if any(nid in current_ids for nid in self._waiting_nodes):
                return waiting
            if waiting >= self._node_unit:
                return waiting
            return 0

    def not_joined_rdzv_nodes(self) -> List[int]:
        with self._lock:
            joined = {m.node_id for m in self._rdzv_nodes.values()}
            return [n for n in self._alive_nodes if n not in joined]

    def all_alive_joined(self) -> bool:
        with self._lock:
            waiting = set(self._waiting_nodes)
            return self._alive_nodes.issubset(waiting) and bool(waiting)

    def rdzv_timed_out(self) -> bool:
        with self._lock:
            if not self._waiting_nodes or self._rdzv_nodes:
                return False
            return (
                time.time() - self._start_rdzv_time
                > self._params.rdzv_timeout
            )

    def clear_waiting_nodes(self):
        with self._lock:
            self._waiting_nodes.clear()
            self._cond.notify_all()

    # -- completion gate (reference UcpRdzvManager rdzv_manager.py:583) ----

    def block_rendezvous(self, reason: str = "", node_id: int = -1):
        """Hold back round completion (e.g. a universal-checkpoint
        conversion must finish before workers may restart training).
        Multiple nodes may hold the gate; it opens when the LAST one
        releases (or dies)."""
        with self._lock:
            self._blocked_reason = reason or "blocked"
            self._blockers.add(node_id)
        logger.info("%s rendezvous blocked: %s", self._name, reason)

    def unblock_rendezvous(self, node_id: int = -1):
        """Release node_id's hold (-1 forces a full release)."""
        with self._lock:
            if node_id == -1:
                self._blockers.clear()
            else:
                self._blockers.discard(node_id)
            if not self._blockers:
                self._blocked_reason = ""
            self._cond.notify_all()
        if not self._blockers:
            logger.info("%s rendezvous unblocked", self._name)


class ElasticTrainingRendezvousManager(RendezvousManager):
    """The training rendezvous (reference ``rdzv_manager.py:497``)."""

    def __init__(self):
        super().__init__(RendezvousName.TRAINING)


class NetworkCheckRendezvousManager(RendezvousManager):
    """Pairs hosts into small check worlds across 2 rounds and classifies
    fault vs straggler hosts from reported results (reference
    ``rdzv_manager.py:599``: ``_group_nodes:684``, ``check_fault_node:806``,
    ``get_straggler:841``).

    On TPU the per-group check is a small matmul + ``psum`` timed over the
    group's mesh; round 0 pairs adjacent hosts, round 1 re-pairs hosts that
    looked abnormal with known-good partners so a bad host is separated
    from a bad link.
    """

    def __init__(self):
        super().__init__(RendezvousName.NETWORK_CHECK)
        self._check_round = 2
        self._node_status: Dict[int, List[bool]] = {}
        self._node_times: Dict[int, List[float]] = {}
        self._reported_rounds: Dict[int, int] = {}
        self._fault_nodes: Optional[List[int]] = None
        self._straggler_nodes: Optional[List[int]] = None

    def _check_rdzv_completed(self) -> bool:
        # round >=2 must wait for every still-alive member of the previous
        # round: completing early would strand the slower group in an
        # empty world and mis-classify healthy hosts as FAULT
        if self._rdzv_round > 0 and self._latest_rdzv_nodes:
            prev = {m.node_id for m in self._latest_rdzv_nodes.values()}
            if self._alive_nodes:
                prev &= self._alive_nodes
            if prev and not prev.issubset(set(self._waiting_nodes)):
                return False
        return super()._check_rdzv_completed()

    def _locked_comm_world(
        self, node_id: int
    ) -> Tuple[int, int, Dict[int, NodeMeta]]:
        # like the base manager: always try to complete a NEW round —
        # serving round 2's re-joiners the stale round-1 world made
        # both check rounds share coordinator keys (observed as a
        # jax.distributed hang on a dead port)
        if self._check_rdzv_completed():
            self._fault_nodes = None
            self._straggler_nodes = None
        if self._rdzv_nodes and node_id not in self._waiting_nodes:
            groups = self._group_nodes(self._rdzv_round)
            for group_idx, group in enumerate(groups):
                ranks = sorted(group)
                if any(
                    self._rdzv_nodes[r].node_id == node_id for r in ranks
                ):
                    world = {r: self._rdzv_nodes[r] for r in ranks}
                    # re-rank within the group 0..len-1 keeping order
                    sub = {}
                    for new_rank, r in enumerate(ranks):
                        meta = copy.deepcopy(world[r])
                        meta.node_rank = new_rank
                        sub[new_rank] = meta
                    return self._rdzv_round, group_idx, sub
        return self._rdzv_round, 0, {}

    def _group_nodes(self, rdzv_round: int) -> List[List[int]]:
        """Group world ranks for this check round."""
        round_idx = (rdzv_round - 1) % self._check_round if rdzv_round else 0
        ranks = sorted(self._rdzv_nodes.keys())
        if round_idx == 0:
            groups = [ranks[i : i + 2] for i in range(0, len(ranks), 2)]
            if len(groups) > 1 and len(groups[-1]) == 1:
                groups[-2].extend(groups.pop())
            return groups
        # round 1: pair each abnormal node with a normal partner
        abnormal, normal = [], []
        for r in ranks:
            nid = self._rdzv_nodes[r].node_id
            statuses = self._node_status.get(nid, [])
            if statuses and not statuses[-1]:
                abnormal.append(r)
            else:
                normal.append(r)
        groups = []
        while abnormal and normal:
            groups.append([abnormal.pop(0), normal.pop(0)])
        rest = abnormal + normal
        pair_rest = [rest[i : i + 2] for i in range(0, len(rest), 2)]
        if len(pair_rest) > 1 and len(pair_rest[-1]) == 1:
            pair_rest[-2].extend(pair_rest.pop())
        groups.extend([g for g in pair_rest if g])
        return groups

    def report_network_check_result(
        self, node_id: int, normal: bool, elapsed_time: float
    ):
        with self._lock:
            self._node_status.setdefault(node_id, []).append(normal)
            self._node_times.setdefault(node_id, []).append(elapsed_time)
            self._reported_rounds[node_id] = (
                self._reported_rounds.get(node_id, 0) + 1
            )
            self._fault_nodes = None
            self._straggler_nodes = None

    def _all_reported(self) -> bool:
        if not self._latest_rdzv_nodes:
            return False
        node_ids = {m.node_id for m in self._latest_rdzv_nodes.values()}
        return all(self._node_status.get(n) for n in node_ids)

    def check_fault_node(self) -> Tuple[List[int], str]:
        """Fault = abnormal in every round it reported (>=1 report).
        Returns (fault_node_ids, reason)."""
        with self._lock:
            if not self._all_reported():
                return [], NetworkFailureReason.WAITING_NODE
            if self._fault_nodes is None:
                fault = []
                for meta in self._latest_rdzv_nodes.values():
                    statuses = self._node_status.get(meta.node_id, [])
                    if statuses and not any(statuses):
                        fault.append(meta.node_id)
                self._fault_nodes = sorted(fault)
            reason = (
                NetworkFailureReason.NODE_FAILURE if self._fault_nodes else ""
            )
            return list(self._fault_nodes), reason

    def get_straggler(self) -> Tuple[List[int], str]:
        """Straggler = elapsed > avg * straggler_ratio among normal nodes."""
        with self._lock:
            if not self._all_reported():
                return [], NetworkFailureReason.WAITING_NODE
            if self._straggler_nodes is None:
                ctx = Context.singleton_instance()
                times = {
                    meta.node_id: min(self._node_times.get(meta.node_id) or [0.0])
                    for meta in self._latest_rdzv_nodes.values()
                }
                valid = [t for t in times.values() if t > 0]
                stragglers: List[int] = []
                if len(valid) > 1:
                    avg = sum(valid) / len(valid)
                    for nid, t in times.items():
                        if t > avg * ctx.straggler_ratio:
                            stragglers.append(nid)
                self._straggler_nodes = sorted(stragglers)
            return list(self._straggler_nodes), ""

    def network_check_success(self) -> bool:
        fault, reason = self.check_fault_node()
        if reason == NetworkFailureReason.WAITING_NODE:
            return False
        return not fault
