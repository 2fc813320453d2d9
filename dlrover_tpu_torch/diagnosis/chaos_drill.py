"""End-to-end recovery drill: elastic training under scripted chaos.

Copy of ``dlrover_tpu/diagnosis/chaos_drill.py``'s harness and of the
eight scenarios that run on modules the port has: ``master_restart``,
``torn_shm``, ``storage_stall``, ``storage_crc``, ``node_flap``,
``kv_timeout``, ``heartbeat_loss`` and ``torn_commit``.  The drill asserts
*that* the documented recovery invariants hold under each scripted
failure mode, with faults manufactured deterministically by
``dlrover_tpu_torch.chaos``:

* **committed-step monotonicity** — the storage tracker never moves
  backwards, no matter where a fault lands;
* **bounded resume** — after recovery, training reaches its target in
  the expected number of steps (no lost work beyond the last commit);
* **no silent data loss** — restored tensors are bit-identical to what
  was saved at the restored step, and corrupted/torn artifacts are
  *refused*, never silently restored.

Each scenario runs in-process against the real components —
``MasterServicer`` + a restartable local client, the flash-checkpoint
engine with real shm segments, posix storage — so the injection points
exercised are the ones production traffic crosses.  After each one the
drill opens an incident (``observability/incidents.py``) and holds its
evidence-derived classification to :data:`INCIDENT_EXPECTATIONS`.
Replaying a scenario with the same seed produces the same normalized
fault trace (:func:`normalized_trace`).

The states are torch tensors with the reference's leaves, shapes, dtypes
and values, on an explicit ``device``: the card by default (raises
without one), ``"cpu"`` when asked for.  The other seven scenarios wait
for the modules they drive and raise ``NotImplementedError`` naming
their ROADMAP item (:data:`WAITING`).

Run standalone::

    python -m dlrover_tpu_torch.diagnosis.chaos_drill [--device cpu] [scenario ...]

which prints one ``CHAOS_DRILL {...}`` line and exits 0 when every
scenario passed (``CHAOS_DRILL_SEED`` picks the seed).
"""

import contextlib
import json
import os
import shutil
import sys
import tempfile
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import torch

from dlrover_tpu_torch import chaos
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.device import DeviceLike, resolve_device

#: steps the simulated training loop runs to; scenarios assert the loop
#: reaches it after recovery (bounded resume)
_TARGET_STEP = 12

#: scenario -> (expected incident phase, expected dominant chaos point)
#: — the regression-gated diagnosis matrix: every scenario must end in
#: an INCIDENT.json whose evidence-derived classification (no phase
#: hint is passed) names the wounded subsystem and the injected fault.
INCIDENT_EXPECTATIONS: Dict[str, tuple] = {
    "master_restart": ("rpc", "master_client.transport"),
    "torn_shm": ("ckpt", "snapshot.stream_chunk"),
    "storage_stall": ("ckpt", "storage.write"),
    "storage_crc": ("ckpt", "storage.write_chunk"),
    "node_flap": ("rendezvous", "rdzv.join"),
    "live_reshard": ("rendezvous", "rdzv.join"),
    "kv_timeout": ("kv", "kv_store.wait"),
    "heartbeat_loss": ("heartbeat", "agent.heartbeat"),
    "torn_commit": ("ckpt", "ckpt.phase1_report"),
    "slow_link": ("comm", "comm.axis_delay.dp"),
    "fabric_reroute": ("comm", "comm.axis_delay.slice"),
    "hbm_leak": ("mem", "mem.pressure"),
    "cache_cold": ("compile", "jitscope.compile"),
    # the serve-side delays outnumber the single torn fetch, so the
    # evidence-derived dominant fault is peer.serve; both points map to
    # the recovery phase
    "peer_restore": ("recovery", "peer.serve"),
    "data_starved": ("data", "data.lease"),
}

#: the reference's scenarios whose bodies wait, with the ROADMAP item
#: that brings what they drive: the time-series store and the sentinels
#: (slow_link, hbm_leak, cache_cold with the compile cache, peer_restore),
#: datascope and the sharding client (data_starved), the live reshard
#: and the hierarchical fabric tuner
WAITING: Dict[str, str] = {
    "slow_link": "ROADMAP queue 1 item 11, the rest",
    "hbm_leak": "ROADMAP queue 1 item 11, the rest",
    "cache_cold": "ROADMAP queue 1 item 11, the rest",
    "peer_restore": "ROADMAP queue 1 item 11, the rest",
    "data_starved": "ROADMAP queue 1 item 11, the rest",
    "live_reshard": "ROADMAP queue 1 item 6c",
    "fabric_reroute": "ROADMAP queue 1 item 6d",
}


@contextlib.contextmanager
def _env(**overrides: str):
    """Temporarily set env knobs (drill budgets must not leak into the
    caller's process)."""
    saved: Dict[str, Optional[str]] = {}
    for key, value in overrides.items():
        saved[key] = os.environ.get(key)
        os.environ[key] = value
    try:
        yield
    finally:
        for key, old in saved.items():
            if old is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = old


def _scope() -> str:
    return f"chaos{uuid.uuid4().hex[:8]}"


# ---------------------------------------------------------------------------
# In-process master with restart-in-place semantics.
# ---------------------------------------------------------------------------


class _MasterHandle:
    """Holds the live servicer; ``restart()`` replaces it with a fresh
    one — a fresh KV store (new epoch, zeroed counters) exactly like a
    real master respawn on the same port."""

    def __init__(self):
        self.restarts = 0
        self._build()

    def _build(self):
        from dlrover_tpu_torch.master.rdzv_manager import (
            ElasticTrainingRendezvousManager,
        )
        from dlrover_tpu_torch.master.servicer import MasterServicer

        self.rdzv = ElasticTrainingRendezvousManager()
        self.servicer = MasterServicer(
            rdzv_managers={self.rdzv.name: self.rdzv}
        )

    def restart(self):
        self.restarts += 1
        self._build()


class _RestartableLocalClient:
    """A master client bound to a :class:`_MasterHandle`, so a
    mid-drill master restart swaps the backend under live calls."""

    def __new__(cls, handle: _MasterHandle, node_id: int = 0):
        from dlrover_tpu_torch.agent.master_client import MasterClient
        from dlrover_tpu_torch.common import comm

        class _Client(MasterClient):
            def _report_raw(self, envelope: bytes) -> bytes:
                return handle.servicer.report(
                    comm.Message.from_json(envelope)
                ).to_json()

            def _get_raw(self, envelope: bytes) -> bytes:
                return handle.servicer.get(
                    comm.Message.from_json(envelope)
                ).to_json()

        return _Client("local-chaos", node_id)


# ---------------------------------------------------------------------------
# Tiny training state helpers (the reference's leaves, as torch tensors).
# ---------------------------------------------------------------------------


def _make_state(step: int, device: torch.device, big: bool = False):
    # several leaves, big enough for multiple stream chunks; ``big``
    # spans multiple PERSIST chunks too (the pool floors chunk size at
    # 1 MiB, so the CRC scenario needs a multi-MiB payload)
    n = (1 << 19) if big else 4096
    return {
        "w": torch.arange(n, dtype=torch.float32, device=device)
        + float(step),
        "b": torch.ones((512,), dtype=torch.float32, device=device)
        * float(step),
        "step": torch.tensor(step, dtype=torch.int32, device=device),
    }


def _target(state):
    """A restore target of ``state``'s structure (filled in place)."""
    return {k: torch.zeros_like(v) for k, v in state.items()}


def _state_equal(a, b) -> bool:
    if a is None or b is None or set(a) != set(b):
        return False
    return all(
        a[k].dtype == b[k].dtype
        and torch.equal(a[k].cpu(), b[k].cpu())
        for k in a
    )


# ---------------------------------------------------------------------------
# Scenario harness.
# ---------------------------------------------------------------------------


def _check(checks: Dict[str, bool], name: str, ok: bool, detail: str = ""):
    checks[name] = bool(ok)
    if not ok:
        logger.error("chaos drill invariant FAILED: %s %s", name, detail)


def capture_incident(name: str, workdir: str,
                      checks: Dict[str, bool]) -> Dict[str, Any]:
    """Close the detection -> evidence -> verdict loop for one scenario:
    open an incident (master-side dump of this process's flight
    recorder, which holds the scenario's mirrored chaos faults and
    finished spans), finalize it, and assert the evidence-derived
    classification against :data:`INCIDENT_EXPECTATIONS`.  No phase
    hint is passed — the verdict must come from the captured evidence,
    or the diagnosis surface has regressed."""
    from dlrover_tpu_torch.observability.incidents import IncidentManager

    expected_phase, expected_point = INCIDENT_EXPECTATIONS[name]
    with _env(
        DLROVER_TPU_INCIDENT_DIR=os.path.join(workdir, "incidents"),
        DLROVER_TPU_INCIDENT_COOLDOWN_S="0",
        DLROVER_TPU_INCIDENT_GRACE_S="0",
    ):
        manager = IncidentManager()
        incident_id = manager.open(
            f"drill_{name}", detail=f"chaos drill scenario {name}",
            broadcast=False,
        )
        incident = manager.finalize(incident_id, force=True) or {}
        incident_path = os.path.join(
            manager.incident_dir(incident_id), "INCIDENT.json"
        )
        _check(checks, "incident_json_written",
               os.path.exists(incident_path), incident_path)
    _check(
        checks, "incident_classified_phase",
        incident.get("phase") == expected_phase,
        f"expected {expected_phase!r}, got {incident.get('phase')!r}",
    )
    dominant = (incident.get("chaos") or {}).get("point", "")
    _check(
        checks, "incident_chaos_attributed",
        dominant == expected_point,
        f"expected fault {expected_point!r}, got {dominant!r}",
    )
    timeline = incident.get("timeline") or {}
    _check(
        checks, "incident_timeline_forest",
        bool(timeline.get("forest_ok")) or timeline.get("spans", 0) == 0,
        f"timeline {timeline}",
    )
    return {
        "incident": {
            "kind": incident.get("kind"),
            "phase": incident.get("phase"),
            "culprit_node": incident.get("culprit_node"),
            "stuck_op": incident.get("stuck_op"),
            "chaos": incident.get("chaos"),
            "timeline": timeline,
        }
    }


def reset_evidence() -> None:
    """Per-scenario evidence isolation: chaos faults mirrored into the
    flight recorder by an EARLIER scenario must not outvote this one's,
    and the goodput ledger starts from a fresh wall clock so the
    dominant-phase assertions judge THIS scenario."""
    from dlrover_tpu_torch.observability import (
        commscope,
        flight_recorder,
        goodput,
        memscope,
    )

    flight_recorder.recorder().reset()
    goodput.reset_ledger()
    commscope.reset_scope()
    memscope.reset_scope()


def _run_with_plan(
    name: str, seed: int, body: Callable[[Dict], Dict[str, bool]],
    device: torch.device,
) -> Dict[str, Any]:
    """Arm the named scenario, run ``body``, capture + classify the
    incident, disarm, package results."""
    plan = chaos.scenario_plan(name, seed)
    workdir = tempfile.mkdtemp(prefix=f"chaos_drill_{name}_")
    t0 = time.time()
    checks: Dict[str, bool] = {}
    error = ""
    try:
        reset_evidence()
        chaos.configure(plan)
        detail = body({"workdir": workdir, "checks": checks,
                       "device": device}) or {}
        if name in INCIDENT_EXPECTATIONS:
            # while the plan is still armed: finalize() folds the live
            # engine trace into the chaos evidence
            detail.update(capture_incident(name, workdir, checks))
    except Exception as e:  # noqa: BLE001 - a scenario must report, not kill
        # the drill
        logger.exception("chaos drill scenario %s crashed", name)
        error = f"{type(e).__name__}: {e}"
        detail = {}
    finally:
        trace = chaos.trace()
        chaos.clear()
        shutil.rmtree(workdir, ignore_errors=True)
    result = {
        "scenario": name,
        "seed": seed,
        "ok": bool(checks) and all(checks.values()) and not error,
        "checks": checks,
        "faults_fired": len(trace),
        "trace": trace,
        "wall_s": round(time.time() - t0, 2),
    }
    if error:
        result["error"] = error
    result.update(detail)
    return result


# ---------------------------------------------------------------------------
# Scenarios.
# ---------------------------------------------------------------------------


def _scenario_master_restart(ctx: Dict) -> Dict:
    """Train + checkpoint while the master transport black-holes a
    window of calls and the master is replaced mid-save.  The agent-side
    retry policy must ride through; commits must stay monotone."""
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        Checkpointer,
        StorageType,
    )
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
        read_tracker,
    )

    checks, device = ctx["checks"], ctx["device"]
    ckpt_dir = os.path.join(ctx["workdir"], "ckpt")
    with _env(
        DLROVER_TPU_RPC_RETRY_BASE_S="0.02",
        DLROVER_TPU_RPC_RETRY_MAX_S="0.1",
    ):
        handle = _MasterHandle()
        client = _RestartableLocalClient(handle)
        ckpt = Checkpointer(ckpt_dir, scope=_scope(), async_snapshot=False,
                            device=device)
        tracker_history: List[int] = []
        try:
            state = _make_state(0, device)
            for step in range(1, _TARGET_STEP + 1):
                state = _make_state(step, device)  # the "train step"
                client.report_global_step(step)
                if step % 3 == 0:
                    ckpt.save_checkpoint(step, state, StorageType.DISK)
                    ckpt.wait_latest_checkpoint(timeout=60)
                    tracker_history.append(read_tracker(ckpt_dir) or -1)
                if step == 6:
                    handle.restart()  # master replaced mid-run
            _check(
                checks, "rpc_survived_restart_window",
                client.kv_store_set("drill/alive", b"1"),
                "post-restart kv write failed",
            )
            _check(
                checks, "committed_step_monotone",
                all(
                    a <= b for a, b in
                    zip(tracker_history, tracker_history[1:])
                ),
                f"tracker history {tracker_history}",
            )
            _check(
                checks, "final_commit_landed",
                tracker_history and tracker_history[-1] == _TARGET_STEP,
                f"tracker history {tracker_history}",
            )
            restored, step = ckpt.load_checkpoint(_target(state))
            _check(checks, "restore_step", step == _TARGET_STEP,
                   f"got {step}")
            _check(
                checks, "restore_bit_exact",
                restored is not None
                and _state_equal(restored, _make_state(step, device)),
            )
            return {
                "master_restarts": handle.restarts,
                "tracker_history": tracker_history,
            }
        finally:
            ckpt.engine.unlink_memory()
            ckpt.close()


def _scenario_torn_shm(ctx: Dict) -> Dict:
    """A stream into shm dies mid-write AFTER a durable step exists.
    Restore must detect the torn generation and fall back to the
    committed storage step — never the torn bytes, never a regression
    below the commit."""
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        Checkpointer,
        StorageType,
        snapshot,
    )

    checks, device = ctx["checks"], ctx["device"]
    ckpt_dir = os.path.join(ctx["workdir"], "ckpt")
    ckpt = Checkpointer(ckpt_dir, scope=_scope(), async_snapshot=False,
                        device=device)
    try:
        committed = _make_state(5, device)
        ckpt.save_checkpoint(5, committed, StorageType.DISK)
        ckpt.wait_latest_checkpoint(timeout=60)
        # stream step 10 into the engine's shm; the armed fault kills it
        # mid-write (chunk >= 2)
        torn_state = _make_state(10, device)
        raised = False
        try:
            snapshot.stream_snapshot(
                ckpt.engine._shm, 10,
                snapshot.plan_shards(torn_state), chunk_bytes=1 << 12,
            )
        except chaos.ChaosError:
            raised = True
        _check(checks, "stream_died_mid_write", raised)
        _check(checks, "shm_detected_torn",
               snapshot.is_torn(ckpt.engine._shm))
        restored, step = ckpt.load_checkpoint(_target(committed))
        _check(checks, "fell_back_to_committed_step", step == 5,
               f"got {step}")
        _check(
            checks, "restore_bit_exact",
            restored is not None and _state_equal(restored, committed),
        )
        # bounded resume: train on from the restored step to the target
        resumed_steps = 0
        for step in range(step + 1, _TARGET_STEP + 1):
            _ = _make_state(step, device)
            resumed_steps += 1
        _check(checks, "resumed_within_bound",
               resumed_steps == _TARGET_STEP - 5)
        return {"resumed_steps": resumed_steps}
    finally:
        ckpt.engine.unlink_memory()
        ckpt.close()


def _scenario_storage_stall(ctx: Dict) -> Dict:
    """Persist writes stall (slow NFS / object store).  The save path
    must absorb the stall and still commit; nothing regresses."""
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        Checkpointer,
        StorageType,
    )
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
        read_tracker,
    )

    checks, device = ctx["checks"], ctx["device"]
    ckpt_dir = os.path.join(ctx["workdir"], "ckpt")
    ckpt = Checkpointer(ckpt_dir, scope=_scope(), async_snapshot=False,
                        device=device)
    try:
        state = _make_state(7, device)
        t0 = time.time()
        ckpt.save_checkpoint(7, state, StorageType.DISK)
        done = ckpt.wait_latest_checkpoint(timeout=120)
        wall = time.time() - t0
        _check(checks, "commit_landed_despite_stall", done)
        _check(checks, "tracker_at_step", read_tracker(ckpt_dir) == 7)
        delays = [r for r in chaos.trace() if r["kind"] == chaos.DELAY]
        _check(checks, "stalls_injected", len(delays) >= 1,
               f"trace {chaos.trace()}")
        _check(checks, "stall_actually_slowed_persist", wall >= 0.5,
               f"wall {wall:.2f}s")
        restored, step = ckpt.load_checkpoint(_target(state))
        _check(checks, "restore_step", step == 7, f"got {step}")
        _check(
            checks, "restore_bit_exact",
            restored is not None and _state_equal(restored, state),
        )
        # goodput ledger: the stalled persist's flash.save/persist/
        # restore spans must dominate this scenario's wall-clock account
        from dlrover_tpu_torch.observability import goodput

        ledger = goodput.ledger().summary()
        _check(
            checks, "ledger_dominant_ckpt_stall",
            ledger["dominant"] == "ckpt_stall"
            and ledger["phases"]["ckpt_stall"] > 0,
            f"ledger {ledger}",
        )
        return {
            "persist_wall_s": round(wall, 2),
            "ledger_phases": ledger["phases"],
        }
    finally:
        ckpt.engine.unlink_memory()
        ckpt.close()


def _scenario_storage_crc(ctx: Dict) -> Dict:
    """A persisted chunk is silently corrupted on disk (torn writeback)
    while its CRC record describes the intended bytes.  An
    eager-verifying restore from storage must REFUSE the corrupt step
    and fall back to the older commit — corruption detected, not
    restored."""
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        Checkpointer,
        StorageType,
    )
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
        read_tracker,
    )

    checks, device = ctx["checks"], ctx["device"]
    ckpt_dir = os.path.join(ctx["workdir"], "ckpt")
    with _env(
        DLROVER_TPU_VERIFY_CRC="eager",
        DLROVER_TPU_PERSIST_WRITERS="1",  # deterministic chunk order
        DLROVER_TPU_PERSIST_CHUNK_BYTES=str(1 << 20),  # the pool's floor
    ):
        # the plan's spec corrupts persisted chunk #1 of the FIRST save
        # (the standalone shape); this drill wants a clean baseline
        # commit first, so re-target the corruption at the SECOND save's
        # second chunk — nth-call scheduling is relative to the armed
        # plan's per-point counters
        chaos.clear("storage.write_chunk")
        ckpt = Checkpointer(ckpt_dir, scope=_scope(), async_snapshot=False,
                            device=device)
        chunks_step3 = 0
        try:
            ckpt.save_checkpoint(3, _make_state(3, device, big=True),
                                 StorageType.DISK)
            ckpt.wait_latest_checkpoint(timeout=60)
            chunks_step3 = chaos.engine().call_count("storage.write_chunk")
            chaos.inject(chaos.FaultSpec(
                point="storage.write_chunk",
                kind=chaos.TORN_WRITE,
                on_calls=[chunks_step3 + 1],
            ))
            ckpt.save_checkpoint(6, _make_state(6, device, big=True),
                                 StorageType.DISK)
            ckpt.wait_latest_checkpoint(timeout=60)
            _check(checks, "corrupt_commit_recorded",
                   read_tracker(ckpt_dir) == 6)
        finally:
            ckpt.engine.unlink_memory()
            ckpt.close()
        torn = [r for r in chaos.trace() if r["kind"] == chaos.TORN_WRITE]
        _check(checks, "corruption_injected", len(torn) == 1,
               f"trace {chaos.trace()}")
        # a REPLACEMENT host restores (fresh shm scope): storage only
        ckpt2 = Checkpointer(ckpt_dir, scope=_scope(), async_snapshot=False,
                             device=device)
        try:
            restored, step = ckpt2.load_checkpoint(
                _target(_make_state(3, device, big=True)))
            _check(checks, "corrupt_step_refused", step == 3,
                   f"got {step}")
            _check(
                checks, "older_commit_bit_exact",
                restored is not None
                and _state_equal(restored, _make_state(3, device, big=True)),
            )
        finally:
            ckpt2.engine.unlink_memory()
            ckpt2.close()
        return {"chunks_step3": chunks_step3}


def _scenario_node_flap(ctx: Dict) -> Dict:
    """A node's rendezvous join is swallowed twice (flap) — its agent's
    poll loop re-joins and the round still seals with BOTH nodes."""
    from dlrover_tpu_torch.master.rdzv_manager import (
        ElasticTrainingRendezvousManager,
    )
    from dlrover_tpu_torch.observability import goodput, trace

    checks = ctx["checks"]
    rdzv = ElasticTrainingRendezvousManager()
    rdzv.update_rdzv_params(
        min_nodes=2, max_nodes=2, waiting_timeout=0.5, node_unit=1
    )
    # the whole flap-and-rejoin window rides one rdzv.join span (the
    # same name MasterClient.join_rendezvous opens), so the goodput
    # ledger attributes this scenario's wall clock to rendezvous
    with trace.span("rdzv.join"):
        rdzv.join_rendezvous(node_id=0, node_rank=0)  # call 0: lands
        joins = 1
        world: Dict = {}
        deadline = time.time() + 20
        while time.time() < deadline:
            # the flapping node keeps re-joining until it is in a world —
            # exactly what ElasticAgent._rendezvous's poll loop does after
            # a restart
            rdzv.join_rendezvous(node_id=1, node_rank=1)
            joins += 1
            _, _, world = rdzv.get_comm_world(node_id=1)
            if world:
                break
            time.sleep(0.05)
    flaps = [r for r in chaos.trace() if r["kind"] == chaos.FLAP]
    _check(checks, "joins_flapped", len(flaps) == 2,
           f"trace {chaos.trace()}")
    _check(checks, "round_sealed_with_both_nodes",
           {m.node_id for m in world.values()} == {0, 1},
           f"world {world}")
    _check(checks, "flapping_node_needed_retries", joins >= 3,
           f"{joins} joins")
    # goodput ledger: the rejoin window must dominate the account
    ledger = goodput.ledger().summary()
    _check(
        checks, "ledger_dominant_rendezvous",
        ledger["dominant"] == "rendezvous_restart"
        and ledger["phases"]["rendezvous_restart"] > 0,
        f"ledger {ledger}",
    )
    return {"joins": joins, "ledger_phases": ledger["phases"]}


def _scenario_kv_timeout(ctx: Dict) -> Dict:
    """kv long-poll chunks black-hole for a window while a waiter
    blocks (the barrier shape).  The wait must complete once the window
    passes — within its deadline, with the right value."""
    checks = ctx["checks"]
    handle = _MasterHandle()
    with _env(
        DLROVER_TPU_RPC_RETRY_BASE_S="0.02",
        DLROVER_TPU_RPC_RETRY_MAX_S="0.1",
    ):
        client = _RestartableLocalClient(handle)

    def _publish():
        time.sleep(0.15)
        client.kv_store_set("drill/barrier", b"token")

    publisher = threading.Thread(target=_publish, daemon=True)
    publisher.start()
    t0 = time.time()
    value = client.kv_store_wait("drill/barrier", timeout=15.0, poll=0.05)
    wall = time.time() - t0
    publisher.join(timeout=5)
    drops = [r for r in chaos.trace() if r["kind"] == chaos.DROP]
    _check(checks, "barrier_completed", value == b"token",
           f"got {value!r}")
    _check(checks, "reads_dropped_during_window", len(drops) == 4,
           f"trace {chaos.trace()}")
    _check(checks, "completed_within_deadline", wall < 15.0,
           f"wall {wall:.2f}s")
    return {"barrier_wall_s": round(wall, 2)}


def _scenario_heartbeat_loss(ctx: Dict) -> Dict:
    """Agent heartbeats are swallowed for a window long enough that the
    master-side node silence crosses the no-heartbeat threshold, then
    recover.  The master must SEE the gap (detection works) and see
    heartbeats resume (no permanent kill of a recovered node)."""
    from dlrover_tpu_torch.agent.elastic_agent import (
        ElasticAgent,
        ElasticLaunchConfig,
    )
    from dlrover_tpu_torch.common.global_context import Context
    from dlrover_tpu_torch.common.node import Node
    from dlrover_tpu_torch.master.job_context import get_job_context

    checks = ctx["checks"]
    handle = _MasterHandle()
    with _env(
        DLROVER_TPU_RPC_RETRY_BASE_S="0.02",
        DLROVER_TPU_RPC_RETRY_MAX_S="0.1",
    ):
        client = _RestartableLocalClient(handle)
    job_ctx = get_job_context()
    node = Node(node_id=0)
    job_ctx.update_job_node(node)
    agent = ElasticAgent(client, ElasticLaunchConfig())
    ctx_singleton = Context.singleton_instance()
    saved_interval = ctx_singleton.heartbeat_interval_secs
    ctx_singleton.heartbeat_interval_secs = 0.05
    hb_thread = threading.Thread(
        target=agent._heartbeat_loop, daemon=True
    )
    seen: List[float] = []
    gap = 0.0
    try:
        hb_thread.start()
        deadline = time.time() + 15
        # sample the master's view of the node's heartbeat timestamps
        while time.time() < deadline:
            ts = node.heartbeat_time
            if ts and (not seen or ts != seen[-1]):
                seen.append(ts)
            if len(seen) >= 6:
                break
            time.sleep(0.02)
    finally:
        agent._stop_heartbeat.set()
        hb_thread.join(timeout=5)
        ctx_singleton.heartbeat_interval_secs = saved_interval
        job_ctx.remove_job_node(node.type, node.id)
    gaps = [b - a for a, b in zip(seen, seen[1:])]
    gap = max(gaps) if gaps else 0.0
    drops = [r for r in chaos.trace() if r["kind"] == chaos.DROP]
    _check(checks, "heartbeats_dropped", len(drops) == 5,
           f"trace {chaos.trace()}")
    # 5 dropped ticks at 0.05s ≈ a 0.3s master-side silence window vs
    # the ~0.05s healthy cadence: the gap IS the detectable signal a
    # real master compares against DLROVER_TPU_HEARTBEAT_TIMEOUT
    _check(checks, "master_observed_silence_window", gap >= 0.2,
           f"max gap {gap:.3f}s over {seen}")
    _check(checks, "heartbeats_resumed_after_window", len(seen) >= 4,
           f"{len(seen)} heartbeats seen")
    return {"max_gap_s": round(gap, 3), "heartbeats_seen": len(seen)}


def _scenario_torn_commit(ctx: Dict) -> Dict:
    """Distributed two-phase commit under host/coordinator death.

    Two simulated hosts commit a step through the REAL servicer's
    commit coordinator (phase-1 manifests over the report demux).  Then
    (a) BOTH hosts die between persisting their shard bytes and their
    phase-1 report — the step must never seal and a restore must land
    bit-exact on the previous committed step (no torn global
    checkpoint); (b) the coordinator dies at phase-2 — the commit
    record is never published, the watermark holds, and an idempotent
    re-report retries the seal to full recovery."""
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        distributed as dist,
    )

    checks, device = ctx["checks"], ctx["device"]
    ckpt_dir = os.path.join(ctx["workdir"], "dckpt")
    handle = _MasterHandle()
    with _env(
        DLROVER_TPU_RPC_RETRY_BASE_S="0.02",
        DLROVER_TPU_RPC_RETRY_MAX_S="0.1",
    ):
        clients = [
            _RestartableLocalClient(handle, node_id=p) for p in (0, 1)
        ]
    engines = [
        dist.DistributedCheckpointEngine(
            ckpt_dir, process_id=p, num_processes=2,
            client=dist.MasterCommitClient(clients[p]),
        )
        for p in (0, 1)
    ]
    # round A (phase-1 calls 1,2): a clean two-host commit
    state4 = _make_state(4, device)
    engines[0].save(4, state4, wait_seal=False)
    sealed_a = engines[1].save(4, state4, wait_seal=True, timeout=30)
    _check(checks, "baseline_two_host_commit_sealed",
           bool(sealed_a["sealed"]), f"stats {sealed_a}")
    # round B (calls 3,4 DROPPED): both writers die after their shard
    # bytes land but before the coordinator hears about them
    state8 = _make_state(8, device)
    stats_b = [e.save(8, state8, wait_seal=False) for e in engines]
    _check(
        checks, "phase1_reports_died_with_hosts",
        not stats_b[0]["reported"] and not stats_b[1]["reported"],
        f"stats {stats_b}",
    )
    status8 = clients[0].get_ckpt_commit_status(ckpt_dir, 8)
    _check(
        checks, "torn_step_never_sealed",
        not status8.sealed and status8.committed_step == 4,
        f"status {status8}",
    )
    reader = dist.DistributedCheckpointEngine(
        ckpt_dir, process_id=0, num_processes=1,
        client=dist.MasterCommitClient(clients[0]),
    )
    restored, step = reader.load(_target(state4))
    _check(checks, "restore_previous_commit", step == 4, f"got {step}")
    _check(
        checks, "restore_bit_exact",
        restored is not None and _state_equal(restored, state4),
    )
    # round C (calls 5,6; seal attempt 2 EXCEPTIONS): the coordinator
    # dies at phase-2, before publishing the commit record
    state12 = _make_state(12, device)
    engines[0].save(12, state12, wait_seal=False)
    engines[1].save(12, state12, wait_seal=False)
    status12 = clients[0].get_ckpt_commit_status(ckpt_dir, 12)
    _check(
        checks, "phase2_crash_left_step_unsealed",
        not status12.sealed and bool(status12.reason),
        f"status {status12}",
    )
    _check(checks, "commit_watermark_intact",
           status12.committed_step == 4, f"status {status12}")
    # recovery: an idempotent re-report (differential — every shard
    # chains to the already-written files) retries the seal
    recovery = engines[1].save(12, state12, wait_seal=True, timeout=30)
    _check(checks, "reseal_after_coordinator_recovery",
           bool(recovery["sealed"]), f"stats {recovery}")
    _check(checks, "recovery_wrote_no_new_bytes",
           recovery["bytes_written"] == 0, f"stats {recovery}")
    restored12, step12 = reader.load(_target(state12))
    _check(checks, "recovered_restore_bit_exact",
           step12 == 12 and restored12 is not None
           and _state_equal(restored12, state12), f"got {step12}")
    return {
        "committed_after_torn": int(status8.committed_step),
        "bytes_written_recovery": int(recovery["bytes_written"]),
    }


_SCENARIO_BODIES: Dict[str, Callable[[Dict], Dict]] = {
    "master_restart": _scenario_master_restart,
    "torn_shm": _scenario_torn_shm,
    "storage_stall": _scenario_storage_stall,
    "storage_crc": _scenario_storage_crc,
    "node_flap": _scenario_node_flap,
    "kv_timeout": _scenario_kv_timeout,
    "heartbeat_loss": _scenario_heartbeat_loss,
    "torn_commit": _scenario_torn_commit,
}

#: the scenarios this drill runs (``run_drill``'s default)
PORTED = tuple(sorted(_SCENARIO_BODIES))


def normalized_trace(
    trace: List[Dict[str, Any]]
) -> List[Dict[str, Any]]:
    """Fault trace with span/trace ids reduced to attribution booleans.

    The ids themselves are random per run; WHETHER a fault landed on a
    live traced span is deterministic for a seed — so the replay-
    determinism contract extends to fault->span attribution without
    pinning id values."""
    return [
        {
            **record,
            "trace_id": bool(record.get("trace_id")),
            "span_id": bool(record.get("span_id")),
        }
        for record in trace
    ]


def run_scenario(name: str, seed: int = 0,
                 device: DeviceLike = None) -> Dict[str, Any]:
    """Run one scenario; returns the result dict (``ok``, ``checks``,
    ``trace``, timing).  ``device``: where the states live (the card by
    default).  A scenario of :data:`WAITING` raises
    ``NotImplementedError``; an unknown name ``KeyError``."""
    if name in WAITING:
        raise NotImplementedError(
            f"chaos scenario {name!r} drives modules the port does not "
            f"have yet ({WAITING[name]})")
    try:
        body = _SCENARIO_BODIES[name]
    except KeyError:
        raise KeyError(
            f"unknown chaos scenario {name!r}; have "
            f"{list(PORTED)}"
        ) from None
    return _run_with_plan(name, seed, body, resolve_device(device))


def run_drill(
    scenarios: Optional[List[str]] = None,
    seed: int = 0,
    replay_check: bool = True,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Run the scenario matrix (every ported scenario by default).
    ``replay_check`` re-runs torn_shm and asserts the normalized fault
    trace is identical — the determinism contract."""
    names = scenarios or list(PORTED)
    results = [run_scenario(n, seed, device) for n in names]
    out: Dict[str, Any] = {
        "seed": seed,
        "scenarios": {r["scenario"]: r for r in results},
        "passed": sum(1 for r in results if r["ok"]),
        "failed": sum(1 for r in results if not r["ok"]),
    }
    if replay_check and "torn_shm" in names:
        first = normalized_trace(out["scenarios"]["torn_shm"]["trace"])
        replay = normalized_trace(
            run_scenario("torn_shm", seed, device)["trace"])
        # attribution rides the comparison: both runs must agree not
        # just on WHAT fired but on whether each fault landed on a live
        # traced span
        out["replay_deterministic"] = first == replay
        if not out["replay_deterministic"]:
            out["failed"] += 1
    out["ok"] = out["failed"] == 0
    return out


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    device: Optional[str] = None
    names: List[str] = []
    it = iter(argv)
    for arg in it:
        if arg == "--device":
            device = next(it, None)
        elif arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        elif not arg.startswith("-"):
            names.append(arg)
    # no fallback: with no card and no --device cpu this raises
    dev = resolve_device(device)
    seed = int(os.environ.get("CHAOS_DRILL_SEED", "0") or "0")
    result = run_drill(scenarios=names or None, seed=seed, device=dev)
    slim = {
        k: v for k, v in result.items() if k != "scenarios"
    }
    slim["device"] = str(dev)
    slim["scenarios"] = {
        name: {
            "ok": r["ok"],
            "checks": r["checks"],
            "faults_fired": r["faults_fired"],
            "wall_s": r["wall_s"],
            **({"error": r["error"]} if "error" in r else {}),
        }
        for name, r in result["scenarios"].items()
    }
    print("CHAOS_DRILL " + json.dumps(slim), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
