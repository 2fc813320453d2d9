"""End-to-end recovery drill: elastic training under scripted chaos.

Copy of ``dlrover_tpu/diagnosis/chaos_drill.py``'s harness and of the
fourteen scenarios that run on modules the port has: ``master_restart``,
``torn_shm``, ``storage_stall``, ``storage_crc``, ``node_flap``,
``live_reshard`` (the job's 4 rank processes shrink dp4 -> dp2 in place,
against a restart path of new rank processes restoring from storage),
``kv_timeout``, ``heartbeat_loss``, ``torn_commit``, the four that
drive the master's time-series store and the sentinels: ``slow_link``,
``hbm_leak``, ``cache_cold`` and ``peer_restore``, and ``data_starved``,
which drives the sharding client against the master's shard telemetry.
The drill asserts *that* the documented recovery invariants hold under
each scripted failure mode, with faults manufactured deterministically by
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
without one), ``"cpu"`` when asked for.  ``cache_cold`` and
``peer_restore`` build a kernel source (:data:`DRILL_KERNEL`) into
directories of their own, so they need nvcc (on the card's machine; a
test gives ``_build`` a stand-in compiler).  The last scenario,
``fabric_reroute``, waits for the modules it drives and raises
``NotImplementedError`` naming its ROADMAP item (:data:`WAITING`).

Run standalone::

    python -m dlrover_tpu_torch.diagnosis.chaos_drill [--device cpu] [scenario ...]

which prints one ``CHAOS_DRILL {...}`` line and exits 0 when every
scenario passed (``CHAOS_DRILL_SEED`` picks the seed).
"""

import contextlib
import json
import math
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
#: that brings what they drive: the hierarchical fabric tuner
WAITING: Dict[str, str] = {
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
        datascope,
        flight_recorder,
        goodput,
        memscope,
    )

    flight_recorder.recorder().reset()
    goodput.reset_ledger()
    commscope.reset_scope()
    # the data observatory's agent-side wait/process counters are
    # process-global for the same reason
    datascope.reset_scope()
    memscope.reset_scope()


def _run_with_plan(
    name: str, seed: int, body: Callable[[Dict], Dict[str, bool]],
    device: torch.device, options: Optional[Dict[str, Any]] = None,
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
        ctx = {"workdir": workdir, "checks": checks, "device": device,
               "clock": WallClock}
        ctx.update(options or {})
        detail = body(ctx) or {}
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


#: the live_reshard scenario's job: the reference's tiny Llama (4 kv
#: heads), a global batch of 8 rows of 32 tokens, AdamW at lr 1e-2, the
#: int8_sharded sync over dp4
_RESHARD_WORLD, _RESHARD_SHRUNK = 4, 2


def _reshard_job(root: str) -> Dict[str, Any]:
    import numpy as np

    ids = np.random.default_rng(11).integers(0, 256, size=(8, 33))
    return dict(
        preset="tiny", model=dict(num_kv_heads=4), state_dict=None, seed=0,
        batch={"input_ids": ids[:, :-1].astype(np.int32),
               "labels": ids[:, 1:].astype(np.int32)},
        root=root, scope=_scope())


def _reshard_trainer(job: Dict[str, Any], device, mesh):
    from dlrover_tpu_torch.parallel import dp_workers
    from dlrover_tpu_torch.trainer import optim
    from dlrover_tpu_torch.trainer.train import Trainer

    model = dp_workers.make_model(job, device)
    return Trainer(model, optim.adamw(lambda count: 1e-2), device=device,
                   grad_sync="int8_sharded", mesh=mesh)


def _host_leaves(state) -> Dict[str, Any]:
    from dlrover_tpu_torch.common.pytree import flatten_with_path

    return {p: (v.detach().cpu().numpy().copy() if torch.is_tensor(v)
                else v) for p, v in flatten_with_path(state)}


def _leaves_equal(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    import numpy as np

    return a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) if hasattr(a[k], "shape")
        else a[k] == b[k] for k in a)


def live_reshard_rank(group, job: Dict[str, Any]) -> Dict[str, Any]:
    """A rank of the running job: one quantized step at dp4 and a flash
    checkpoint on disk (what the restart path reloads), then the live
    shrink to dp2 in place, priced by this rank's own ledger, and one
    step on the new mesh."""
    from dlrover_tpu_torch.observability import goodput
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        Checkpointer,
        StorageType,
    )

    device = group.device
    trainer = _reshard_trainer(
        job, device, build_mesh(MeshConfig(dp=_RESHARD_WORLD), device=device))
    rows = trainer.rows_of_global_batch(job["batch"])
    state = trainer.create_state()
    state, _ = trainer.train_step(state, trainer.shard_batch(rows))
    ckpt = Checkpointer(job["root"], scope=job["scope"], device=device)
    ckpt.save_checkpoint(1, state, StorageType.DISK, trainer=trainer)
    saved = ckpt.wait_latest_checkpoint(timeout=120)
    # process 0 commits the step once every process persisted its part
    group.all_reduce(torch.zeros(1, device=device))
    ckpt.engine.unlink_memory()
    ckpt.close()
    with _env(DLROVER_TPU_GOODPUT_RES_S="0.005"):
        goodput.reset_ledger()
        state_live, report = trainer.live_reshard(
            state, {"dp": _RESHARD_SHRUNK}, reason="chaos drill scale plan")
        phases = goodput.ledger().summary()["phases"]
    out = {"saved": saved, "phases": phases, "report": report}
    if state_live is not None:
        out["state"] = _host_leaves(state_live)
        rows = trainer.rows_of_global_batch(job["batch"])
        _, metrics = trainer.train_step(state_live, trainer.shard_batch(rows))
        out["loss"] = metrics["loss"].item()
    trainer.close()
    return out


def restart_rank(group, job: Dict[str, Any]) -> Dict[str, Any]:
    """A respawned worker of the restart path: a cold process rebuilds the
    trainer at the shrunken mesh and restores the checkpoint from storage
    (``Trainer.load_state``, a scope of its own: no shm)."""
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.trainer.flash_checkpoint import Checkpointer

    device = group.device
    trainer = _reshard_trainer(
        job, device,
        build_mesh(MeshConfig(dp=_RESHARD_SHRUNK), device=device))
    ckpt = Checkpointer(job["root"], scope=_scope(), device=device)
    try:
        state, step = trainer.load_state(ckpt)
    finally:
        ckpt.engine.unlink_memory()
        ckpt.close()
    trainer.close()
    return {"step": step,
            "state": _host_leaves(state) if state is not None else None}


def _scenario_live_reshard(ctx: Dict) -> Dict:
    """The SAME dp4 -> dp2 shrink measured both ways.

    The BASELINE leg is the restart path as it runs when a scale plan
    sheds nodes: the flapping rendezvous window the world re-forms
    through, then a cold worker respawn (new rank processes: interpreter
    boot, torch and model import, trainer rebuild, full checkpoint
    restore from storage), the whole window priced into the ledger as
    ``rendezvous_restart`` seconds.  The LIVE leg is the identical
    transition done in place by the running job's 4 rank processes
    (``Trainer.live_reshard``): bit-exact against the restart restore,
    ZERO rendezvous seconds in its ranks' ledgers, and at least an order
    of magnitude cheaper.  The job runs first, so its checkpoint is what
    the restart path reloads; each leg is priced by its own ledger."""
    from dlrover_tpu_torch.master.rdzv_manager import (
        ElasticTrainingRendezvousManager,
    )
    from dlrover_tpu_torch.observability import goodput, trace
    from dlrover_tpu_torch.parallel import process_group

    checks = ctx["checks"]
    device = ctx["device"]
    job = _reshard_job(os.path.join(ctx["workdir"], "ckpt"))
    ranks = process_group.spawn(live_reshard_rank, _RESHARD_WORLD, (job,),
                                device=device.type, timeout_s=300)
    _check(checks, "baseline_saved", all(r["saved"] for r in ranks))

    # -- BASELINE: the restart path, measured ---------------------------
    with _env(DLROVER_TPU_GOODPUT_RES_S="0.005"):
        goodput.reset_ledger()
        rdzv = ElasticTrainingRendezvousManager()
        # the re-formed world after shedding 2 of 4 nodes: max_nodes is
        # still the old world, so the round never seals at max; the
        # survivors pay the elasticity window (2 s here, 30 s by default)
        rdzv.update_rdzv_params(
            min_nodes=2, max_nodes=4, waiting_timeout=2.0, node_unit=1
        )
        with trace.span("rdzv.join"):
            rdzv.join_rendezvous(node_id=0, node_rank=0)
            deadline = time.time() + 20
            while (time.time() < deadline
                   and rdzv.num_nodes_waiting() < 2):
                rdzv.join_rendezvous(node_id=1, node_rank=1)
                time.sleep(0.05)
            _, _, world = rdzv.wait_comm_world(node_id=1, timeout=15)
        _check(checks, "restart_world_sealed", bool(world), str(world))
        restored: List[Dict] = []
        with trace.span("rdzv.respawn_restore"):
            try:
                restored = process_group.spawn(
                    restart_rank, _RESHARD_SHRUNK, (job,),
                    device=device.type, timeout_s=300)
            except (RuntimeError, TimeoutError) as e:
                logger.error("respawned restore failed: %s", e)
        restart_phases = goodput.ledger().summary()["phases"]
        restart_s = restart_phases.get("rendezvous_restart", 0.0)
    _check(checks, "respawn_restored",
           len(restored) == _RESHARD_SHRUNK
           and all(r["step"] == 1 for r in restored),
           str([r.get("step") for r in restored]))
    _check(checks, "restart_path_priced", restart_s > 0.0,
           str(restart_phases))
    # the correctness reference: the respawned ranks' restored states
    _check(checks, "restart_baseline_step",
           bool(restored) and all(r["state"] is not None
                                  and r["state"]["step"] == 1
                                  for r in restored),
           str([r.get("step") for r in restored]))

    # -- LIVE: the same transition, in place, by the job's ranks --------
    live_phases = {
        phase: max(r["phases"].get(phase, 0.0) for r in ranks)
        for phase in ranks[0]["phases"]}
    live_s = live_phases.get("live_reshard", 0.0)
    _check(checks, "live_path_priced", live_s > 0.0, str(live_phases))
    _check(checks, "live_zero_rendezvous",
           live_phases.get("rendezvous_restart", 0.0) == 0.0,
           str(live_phases))
    _check(checks, "live_zero_donor_bytes",
           all(r["report"].get("donor_bytes_read", 0) == 0
               for r in ranks), str([r["report"] for r in ranks]))
    stayers = [r for r in ranks if "state" in r]
    _check(checks, "live_bit_exact_vs_restart",
           len(stayers) == len(restored) == _RESHARD_SHRUNK and all(
               _leaves_equal(live["state"], rest["state"])
               for live, rest in zip(stayers, restored)))
    _check(checks, "live_10x_cheaper_than_restart",
           live_s > 0 and restart_s >= 10.0 * live_s,
           f"restart={restart_s:.3f}s live={live_s:.3f}s")
    # continuation: training resumes on the resharded mesh
    _check(checks, "post_reshard_step_finite",
           bool(stayers) and all(math.isfinite(r["loss"]) for r in stayers))
    return {
        "restart_s": round(restart_s, 3),
        "live_reshard_s": round(live_s, 3),
        "reshard_speedup_vs_restart": round(restart_s / live_s, 1)
        if live_s else None,
        "restart_phases": restart_phases,
        "live_phases": live_phases,
    }


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


# ---------------------------------------------------------------------------
# The sentinel scenarios: the time-series store, the sentinels, the
# compile cache and the peer prewarm.
# ---------------------------------------------------------------------------

#: the kernel source the compile-cache scenarios build (the flash
#: attention library: the one every training step needs)
DRILL_KERNEL = "flash_attention"


class WallClock:
    """The drill's clock: the host's seconds and sleep.  A test may pass
    another (``run_scenario(..., clock=)``) whose ``now`` load cannot
    stretch; the drill times with nothing else where a check compares
    times."""

    @staticmethod
    def now() -> float:
        return time.perf_counter()

    @staticmethod
    def sleep(seconds: float) -> None:
        time.sleep(seconds)


def _scenario_slow_link(ctx: Dict) -> Dict:
    """One mesh axis gains a seeded injected latency — the simulated
    slow link.  The active mesh probe must price the asymmetry into the
    FabricModel, the master's comm series must show the spike on exactly
    that axis, the slow-link sentinel must fire, and the incident must
    classify ``phase=comm`` naming the axis and culprit rank.

    The probe uses a synthetic fabric runner (a fixed ~1ms op) so the
    drill is device-independent; the chaos DELAY lands inside the probe's
    timed window exactly as it does on a real mesh, and the master feed
    uses synthetic 1s-spaced timestamps so every probe round is its own
    completed time-series bucket without sleeping."""
    from dlrover_tpu_torch.diagnosis.diagnostician import DiagnosisManager
    from dlrover_tpu_torch.master.timeseries import TimeSeriesStore
    from dlrover_tpu_torch.observability import commscope
    from dlrover_tpu_torch.observability.incidents import IncidentManager
    from dlrover_tpu_torch.observability.sentinel import (
        SlowLinkDiagnostician,
    )

    checks, clock = ctx["checks"], ctx["clock"]
    with _env(
        DLROVER_TPU_SENTINEL_MIN_SAMPLES="3",
        DLROVER_TPU_SENTINEL_CONSECUTIVE="1",
        DLROVER_TPU_INCIDENT_DIR=os.path.join(ctx["workdir"], "incidents"),
        DLROVER_TPU_INCIDENT_COOLDOWN_S="0",
        DLROVER_TPU_INCIDENT_GRACE_S="0",
    ):
        model = commscope.FabricModel(alpha=1.0)
        probe = commscope.MeshProbe(
            {"dp": 2, "fsdp": 2},
            runner=lambda axis, kind: clock.sleep(0.001),
            reps=2, clock=clock.now,
        )
        store = TimeSeriesStore()
        manager = IncidentManager()
        diagnosis = DiagnosisManager()
        diagnosis.register(SlowLinkDiagnostician(store, res_s=1.0))
        diagnosis.set_incident_manager(manager)
        rounds = 12
        base = time.time() - rounds - 2
        for i in range(rounds):
            probe.probe_once(model)
            store.record_digest(0, model.digest(), ts=base + i)
        snapshot = model.snapshot()
        _check(
            checks, "probe_detected_asymmetry",
            snapshot["dp"]["lat_us"] > 10 * snapshot["fsdp"]["lat_us"],
            f"fabric {snapshot}",
        )
        delays = [r for r in chaos.trace() if r["kind"] == chaos.DELAY]
        _check(checks, "axis_delay_injected", len(delays) >= 4,
               f"trace {chaos.trace()}")
        _check(
            checks, "delay_priced_one_axis_only",
            bool(delays) and all(
                r["point"] == "comm.axis_delay.dp" for r in delays),
            f"delays {delays}",
        )
        series = store.series("job.comm.dp.lat_us", res=1.0)
        _check(
            checks, "master_series_shows_spike",
            bool(series) and max(p["max"] for p in series) > 10_000.0,
            f"series {series}",
        )
        healthy = store.series("job.comm.fsdp.lat_us", res=1.0)
        _check(
            checks, "healthy_axis_stays_quiet",
            bool(healthy) and max(p["max"] for p in healthy) < 10_000.0,
            f"series {healthy}",
        )
        actions = diagnosis.diagnose_once()
        _check(checks, "sentinel_fired",
               any(a.action_type == "event" for a in actions),
               f"actions {[a.action_type for a in actions]}")
        incidents = manager.list_incidents()
        _check(
            checks, "slow_link_incident_opened",
            bool(incidents) and incidents[0]["kind"] == "slow_link",
            json.dumps(incidents),
        )
        final: Dict[str, Any] = {}
        if incidents:
            final = manager.finalize(
                incidents[0]["incident_id"], force=True) or {}
        _check(checks, "incident_phase_comm",
               final.get("phase") == "comm",
               f"phase {final.get('phase')!r}")
        _check(checks, "incident_names_axis",
               "'dp'" in final.get("detail", ""),
               f"detail {final.get('detail')!r}")
        _check(checks, "incident_culprit_rank",
               final.get("culprit_node") == 0, f"incident {final}")
        fault = final.get("chaos") or {}
        _check(
            checks, "incident_names_injected_fault",
            fault.get("point") == "comm.axis_delay.dp"
            and fault.get("kind") == "delay",
            json.dumps(fault),
        )
        return {
            "fabric": snapshot,
            "delays_fired": len(delays),
            "sentinel_incident": {
                "kind": final.get("kind"),
                "phase": final.get("phase"),
                "detail": final.get("detail"),
            },
        }


def _dp_stacked_plan(gib: float):
    """The fit leg's state plan, priced from the port's own dp-stacked
    leaves (``memscope.plan_from_state`` with the axes a ZeRO-1 trainer's
    ``state_axes`` names): replicated params (2 GiB), AdamW moments split
    over dp, and the error-feedback residual stacked ``(dp, *leaf)`` and
    split over dp — at dp=4 the reference's 2 / 16 / 4 GiB global plan.
    The leaves are meta tensors: sized, never allocated."""
    from dlrover_tpu_torch.common.pytree import flatten_with_path
    from dlrover_tpu_torch.observability import memscope

    elems = int(gib) // 4  # fp32 elements of one GiB
    dp = 4
    meta = dict(dtype=torch.float32, device="meta")
    state = type("S", (), {})()
    state.params = {"w": torch.empty(2 * elems, **meta)}
    state.opt_state = {"m": torch.empty(2 * elems, **meta),
                       "v": torch.empty(2 * elems, **meta)}
    state.ef_residual = {"w": torch.empty(1, elems, **meta)}
    leaf_axes = {
        path: ["dp"]
        for field in ("opt_state", "ef_residual")
        for path, _ in flatten_with_path(getattr(state, field), field)
    }
    return memscope.plan_from_state(state, {"dp": dp}, leaf_axes)


def _scenario_hbm_leak(ctx: Dict) -> Dict:
    """The memory observatory's forecast -> dump -> incident loop under
    a synthetic leak, end to end:

    1. the real account contract first — a genuine torch state on the
       drill's device registered with the scope must yield a subsystem
       account that sums to the sampled in-use bytes within 5% (the
       card's allocator figure, or the live CPU tensors' bytes);
    2. then the leak: a chaos DROP on ``mem.pressure`` inflates the
       synthetic per-chip stats cumulatively per sample after a healthy
       window.  The ``MemPressureSentinel`` must open the ``hbm_leak``
       incident STRICTLY BEFORE the inflated figure crosses the chip
       limit (the injected OOM threshold), with a bounded gap;
    3. the post-mortem: an hbm_oom failure report then opens the crash
       incident, whose INCIDENT.json must embed the culprit's recent
       ``mem.*`` series and record that the forecast had already
       breached (predicted-vs-unpredicted OOMs distinguishable);
    4. ``fit_report`` prices a dp4->dp2 reshard of the port's dp-stacked
       leaves against the measured limit: dp4 must fit, dp2 must be
       rejected (the split optimizer/EF leaves double per chip), and a
       roomier fleet must accept dp2.

    Synthetic stats + 1s-spaced store timestamps keep it fast,
    device-count independent, and replay-deterministic."""
    from dlrover_tpu_torch.diagnosis.diagnostician import DiagnosisManager
    from dlrover_tpu_torch.master.timeseries import TimeSeriesStore
    from dlrover_tpu_torch.observability import memscope
    from dlrover_tpu_torch.observability.incidents import IncidentManager
    from dlrover_tpu_torch.observability.sentinel import MemPressureSentinel

    checks, device = ctx["checks"], ctx["device"]
    gib = float(2 ** 30)
    limit_b = 8.0 * gib  # the injected OOM threshold
    base_b = 5.0 * gib
    inflate_b = 0.5 * gib  # leak slope: one inflation per sample
    with _env(
        DLROVER_TPU_SENTINEL_CONSECUTIVE="2",
        DLROVER_TPU_MEM_CHAOS_INFLATE_B=str(inflate_b),
        DLROVER_TPU_MEM_EWMA_ALPHA="1.0",
        DLROVER_TPU_MEM_FORECAST_S="600",
        DLROVER_TPU_MEM_LEAK_SLOPE_B_S=str(64 * 2 ** 20),
        DLROVER_TPU_INCIDENT_DIR=os.path.join(ctx["workdir"], "incidents"),
        DLROVER_TPU_INCIDENT_COOLDOWN_S="0",
        DLROVER_TPU_INCIDENT_GRACE_S="0",
    ):
        # -- 1. the real account contract (genuine tensors) -------------
        real = memscope.MemScope()
        real.bind_device(device)
        w = torch.arange(1 << 18, dtype=torch.float32, device=device) * 0.5
        m = w * 2.0
        v = w * 3.0
        state = type("S", (), {})()
        state.params = {"w": w}
        state.opt_state = {"m": m, "v": v}
        state.ef_residual = None
        real.register_state(state)
        # this sample's mem.pressure firing is call index 0 — inside the
        # scenario's healthy window (after=4), so the real account is
        # never inflated
        account = real.sample()
        used = account["used_b"]
        total = account["account_sum_b"]
        _check(
            checks, "account_sums_to_bytes_in_use",
            account["account_ok"] and used > 0
            and abs(total - used) <= 0.05 * used,
            f"sum {total} vs used {used} ({account['subsystems']})",
        )
        nbytes = [float(t.numel() * t.element_size()) for t in (w, m, v)]
        state_b = sum(nbytes)
        subs = account["subsystems"]
        _check(
            checks, "state_subsystems_priced",
            abs(subs["params"] - nbytes[0]) < 1.0
            and abs(subs["optimizer"] - (nbytes[1] + nbytes[2])) < 1.0
            and used >= state_b,
            f"subs {subs} vs state {state_b}",
        )

        # -- 2. the synthetic leak + forecast sentinel ------------------
        def reader():
            return [
                {"device": i, "used_b": base_b, "limit_b": limit_b,
                 "peak_b": 0.0, "source": "synthetic"}
                for i in range(4)
            ]

        sc = memscope.reset_scope(stats_reader=reader)
        store = TimeSeriesStore()
        manager = IncidentManager()
        manager.set_timeseries(store)
        diagnosis = DiagnosisManager()
        diagnosis.register(MemPressureSentinel(store))
        diagnosis.set_incident_manager(manager)
        rounds = 14
        base_ts = time.time() - rounds - 2
        opened_round = None
        oom_round = None
        for i in range(rounds):
            sample = sc.sample()
            store.record_digest(0, sc.digest(), ts=base_ts + i)
            diagnosis.diagnose_once()
            if oom_round is None and sample["used_b"] >= limit_b:
                oom_round = i
            if opened_round is None and any(
                inc["kind"] == "hbm_leak"
                for inc in manager.list_incidents()
            ):
                opened_round = i
        _check(checks, "injected_oom_threshold_crossed",
               oom_round is not None, f"rounds {rounds}")
        _check(
            checks, "forecast_fired_strictly_before_oom",
            opened_round is not None and oom_round is not None
            and opened_round < oom_round,
            f"forecast at round {opened_round}, OOM at {oom_round}",
        )
        _check(
            checks, "forecast_margin_bounded",
            opened_round is not None and oom_round is not None
            and 2 <= (oom_round - opened_round) <= rounds,
            f"margin {oom_round} - {opened_round}",
        )
        series = store.series("node0.mem.used_b", res=1.0)
        _check(
            checks, "mem_series_shows_leak",
            bool(series)
            and max(p["max"] for p in series)
            >= min(p["min"] for p in series) + 2 * inflate_b,
            f"series {[(p['min'], p['max']) for p in series]}",
        )
        leak_incident: Dict[str, Any] = {}
        for inc in manager.list_incidents():
            if inc["kind"] == "hbm_leak":
                leak_incident = manager.finalize(
                    inc["incident_id"], force=True) or {}
                break
        _check(checks, "leak_incident_phase_mem",
               leak_incident.get("phase") == "mem",
               f"incident {leak_incident}")
        _check(checks, "leak_incident_names_culprit",
               leak_incident.get("culprit_node") == 0,
               f"incident {leak_incident}")

        # -- 3. the post-mortem hbm_oom embeds the forecast verdict -----
        failure = type("F", (), {})()
        failure.node_id = 0
        failure.error_data = (
            "CUDA out of memory. Tried to allocate 2.00 GiB; "
            "signature=hbm_oom"
        )
        diagnosis.report_failure(failure)
        oom_incident: Dict[str, Any] = {}
        for inc in manager.list_incidents():
            if inc["kind"] == "hbm_oom":
                oom_incident = manager.finalize(
                    inc["incident_id"], force=True) or {}
                break
        _check(checks, "postmortem_incident_opened",
               oom_incident.get("kind") == "hbm_oom"
               and oom_incident.get("phase") == "mem",
               f"incident {oom_incident}")
        mem_evidence = oom_incident.get("mem") or {}
        _check(
            checks, "postmortem_embeds_mem_series",
            any(name.startswith("node0.mem.")
                for name in (mem_evidence.get("series") or {})),
            f"mem evidence {sorted(mem_evidence.get('series') or {})}",
        )
        _check(checks, "postmortem_records_forecast_breach",
               mem_evidence.get("forecast_breached") is True,
               f"mem evidence {mem_evidence}")

        # -- 4. fit_report: dp4 fits, dp2 rejected, roomier fleet ok ----
        plan = _dp_stacked_plan(gib)
        fit_dp4 = memscope.fit_report(
            {"mesh_axes": {"dp": 4}}, state_plan=plan,
            limit_b=limit_b, overhead_b=0.0)
        fit_dp2 = memscope.fit_report(
            {"mesh_axes": {"dp": 2}}, state_plan=plan,
            limit_b=limit_b, overhead_b=0.0)
        fit_dp2_roomy = memscope.fit_report(
            {"mesh_axes": {"dp": 2}}, state_plan=plan,
            limit_b=2.0 * limit_b, overhead_b=0.0)
        _check(checks, "fit_accepts_dp4", fit_dp4["fits"],
               json.dumps(fit_dp4))
        _check(
            checks, "fit_rejects_dp2_on_measured_limit",
            not fit_dp2["fits"] and "exceeds budget" in fit_dp2["reason"],
            json.dumps(fit_dp2),
        )
        _check(checks, "fit_accepts_dp2_with_headroom",
               fit_dp2_roomy["fits"], json.dumps(fit_dp2_roomy))
        return {
            "forecast_round": opened_round,
            "oom_round": oom_round,
            "account": {
                "used_b": used,
                "subsystems": account["subsystems"],
                "source": account["chips"][0]["source"]
                if account["chips"] else "",
            },
            "fit": {
                "dp4": fit_dp4["fits"],
                "dp2": fit_dp2["fits"],
                "dp2_roomy": fit_dp2_roomy["fits"],
            },
        }


def _scenario_cache_cold(ctx: Dict) -> Dict:
    """The compile observatory's two-boot contract under a wiped
    persistent cache, end to end.  The port's compile is the kernel
    build (``ops/cuda/_build.py``) and its persistent cache the build
    directory, here a fresh one under ``persistent_cache_override``; a
    "boot" is a fresh compile scope whose watched call site,
    ``drill.step``, builds :data:`DRILL_KERNEL` (nvcc on the card):

    1. **cold boot** — the build runs nvcc (classified ``first-trace``,
       nonzero compile seconds, cache miss) and no incident opens: a
       cold first boot paying its compile is EXPECTED;
    2. **warm restart** — a fresh scope that EXPECTS warmth: the same
       source must come back as a persistent-cache HIT with hit ratio 1
       and fewer compile seconds, and the cache-cold sentinel must stay
       quiet;
    3. **wiped cache** — the cache dir is destroyed between boots: the
       rebuild classifies ``persistent-cache-miss``, pays the injected
       chaos DELAY (deterministic extra compile seconds), and the
       ``CompileSentinel`` opens a ``cache_cold`` incident whose
       finalized verdict embeds the compile events — naming the exact
       FUNCTION and TRIGGER from the flight-dump evidence;
    4. **recompile storm** — a synthetic ``job.compile.s`` trajectory
       (healthy baseline, then sustained 30s/window) breaches the
       EWMA+MAD storm detector and opens ``recompile_storm``.

    The reference's in-process executable caches (``jax.clear_caches``)
    have no counterpart: a build looks at the directory every time.  A
    library this process loaded earlier stays loaded and untouched.  Each
    boot's build seconds are in the result (``boots``)."""
    from dlrover_tpu_torch.diagnosis.diagnostician import DiagnosisManager
    from dlrover_tpu_torch.master.timeseries import TimeSeriesStore
    from dlrover_tpu_torch.observability import jitscope
    from dlrover_tpu_torch.observability.incidents import IncidentManager
    from dlrover_tpu_torch.observability.sentinel import CompileSentinel
    from dlrover_tpu_torch.ops.cuda import _build

    checks = ctx["checks"]
    cache_dir = os.path.join(ctx["workdir"], "kernel_cache")
    os.makedirs(cache_dir, exist_ok=True)
    boots: List[Dict[str, Any]] = []
    with _env(
        DLROVER_TPU_INCIDENT_DIR=os.path.join(ctx["workdir"], "incidents"),
        DLROVER_TPU_INCIDENT_COOLDOWN_S="0",
        DLROVER_TPU_INCIDENT_GRACE_S="0",
        DLROVER_TPU_JITSCOPE="1",
        DLROVER_TPU_CACHE_COLD_RATIO="0.5",
        DLROVER_TPU_SENTINEL_CONSECUTIVE="2",
    ), jitscope.persistent_cache_override(cache_dir):
        jitscope.install()
        store = TimeSeriesStore()
        manager = IncidentManager()
        manager.set_timeseries(store)
        diagnosis = DiagnosisManager()
        diagnosis.register(CompileSentinel(store))
        diagnosis.set_incident_manager(manager)

        def boot(warm: bool):
            # a "boot": a fresh scope; the SAME source (identical hash ->
            # identical library name) resolved once
            sc = jitscope.reset_scope(warm_expected=warm, cache_enabled=True)
            watched = jitscope.watch(
                lambda: _build.build([DRILL_KERNEL]), "drill.step")
            t0 = time.perf_counter()
            watched()
            boots.append({"warm_expected": warm,
                          "build_s": round(time.perf_counter() - t0, 3),
                          "event": watched.last_event})
            store.record_digest(0, sc.digest())
            diagnosis.diagnose_once()
            return sc, watched.last_event

        try:
            # -- 1. cold boot: first trace, real build, no alarm --------
            sc1, ev1 = boot(warm=False)
            _check(
                checks, "cold_boot_first_trace",
                ev1 is not None and ev1["trigger"] == "first-trace"
                and ev1["compile_s"] > 0 and ev1["cache"] == "miss",
                f"event {ev1}",
            )
            _check(checks, "cold_boot_no_incident",
                   not manager.list_incidents(),
                   f"{manager.list_incidents()}")

            # -- 2. warm restart: the cache absorbs the rebuild ---------
            sc2, ev2 = boot(warm=True)
            summary2 = sc2.summary()
            _check(
                checks, "warm_restart_cache_hit",
                ev2 is not None and ev2["cache"] == "hit"
                and summary2["cache_hit_ratio"] == 1.0,
                f"event {ev2} summary {summary2}",
            )
            _check(
                checks, "warm_restart_cheaper_than_cold",
                ev2 is not None and ev1 is not None
                and ev2["compile_s"] < ev1["compile_s"],
                f"warm {ev2 and ev2['compile_s']} vs cold "
                f"{ev1 and ev1['compile_s']}",
            )
            _check(checks, "warm_restart_no_incident",
                   not manager.list_incidents(),
                   f"{manager.list_incidents()}")

            # -- 3. wiped cache: classified miss + cache_cold incident --
            shutil.rmtree(cache_dir)
            os.makedirs(cache_dir, exist_ok=True)
            sc3, ev3 = boot(warm=True)
            _check(
                checks, "wiped_cache_classified_miss",
                ev3 is not None
                and ev3["trigger"] == "persistent-cache-miss"
                and ev3["cache"] == "miss",
                f"event {ev3}",
            )
            _check(
                checks, "chaos_delay_priced_into_compile",
                ev3 is not None and ev3["compile_s"] >= 0.045,
                f"event {ev3}",
            )
            cold = [inc for inc in manager.list_incidents()
                    if inc["kind"] == "cache_cold"]
            _check(checks, "cache_cold_incident_opened", bool(cold),
                   f"{manager.list_incidents()}")
            verdict: Dict[str, Any] = {}
            if cold:
                verdict = manager.finalize(
                    cold[0]["incident_id"], force=True) or {}
            _check(checks, "cache_cold_phase_compile",
                   verdict.get("phase") == "compile", f"{verdict}")
            _check(checks, "cache_cold_names_culprit",
                   verdict.get("culprit_node") == 0, f"{verdict}")
            last_miss = (verdict.get("compile") or {}).get(
                "last_miss") or {}
            _check(
                checks, "cache_cold_names_function_and_trigger",
                last_miss.get("fn") == "drill.step"
                and last_miss.get("trigger") == "persistent-cache-miss",
                f"compile evidence {verdict.get('compile')}",
            )

            # -- 4. synthetic recompile storm breaches the detector -----
            storm_store = TimeSeriesStore()
            storm_diag = DiagnosisManager()
            storm_diag.register(CompileSentinel(storm_store))
            storm_diag.set_incident_manager(manager)
            base_ts = time.time() - 400
            for i in range(14):
                value = 0.2 if i < 10 else 30.0
                storm_store.add("job.compile.s", value, base_ts + i * 10)
            storm_diag.diagnose_once()
            storm = [inc for inc in manager.list_incidents()
                     if inc["kind"] == "recompile_storm"]
            _check(checks, "recompile_storm_incident_opened",
                   bool(storm), f"{manager.list_incidents()}")
            return {
                "cold_compile_s": ev1 and ev1["compile_s"],
                "warm_compile_s": ev2 and ev2["compile_s"],
                "wiped_compile_s": ev3 and ev3["compile_s"],
                "boots": boots,
                "verdict": {
                    "kind": verdict.get("kind"),
                    "phase": verdict.get("phase"),
                    "detail": verdict.get("detail"),
                    "last_miss": last_miss,
                },
            }
        finally:
            jitscope.reset_scope()


class _LaggedStorage:
    """A storage model pricing each round trip at an object-store RTT
    (the round trips the peer rung never makes), slept on the drill's
    clock."""

    RTT_S = 0.04

    def __init__(self, inner, clock):
        self._inner = inner
        self._clock = clock

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name in ("read", "read_binary", "read_range", "exists"):
            def lagged(*a, **kw):
                self._clock.sleep(self.RTT_S)
                return attr(*a, **kw)
            return lagged
        return attr


def _builds_without_nvcc(cache_dir: str, sources) -> bool:
    """Every source resolves from ``cache_dir`` as a hit: no nvcc run."""
    from dlrover_tpu_torch.observability import jitscope
    from dlrover_tpu_torch.ops.cuda import _build

    resolved: List[bool] = []

    def listener(name, cached, seconds):
        resolved.append(cached)

    _build.add_listener(listener)
    try:
        with jitscope.persistent_cache_override(cache_dir):
            _build.build(list(sources))
    finally:
        _build.remove_listener(listener)
    return len(resolved) == len(sources) and all(resolved)


def _scenario_peer_restore(ctx: Dict) -> Dict:
    """Checkpoint-free fast recovery: node kill at dp>=4, the
    replacement pulls the lost shards straight from surviving peers.

    1. **peer rung under chaos** — three survivors hold the committed
       step in shm and serve it, and their compile cache: the kernel
       library of :data:`DRILL_KERNEL` they built (``survivor_cache``,
       else one this drill builds).  The replacement's recovery pulls
       every shard over the peer endpoints while the armed plan tears one
       payload (the restorer must retry that read once against the same
       donor — and succeed, with no demotion) and delays serves.
       Asserts: bit-exact segment vs a donor, ZERO storage reads, the
       compile cache prewarmed (every survivor entry pulled byte-equal,
       and the kernel then resolves from it with no nvcc run), the
       ``peer_restore`` ledger phase priced, and the recovery report
       landing in the master broker and time-series store.
    2. **manifest rung, measured** — the same recovery with every peer
       gone falls to sealed-manifest ranged reads against a storage
       model that prices each round trip at an object-store RTT: still
       bit-exact, and the peer path must beat it on MTTR.
    3. **MTTR budget sentinel** — under the generous drill budget the
       sentinel stays quiet; a recovery against a tiny budget blows it
       and the sentinel opens a classified ``mttr_budget`` incident
       naming the recovery phase.

    MTTRs are timed on the drill's clock (``clock``)."""
    from dlrover_tpu_torch.common.multi_process import SharedMemoryBuffer
    from dlrover_tpu_torch.common.storage import get_checkpoint_storage
    from dlrover_tpu_torch.diagnosis.diagnostician import DiagnosisManager
    from dlrover_tpu_torch.observability import goodput, jitscope
    from dlrover_tpu_torch.observability.incidents import IncidentManager
    from dlrover_tpu_torch.observability.sentinel import MttrSentinel
    from dlrover_tpu_torch.ops.cuda import _build
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        distributed,
        peer_restore,
        snapshot,
    )
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import shm_name

    checks, device, clock = ctx["checks"], ctx["device"], ctx["clock"]
    workdir = ctx["workdir"]
    scope = _scope()
    step, nprocs, dead = 9, 4, 1
    survivors = [0, 2, 3]
    extras = {"drill": "peer_restore"}

    handle = _MasterHandle()
    client = _RestartableLocalClient(handle, node_id=dead)
    state = _make_state(step, device)
    leaves = snapshot.plan_shards({k: v.cpu() for k, v in state.items()})

    # the sealed manifest the ladder's second rung reads (same extras as
    # the shm snapshots so every rung recommits an identical segment)
    ckpt_dir = os.path.join(workdir, "ckpt")
    dist_engine = distributed.DistributedCheckpointEngine(
        ckpt_dir, process_id=0, num_processes=1,
        client=distributed.LocalCommitClient(),
    )
    save_stats = dist_engine.save(
        step, state, extras=extras, wait_seal=True, timeout=30)
    _check(checks, "manifest_sealed", bool(save_stats.get("sealed")),
           str(save_stats))

    # survivors: committed shm snapshots + serve endpoints + the kernel
    # libraries the job already built
    cache_src = ctx.get("survivor_cache") or ""
    if not cache_src:
        cache_src = os.path.join(workdir, "cache_survivor")
        with jitscope.persistent_cache_override(cache_src):
            _build.build([DRILL_KERNEL])
    cache_blobs: Dict[str, bytes] = {}
    for name in sorted(os.listdir(cache_src)):
        full = os.path.join(cache_src, name)
        if os.path.isfile(full) and not name.endswith(".tmp"):
            with open(full, "rb") as f:
                cache_blobs[name] = f.read()
    shms: Dict[int, Any] = {}
    endpoints: Dict[int, Any] = {}
    try:
        announced = True
        for pid in survivors:
            shm = SharedMemoryBuffer(shm_name(pid, scope))
            snapshot.write_snapshot(shm, step, leaves, extras)
            shms[pid] = shm
            endpoint = peer_restore.PeerServeEndpoint(
                pid, scope=scope, cache_dir=cache_src).start()
            endpoints[pid] = endpoint
            announced = announced and client.report_peer_announce(
                scope, step, endpoint.addr,
                num_processes=nprocs, process_id=pid,
            )
        _check(checks, "survivors_announced", announced)
        donor_meta_bytes = snapshot.read_meta_bytes(shms[0])
        donor_meta = snapshot.read_snapshot_meta(shms[0])
        payload_nbytes = int(donor_meta["payload_bytes"])

        with _env(
            DLROVER_TPU_GOODPUT_RES_S="0.005",
            DLROVER_TPU_PEER_CACHE_PREWARM="1",
            DLROVER_TPU_MTTR_BUDGET_S="30",
            DLROVER_TPU_INCIDENT_DIR=os.path.join(workdir, "incidents"),
            DLROVER_TPU_INCIDENT_COOLDOWN_S="0",
            DLROVER_TPU_INCIDENT_GRACE_S="0",
        ):
            goodput.reset_ledger()

            # -- 1. the node kill: the broker names the replica-group
            #    donors and the replacement pulls the step from them ---
            assignment = client.get_peer_assignment(
                scope, step=-1, group=survivors, process_id=dead)
            _check(
                checks, "broker_names_replica_donors",
                assignment.step == step
                and len(assignment.donors or {}) == len(survivors),
                f"step={assignment.step} donors={assignment.donors}",
            )
            shm_new = SharedMemoryBuffer(shm_name(dead, scope))
            shms[dead] = shm_new
            cache_dst = os.path.join(workdir, "cache_replacement")
            os.makedirs(cache_dst, exist_ok=True)
            report = peer_restore.recover(
                scope=scope, process_id=dead, num_processes=nprocs,
                shm=shm_new, checkpoint_dir=ckpt_dir,
                assignment={"step": int(assignment.step),
                            "donors": dict(assignment.donors)},
                cache_dir=cache_dst, client=client, clock=clock.now,
            )
            _check(
                checks, "peer_rung_zero_storage_reads",
                report["filled"] and report["rung"] == "peer_shm"
                and report["storage_reads"] == 0
                and report["bytes_manifest"] == 0,
                str(report),
            )
            _check(
                checks, "torn_payload_retried_not_demoted",
                report["torn_retries"] >= 1
                and not report["demoted_peers"],
                str(report),
            )
            _check(
                checks, "peer_rung_bit_exact",
                snapshot.read_meta_bytes(shm_new) == donor_meta_bytes
                and snapshot.read_payload_range(shm_new, 0, payload_nbytes)
                == snapshot.read_payload_range(shms[0], 0, payload_nbytes),
            )
            meta_new = snapshot.read_snapshot_meta(shm_new)
            restored = {
                leaf["path"]: snapshot.read_shard_bytes(
                    shm_new, meta_new, leaf["shards"][0], leaf["dtype"]
                ).reshape(leaf["gshape"])
                for leaf in meta_new["leaves"]
            }
            _check(checks, "peer_rung_state_equal",
                   _state_equal(restored, state))
            prewarmed_ok = report["cache_prewarmed"] == len(cache_blobs)
            for name, blob in cache_blobs.items():
                path = os.path.join(cache_dst, name)
                prewarmed_ok = prewarmed_ok and os.path.exists(path)
                if prewarmed_ok:
                    with open(path, "rb") as f:
                        prewarmed_ok = f.read() == blob
            no_nvcc = prewarmed_ok and _builds_without_nvcc(
                cache_dst, [DRILL_KERNEL])
            _check(checks, "cache_prewarmed_zero_cold_compiles",
                   prewarmed_ok and no_nvcc, str(report))
            recorded = handle.servicer.peer_broker.recoveries()
            _check(
                checks, "recovery_report_brokered",
                bool(recorded) and recorded[-1]["rung"] == "peer_shm"
                and recorded[-1]["process_id"] == dead,
                str(recorded[-1:]),
            )
            phases = goodput.ledger().summary()["phases"]
            _check(checks, "recovery_priced_in_ledger",
                   phases.get("peer_restore", 0.0) > 0.0, str(phases))

            # -- 2. every peer gone: the ladder falls to the manifest
            #    rung.  Each storage round trip pays a modeled object-
            #    store RTT — the trips the peer rung never makes. ------
            plan = [
                dict(leaf, shards=[dict(s) for s in leaf["shards"]])
                for leaf in donor_meta["leaves"]
            ]
            shm_manifest = SharedMemoryBuffer(shm_name(7, scope))
            shms[7] = shm_manifest
            report_manifest = peer_restore.recover(
                scope=scope, process_id=7, num_processes=nprocs,
                shm=shm_manifest, checkpoint_dir=ckpt_dir,
                assignment={"step": step, "donors": {}}, plan=plan,
                storage=_LaggedStorage(
                    get_checkpoint_storage(path=ckpt_dir), clock),
                client=client, clock=clock.now,
            )
            _check(
                checks, "manifest_rung_bit_exact",
                report_manifest["filled"]
                and report_manifest["rung"] == "manifest"
                and report_manifest["storage_reads"] > 0
                and snapshot.read_payload_range(
                    shm_manifest, 0, payload_nbytes)
                == snapshot.read_payload_range(shms[0], 0, payload_nbytes),
                str(report_manifest),
            )
            _check(
                checks, "peer_beats_manifest_restore",
                report["mttr_s"] < report_manifest["mttr_s"],
                f"peer={report['mttr_s']:.3f}s "
                f"manifest={report_manifest['mttr_s']:.3f}s",
            )

            # -- 3. the MTTR budget sentinel: quiet under the drill
            #    budget, an incident once a recovery blows a tiny one --
            store = handle.servicer.timeseries
            manager = IncidentManager()
            manager.set_timeseries(store)
            diagnosis = DiagnosisManager()
            diagnosis.register(MttrSentinel(store))
            diagnosis.set_incident_manager(manager)
            diagnosis.diagnose_once()
            _check(checks, "mttr_sentinel_quiet_under_budget",
                   not manager.list_incidents(),
                   str(manager.list_incidents()))
            shm_slow = SharedMemoryBuffer(shm_name(8, scope))
            shms[8] = shm_slow
            report_slow = peer_restore.recover(
                scope=scope, process_id=8, num_processes=nprocs,
                shm=shm_slow, checkpoint_dir=ckpt_dir,
                assignment={"step": int(assignment.step),
                            "donors": dict(assignment.donors)},
                client=client, budget_s=0.005, clock=clock.now,
            )
            _check(checks, "chaos_delay_blows_tiny_budget",
                   report_slow["over_budget"], str(report_slow))
            diagnosis.diagnose_once()
            fired = [inc for inc in manager.list_incidents()
                     if inc["kind"] == "mttr_budget"]
            _check(checks, "mttr_sentinel_fires_over_budget",
                   bool(fired), str(manager.list_incidents()))
            verdict: Dict[str, Any] = {}
            if fired:
                verdict = manager.finalize(
                    fired[0]["incident_id"], force=True) or {}
            _check(checks, "mttr_incident_phase_recovery",
                   verdict.get("phase") == "recovery", str(verdict))
        return {
            "recovery_mttr_s": report["mttr_s"],
            "peer_read_gbps": report["peer_read_gbps"],
            "manifest_mttr_s": report_manifest["mttr_s"],
            "bytes_peer": report["bytes_peer"],
            "torn_retries": report["torn_retries"],
            "cache_prewarmed": report["cache_prewarmed"],
            "phases": phases,
        }
    finally:
        for endpoint in endpoints.values():
            endpoint.stop()
        for shm in shms.values():
            with contextlib.suppress(Exception):
                shm.unlink()  # closes this process's mapping first


def _scenario_data_starved(ctx: Dict) -> Dict:
    """Every shard lease pays an injected ``data.lease`` DELAY at the
    master.  The real ShardingClient must still consume every shard
    exactly once, the blocked waits must book to the ledger's
    ``input_starved`` phase (dominating this scenario's account), and
    the master-side datascope telemetry must show the stall in the
    lease p99."""
    from dlrover_tpu_torch.agent.sharding import ShardingClient
    from dlrover_tpu_torch.observability import datascope, goodput

    checks = ctx["checks"]
    master = _MasterHandle()
    client = _RestartableLocalClient(master, node_id=0)
    # 6 shards of 8 records each; every lease pays the injected 0.4s
    dataset = "drill_data"
    sharding = ShardingClient(
        dataset_name=dataset, batch_size=4, num_epochs=1,
        dataset_size=48, client=client,
        num_minibatches_per_shard=2,
    )
    fetched = []
    while True:
        shard = sharding.fetch_shard()
        if shard is None:
            break
        fetched.append((shard.name, shard.start, shard.end))
        sharding.report_shard_done()
    _check(checks, "all_shards_consumed", len(fetched) == 6,
           f"fetched {len(fetched)}: {fetched}")
    _check(checks, "no_shard_repeated",
           len(set(fetched)) == len(fetched), str(fetched))
    delays = [r for r in chaos.trace() if r["kind"] == chaos.DELAY]
    _check(checks, "stalls_injected", len(delays) >= 1,
           f"trace {chaos.trace()}")
    # agent side: the wait-vs-service split saw the starvation
    scope = datascope.scope_summary()
    _check(checks, "fetches_recorded",
           scope.get("fetches", 0) >= 6, str(scope))
    _check(checks, "starved_fetches_attributed",
           scope.get("starved_fetches", 0) >= 1, str(scope))
    # ledger: the blocked waits dominate this scenario's account
    ledger = goodput.ledger().summary()
    _check(
        checks, "ledger_dominant_input_starved",
        ledger["dominant"] == "input_starved"
        and ledger["phases"]["input_starved"] > 0,
        f"ledger {ledger}",
    )
    # master side: telemetry priced the stall and drained the backlog
    telemetry = master.servicer.shard_telemetry
    telemetry.flush()
    summary = telemetry.summary()
    _check(checks, "telemetry_counts_completions",
           summary["completions"] == 6, str(summary))
    _check(checks, "telemetry_backlog_drained",
           summary["backlog"] == 0, str(summary))
    _check(checks, "lease_p99_shows_stall",
           summary["lease_p99_ms"] >= 300.0, str(summary))
    return {
        "ledger_phases": ledger["phases"],
        "lease_p99_ms": summary["lease_p99_ms"],
        "starved_s": round(scope.get("starved_s", 0.0), 3),
    }


_SCENARIO_BODIES: Dict[str, Callable[[Dict], Dict]] = {
    "master_restart": _scenario_master_restart,
    "torn_shm": _scenario_torn_shm,
    "storage_stall": _scenario_storage_stall,
    "storage_crc": _scenario_storage_crc,
    "node_flap": _scenario_node_flap,
    "live_reshard": _scenario_live_reshard,
    "kv_timeout": _scenario_kv_timeout,
    "heartbeat_loss": _scenario_heartbeat_loss,
    "torn_commit": _scenario_torn_commit,
    "slow_link": _scenario_slow_link,
    "hbm_leak": _scenario_hbm_leak,
    "cache_cold": _scenario_cache_cold,
    "peer_restore": _scenario_peer_restore,
    "data_starved": _scenario_data_starved,
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


def run_scenario(name: str, seed: int = 0, device: DeviceLike = None,
                 clock: Any = None,
                 survivor_cache: str = "") -> Dict[str, Any]:
    """Run one scenario; returns the result dict (``ok``, ``checks``,
    ``trace``, timing).  ``device``: where the states live (the card by
    default).  ``clock`` (``now()`` seconds, ``sleep(s)``; default
    :class:`WallClock`) times ``slow_link``'s probe and
    ``peer_restore``'s MTTRs.  ``survivor_cache``: a kernel build
    directory ``peer_restore``'s survivors serve (default: one it builds).
    A scenario of :data:`WAITING` raises ``NotImplementedError``; an
    unknown name ``KeyError``."""
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
    options: Dict[str, Any] = {}
    if clock is not None:
        options["clock"] = clock
    if survivor_cache:
        options["survivor_cache"] = survivor_cache
    return _run_with_plan(name, seed, body, resolve_device(device), options)


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


#: a scenario's measured numbers that the CLI's line carries
_MEASURED = ("restart_s", "live_reshard_s", "reshard_speedup_vs_restart")


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
            # the incident's (phase, chaos point), and what a scenario
            # measured (live_reshard: both paths' seconds)
            "incident": [(r.get("incident") or {}).get("phase"),
                         ((r.get("incident") or {}).get("chaos") or {}).get(
                             "point")],
            **{k: r[k] for k in _MEASURED if k in r},
            **({"error": r["error"]} if "error" in r else {}),
        }
        for name, r in result["scenarios"].items()
    }
    print("CHAOS_DRILL " + json.dumps(slim), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
