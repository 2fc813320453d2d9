"""Flash-Checkpoint measurement on the port's ``Trainer``.

Port of the measurement in ``run()`` of
``dlrover_tpu/trainer/flash_checkpoint/bench.py``: steps without a save,
the headline blocking time of an async storage save, the steps trained
while the snapshot stages behind them, the time until the step is
persisted, and the restores from shm and from storage.  ``chip_smoke.py``
calls ``run`` on its ``llama2_1b`` trainer.  ``peer_recovery_bench`` is the
reference's measurement of the peer restore (four local hosts, one dead).
``recovery_drill`` is the reference's worker-kill drill through the port's
launcher (``trainer/elastic_run.py``).  The reference's reshard and staging
drills belong to ROADMAP queue 1 items 6c and 11 (the rest); they are not
ported here.

Every time is a host clock around work that ends in a device synchronize
(``utils/timing.hard_block``), so it includes the card's queued work.
"""

import contextlib
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.common.pytree import flatten_with_path
from dlrover_tpu_torch.trainer.flash_checkpoint import snapshot
from dlrover_tpu_torch.trainer.flash_checkpoint.checkpointer import (
    Checkpointer,
    StorageType,
)
from dlrover_tpu_torch.utils.timing import hard_block

# the step labels of the warm-up memory save and the measured storage save
WARMUP_STEP, SAVE_STEP = 0, 1

# the directory that holds the port's package: the launched processes'
# PYTHONPATH root and working directory
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _timed_step(trainer, state, batch) -> Tuple[Any, float, float]:
    t0 = time.perf_counter()
    state, metrics = trainer.train_step(state, batch)
    loss = metrics["loss"].item()
    hard_block(state)
    return state, time.perf_counter() - t0, loss


def state_nbytes(state: Any) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for _, leaf in flatten_with_path(state)
               if isinstance(leaf, torch.Tensor))


def run(trainer, state, batch, ckpt_dir: str, scope: str, steps: int = 4,
        on_snapshot: Optional[Callable[[Any], None]] = None,
        verify: Optional[Callable[[str, Any, float], None]] = None,
        persist_timeout_s: float = 1200.0) -> Tuple[Any, Dict]:
    """The reference's sequence, on ``trainer`` and its ``state``:

    1. ``steps`` steps without a save (the step time, and the stage
       pacer's calm baseline);
    2. an async memory save (warm-up: the device copy's buffer and the
       shm segment), flushed;
    3. an async storage save at step label ``SAVE_STEP``:
       ``blocking_save_s``; ``on_snapshot(state)`` runs right after it
       (before any step, e.g. to take a reference copy);
    4. ``steps`` steps while the snapshot stages and persists, then the
       exit barrier: ``persist_total_s`` from the save's start
       (``staging_s``: until the snapshot was in shm);
    5. a restore from shm into the trainer's own state (which the steps
       moved on): ``restore_shm_s``; the engine's host-side cost alone
       (shm to host tensors): ``restore_shm_host_s``;
    6. one step, then a restore from storage by a fresh scope (no shm
       snapshot), in place again: ``restore_storage_s``.

    ``verify(source, state, first_loss)`` runs after each restore
    (``source`` "shm" or "storage"; ``first_loss`` the loss of the first
    step trained from the snapshot in 4).  Returns the state and the
    numbers; raises when a save, persist or restore fails."""
    device = trainer.device
    base = []
    for _ in range(steps):
        state, dt, _ = _timed_step(trainer, state, batch)
        base.append(dt)
    base_step_s = sorted(base)[len(base) // 2]
    ckpt = Checkpointer(ckpt_dir, scope=scope, device=device)
    ckpt2 = None
    try:
        ckpt.save_checkpoint(WARMUP_STEP, state, StorageType.MEMORY)
        if not ckpt.engine._flush_async():
            raise RuntimeError("the warm-up snapshot did not stage")
        t0 = time.time()
        blocked = ckpt.save_checkpoint(SAVE_STEP, state, StorageType.DISK)
        if on_snapshot is not None:
            on_snapshot(state)
        overlap, first_loss = [], None
        for _ in range(steps):
            state, dt, loss = _timed_step(trainer, state, batch)
            overlap.append(dt)
            first_loss = loss if first_loss is None else first_loss
        if not ckpt.wait_latest_checkpoint(timeout=persist_timeout_s):
            raise RuntimeError(f"step {SAVE_STEP} was not persisted")
        persist_total_s = time.time() - t0
        staging_s = ckpt.engine.last_staged_at - t0
        paths = list(ckpt.engine.save_paths)
        overlap_step_s = sorted(overlap)[len(overlap) // 2]

        t0 = time.time()
        restored, step = ckpt.load_checkpoint(state, trainer=trainer)
        hard_block(restored)
        restore_shm_s = time.time() - t0
        if step != SAVE_STEP:
            raise RuntimeError(f"shm restore returned step {step}")
        state = restored
        if verify is not None:
            verify("shm", state, first_loss)
        # the engine's own cost: shm to host tensors, no device transfer
        t0 = time.time()
        maps, _, _ = ckpt.engine._index_maps_from_shm()
        for index_map in maps.values():
            index_map.whole().clone()
        del maps
        restore_shm_host_s = time.time() - t0

        state, _, _ = _timed_step(trainer, state, batch)
        ckpt2 = Checkpointer(ckpt_dir, scope=f"{scope}r", device=device)
        t0 = time.time()
        restored, step = ckpt2.load_checkpoint(state, trainer=trainer)
        hard_block(restored)
        restore_storage_s = time.time() - t0
        if step != SAVE_STEP:
            raise RuntimeError(f"storage restore returned step {step}")
        state = restored
        if verify is not None:
            verify("storage", state, first_loss)
    finally:
        for c in (ckpt, ckpt2):
            if c is not None:
                c.engine.unlink_memory()
                c.close()
    detail = {
        "blocking_save_s": blocked,
        "save_paths": paths,
        "staging_s": staging_s,
        "persist_total_s": persist_total_s,
        "state_gb": state_nbytes(state) / 1e9,
        "step_s_no_save": base_step_s,
        "steps_no_save": base,
        "step_s_during_staging": overlap_step_s,
        "steps_during_staging": overlap,
        "staging_inflation_x": overlap_step_s / max(base_step_s, 1e-9),
        "restore_shm_s": restore_shm_s,
        "restore_shm_host_s": restore_shm_host_s,
        "restore_storage_s": restore_storage_s,
    }
    return state, detail


def sync_save_s(state, ckpt_dir: str, scope: str, step: int, device,
                repeats: int = 2) -> Tuple[list, list, list]:
    """Blocking memory saves (``async_snapshot=False``) into a scope of
    their own: the seconds of each (the first lands in a fresh segment
    and fresh pinned memory), the seconds of its two phases (device to
    pinned host memory, host memory to shm) and the path each took.  The
    segment is released before this returns."""
    ckpt = Checkpointer(ckpt_dir, scope=scope, async_snapshot=False,
                        device=device)
    try:
        times, phases = [], []
        for _ in range(repeats):
            times.append(ckpt.save_checkpoint(step, state,
                                              StorageType.MEMORY))
            phases.append(dict(ckpt.engine.last_sync_phases))
        meta = snapshot.read_snapshot_meta(ckpt.engine._shm)
        if meta is None or meta["step"] != step or min(times) < 0:
            raise RuntimeError(f"sync save of step {step} did not land")
        return times, phases, list(ckpt.engine.save_paths)
    finally:
        ckpt.engine.unlink_memory()
        ckpt.close()


def peer_recovery_bench(size_mb: float = 8.0) -> dict:
    """The peer restore, measured as the reference's bench measures it
    (``dlrover_tpu/trainer/flash_checkpoint/bench.py:167-270``): four local
    "hosts" (shm segments and serve endpoints) hold committed step 11, host
    1 dies, and its replacement pulls every byte back from its peers:
    ``recovery_mttr_s`` is the wall clock of the whole ladder and
    ``peer_read_gbps`` the shm-to-shm rate.  A second recovery of the same
    step with no donor reads the sealed manifest instead
    (``manifest_restore_s``, ``manifest_bytes``).  In one process over a
    ``LocalPeerClient``; the peer plane is HTTP over loopback.  Writes no
    file outside a temporary directory it removes."""
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        distributed,
        peer_restore,
    )
    from dlrover_tpu_torch.common.multi_process import SharedMemoryBuffer
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import shm_name

    workdir = tempfile.mkdtemp(prefix="peer_rec_bench_")
    scope = f"peerbench{uuid.uuid4().hex[:8]}"
    nprocs, dead, step = 4, 1, 11
    survivors = [p for p in range(nprocs) if p != dead]
    rng = np.random.default_rng(24)
    n = max(1, int(size_mb * (1 << 20) / 4))
    state = {
        "w": torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
        "step": torch.tensor(step, dtype=torch.int32),
    }
    shms, endpoints = {}, {}
    try:
        client = peer_restore.LocalPeerClient(process_id=dead)
        leaves = snapshot.plan_shards(state)
        for pid in survivors:
            shm = SharedMemoryBuffer(shm_name(pid, scope))
            snapshot.write_snapshot(shm, step, leaves, {})
            shms[pid] = shm
            endpoint = peer_restore.PeerServeEndpoint(pid, scope=scope)
            endpoints[pid] = endpoint.start()
            client.report_peer_announce(scope, step, endpoint.addr,
                                        num_processes=nprocs, process_id=pid)
        ckpt_dir = os.path.join(workdir, "ckpt")
        distributed.DistributedCheckpointEngine(
            ckpt_dir, process_id=0, num_processes=1,
            client=distributed.LocalCommitClient(),
        ).save(step, state, wait_seal=True, timeout=60)
        donor_meta = snapshot.read_snapshot_meta(shms[0])
        payload_nbytes = int(donor_meta["payload_bytes"])

        assignment = client.get_peer_assignment(
            scope, step=-1, group=survivors, process_id=dead)
        shm_new = SharedMemoryBuffer(shm_name(dead, scope))
        shms[dead] = shm_new
        report = peer_restore.recover(
            scope=scope, process_id=dead, num_processes=nprocs,
            shm=shm_new, checkpoint_dir=ckpt_dir,
            assignment={"step": int(assignment.step),
                        "donors": dict(assignment.donors)},
            client=client)
        plan = [dict(leaf, shards=[dict(s) for s in leaf["shards"]])
                for leaf in donor_meta["leaves"]]
        shm_manifest = SharedMemoryBuffer(shm_name(7, scope))
        shms[7] = shm_manifest
        report_manifest = peer_restore.recover(
            scope=scope, process_id=7, num_processes=nprocs,
            shm=shm_manifest, checkpoint_dir=ckpt_dir,
            assignment={"step": step, "donors": {}}, plan=plan,
            client=client)
        bit_exact = (
            snapshot.read_payload_range(shm_new, 0, payload_nbytes)
            == snapshot.read_payload_range(shms[0], 0, payload_nbytes)
            == snapshot.read_payload_range(shm_manifest, 0, payload_nbytes)
        )
        return {
            "recovery_mttr_s": report["mttr_s"],
            "peer_read_gbps": report["peer_read_gbps"],
            "bytes_peer": report["bytes_peer"],
            "rung": report["rung"],
            "storage_reads": report["storage_reads"],
            "manifest_restore_s": report_manifest["mttr_s"],
            "manifest_bytes": report_manifest["bytes_manifest"],
            "state_mb": round(size_mb, 2),
            "hosts": nprocs,
            "bit_exact": bool(bit_exact),
            "recoveries_recorded": len(client.recoveries()),
        }
    finally:
        for endpoint in endpoints.values():
            endpoint.stop()
        for shm in shms.values():
            with contextlib.suppress(Exception):
                shm.unlink()
        shutil.rmtree(workdir, ignore_errors=True)


def _subprocess_env() -> Dict[str, str]:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("DLROVER_TPU_MASTER_ADDR", None)
    return env


def recovery_drill(timeout: float = 420.0, platform: str = "cpu",
                   preset: str = "tiny",
                   extra_env: Optional[Dict[str, str]] = None,
                   log_path: str = "") -> dict:
    """Worker-kill recovery drill: the launcher spawns a master, an agent
    and a worker (``examples/train_llama_ckpt.py`` at ``preset``); the
    worker hard-crashes at step 7 of 10, the agent restarts it, and it
    resumes from the shm snapshot.  Measures crash -> first completed
    post-restore step (detection, respawn, rendezvous, restore and the
    step: everything a real recovery pays).

    The reference's drill, with what differs: ``platform=""`` runs the
    worker on the card (``"cpu"``, the default, on the CPU); the port
    compiles no step, so there is no compile cache to point the worker
    at; ``preset``, ``extra_env`` (more of the launcher's environment,
    e.g. ``DLROVER_TPU_MASTER_SERVICE_TYPE``) and ``log_path`` (where the
    launcher's combined output is written) are the port's.  The
    launcher's process group is killed when ``timeout`` runs out.
    Returns ``recovery_s`` and ``recovery_resumed_step``, or
    ``recovery_error``."""
    ckpt_dir = tempfile.mkdtemp(prefix="dlrover_tpu_recdrill_")
    env = _subprocess_env()
    env.update(
        {
            "DLROVER_TPU_CRASH_AT_STEP": "7",
            "DLROVER_TPU_TOTAL_STEPS": "10",
            "DLROVER_TPU_JOB_NAME": f"rec{uuid.uuid4().hex[:8]}",
        }
    )
    env.update(extra_env or {})
    cmd = [
        sys.executable, "-m", "dlrover_tpu_torch.trainer.elastic_run",
        "--standalone", "--nproc_per_node=1",
        *([f"--platform={platform}"] if platform else []),
        "--max-restarts=2",
        "-m", "dlrover_tpu_torch.examples.train_llama_ckpt",
        ckpt_dir, preset,
    ]
    try:
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=REPO, start_new_session=True,
        )
        try:
            stdout, stderr = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired as e:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            return {"recovery_error": str(e)[:300]}
        combined = stdout + stderr
        if log_path:
            with open(log_path, "w") as f:
                f.write(combined)
        crash_ts = resume_ts = None
        resumed_step = None
        for line in combined.splitlines():
            line = line.strip()
            if line.startswith("crash_ts="):
                crash_ts = float(line.split("=", 1)[1])
            elif line.startswith("resume_ts="):
                parts = line.split()
                resume_ts = float(parts[0].split("=", 1)[1])
                resumed_step = int(parts[1].split("=", 1)[1])
        if proc.returncode != 0 or crash_ts is None or resume_ts is None:
            return {
                "recovery_error": (
                    f"rc={proc.returncode}: " + combined[-400:]
                )
            }
        return {
            "recovery_s": round(resume_ts - crash_ts, 2),
            "recovery_resumed_step": resumed_step,
        }
    except OSError as e:
        return {"recovery_error": str(e)[:300]}
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
