"""Multi-controller drill: a job of several processes loses one mid-training
and resumes on fewer.

Port of ``dlrover_tpu/trainer/flash_checkpoint/multi_controller_drill.py``.
The reference runs 2 ``jax.distributed`` processes of 4 devices each, a
Llama on ``fsdp=2 x tp=2 x cp=2``, kills one process after a checkpoint and
restores the two processes' shard sets into one process of 8 devices on
another mesh (``2x4 -> 1x8``).  The port has one device per process, so its
form is ``2x1 -> 1x1``: 2 processes, a ``torch.distributed`` gloo world
over ``tcp://127.0.0.1``, the tiny Llama on ``fsdp=2`` (each rank holds
half of every parameter and of its moments); each rank saves its shards
synchronously at ``SAVE_STEP`` and keeps training until the orchestrator
SIGKILLs rank 1 and reaps the survivor (blocked in a collective with its
lost peer); one process without a mesh then restores both ranks' shard
sets from storage (the engine reshards), and the evaluation loss of the
restored state on the whole batch must be within 1e-4 (relative, as the
reference's) of the one the ranks measured after the save.

Every process is a subprocess of ``run_multi_controller_drill`` (``python
-m dlrover_tpu_torch.trainer.flash_checkpoint.multi_controller_drill``), on
the card unless the caller passes ``device="cpu"``.
"""

import datetime
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Dict, List, Optional

SAVE_STEP = 2
B, S = 8, 64
_MODULE = "dlrover_tpu_torch.trainer.flash_checkpoint.multi_controller_drill"


def _batch() -> Dict:
    import numpy as np

    ids = np.random.default_rng(0).integers(0, 256, size=(B, S + 1))
    return {"input_ids": ids[:, :-1].astype(np.int32),
            "labels": ids[:, 1:].astype(np.int32)}


def _trainer(device, mesh=None):
    from dlrover_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from dlrover_tpu_torch.trainer.optim import create_optimizer
    from dlrover_tpu_torch.trainer.train import Trainer

    model = LlamaForCausalLM(LlamaConfig.tiny(num_kv_heads=4),
                             device=device, seed=0)
    return Trainer(model, create_optimizer(peak_lr=1e-2, warmup_steps=1,
                                           total_steps=100),
                   mesh=mesh, device=device)


def _eval_loss(trainer, batch) -> "torch.Tensor":
    """The loss of the trainer's model on ``batch`` (no gradient)."""
    import torch

    from dlrover_tpu_torch.trainer.train import lm_loss

    ids = torch.as_tensor(batch["input_ids"], device=trainer.device)
    labels = torch.as_tensor(batch["labels"], device=trainer.device)
    with torch.no_grad():
        return lm_loss(trainer.model, trainer.model(ids), {"labels": labels})


def _device(name: str):
    import torch

    from dlrover_tpu_torch.device import resolve_device

    dev = resolve_device(name)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _worker_train(rank: int, nprocs: int, port: int, ckpt_dir: str,
                  tag: str, device: str) -> int:
    """Train the tiny Llama on fsdp=nprocs; save every rank's shards at
    SAVE_STEP; keep training until killed."""
    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        Checkpointer,
        StorageType,
    )

    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=nprocs, timeout=datetime.timedelta(seconds=60))
    dev = _device(device)
    mesh = build_mesh(MeshConfig(dp=1, fsdp=nprocs), device=dev.type)
    trainer = _trainer(dev, mesh)
    local = trainer.rows_of_global_batch(_batch())
    state = trainer.create_state()
    ckpt = Checkpointer(ckpt_dir, scope=f"mc{tag}", async_snapshot=False,
                        device=dev)
    step = 0
    while True:  # until killed: the orchestrator owns this process's death
        step += 1
        state, metrics = trainer.train_step(state, trainer.shard_batch(local))
        print(f"TRAIN rank={rank} step={step} "
              f"loss={metrics['loss'].item():.6f}", flush=True)
        if step == SAVE_STEP:
            blocked = ckpt.save_checkpoint(step, state, StorageType.DISK,
                                           trainer=trainer)
            assert ckpt.wait_latest_checkpoint(timeout=120)
            # process 0 commits once every rank's part is on disk
            dist.barrier()
            # the continuity probe: the post-save state's loss on the whole
            # batch, the mean of the ranks' equal shares of it
            loss = _eval_loss(trainer, local).reshape(1)
            dist.all_reduce(loss)
            print(f"SAVED rank={rank} step={step} blocked={blocked:.3f} "
                  f"eval={loss.item() / nprocs:.6f}", flush=True)


def _worker_restore(ckpt_dir: str, tag: str, device: str) -> int:
    """One process, no mesh: restore the ranks' shard sets from storage
    (a fresh scope: no shm), evaluate and train on."""
    import math

    import torch

    from dlrover_tpu_torch.trainer.flash_checkpoint import Checkpointer

    torch.set_num_threads(1)
    dev = _device(device)
    trainer = _trainer(dev)
    batch = _batch()
    ckpt = Checkpointer(ckpt_dir, scope=f"mcr{tag}", device=dev)
    try:
        t0 = time.perf_counter()
        state, step = ckpt.load_checkpoint(trainer.create_state(),
                                           trainer=trainer)
        restore_s = time.perf_counter() - t0
    finally:
        ckpt.engine.unlink_memory()
        ckpt.close()
    assert state is not None and step == SAVE_STEP, (
        f"restore failed: step={step}")
    eval_loss = _eval_loss(trainer, batch).item()
    state, metrics = trainer.train_step(state, trainer.shard_batch(batch))
    next_loss = metrics["loss"].item()
    assert math.isfinite(next_loss)
    print(f"RESTORE step={step} restore_s={restore_s:.3f} "
          f"eval={eval_loss:.6f} next_loss={next_loss:.6f}", flush=True)
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(args: List[str], log_path: str) -> subprocess.Popen:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    with open(log_path, "w") as log:
        return subprocess.Popen([sys.executable, "-m", _MODULE, *args],
                                stdout=log, stderr=subprocess.STDOUT,
                                env=env)


def _grep_last(path: str, prefix: str) -> Optional[str]:
    try:
        with open(path) as f:
            lines = [ln for ln in f if ln.startswith(prefix)]
        return lines[-1].strip() if lines else None
    except OSError:
        return None


def _tail(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()[-800:]
    except OSError:
        return "<no log>"


def _field(line: str, key: str) -> float:
    return float(line.split(f"{key}=")[1].split()[0])


def _drop_segments(tag: str, nprocs: int) -> None:
    """Unlink the killed ranks' shm segments (nobody else will)."""
    from dlrover_tpu_torch.common.multi_process import SharedMemoryBuffer
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import shm_name

    for rank in range(nprocs):
        shm = SharedMemoryBuffer(shm_name(rank, f"mc{tag}"))
        if shm.attach():
            shm.unlink()


def run_multi_controller_drill(nprocs: int = 2, device: str = "cuda",
                               ckpt_dir: Optional[str] = None,
                               timeout: float = 420.0) -> Dict:
    """Orchestrate: train across ``nprocs`` processes, SIGKILL the last
    after the save, reap the rest, restore in one process."""
    tag = uuid.uuid4().hex[:8]
    own_dir = ckpt_dir is None
    if own_dir:
        ckpt_dir = tempfile.mkdtemp(prefix="dlrover_tpu_torch_mc_")
    port = _free_port()
    logs = [os.path.join(ckpt_dir, f"train_r{r}.log") for r in range(nprocs)]
    procs = [_spawn(["worker_train", str(r), str(nprocs), str(port),
                     ckpt_dir, tag, device], logs[r])
             for r in range(nprocs)]
    deadline = time.time() + timeout
    try:
        while True:  # until every rank reports its save committed
            saved = [_grep_last(lg, "SAVED") for lg in logs]
            if all(saved):
                break
            if any(p.poll() is not None for p in procs):
                raise RuntimeError("train worker died before saving: "
                                   f"{[_tail(lg) for lg in logs]}")
            if time.time() > deadline:
                raise TimeoutError(f"no save within {timeout}s: "
                                   f"{[_tail(lg) for lg in logs]}")
            time.sleep(0.2)
        train_eval = _field(saved[0], "eval")
        # kill the last rank mid-training (inside or between collectives);
        # the survivor blocks on its lost peer: reap it after a grace window
        procs[-1].send_signal(signal.SIGKILL)
        killed_rc = procs[-1].wait(timeout=30)
        grace = time.time() + 15
        survivor_rcs = []
        for p in procs[:-1]:
            try:
                survivor_rcs.append(
                    p.wait(timeout=max(0.5, grace - time.time())))
            except subprocess.TimeoutExpired:
                p.send_signal(signal.SIGKILL)
                survivor_rcs.append(p.wait(timeout=30))
        restore_log = os.path.join(ckpt_dir, "restore.log")
        proc = _spawn(["worker_restore", ckpt_dir, tag, device], restore_log)
        rc = proc.wait(timeout=max(60.0, deadline - time.time()))
        restored = _grep_last(restore_log, "RESTORE")
        if rc != 0 or restored is None:
            raise RuntimeError(f"restore failed rc={rc}: "
                               f"{_tail(restore_log)}")
        restore_eval = _field(restored, "eval")
        drift = abs(restore_eval - train_eval) / max(1.0, abs(train_eval))
        assert drift <= 1e-4, (f"loss discontinuity across the process-count "
                               f"change: {train_eval} -> {restore_eval}")
        return {
            "topology": f"{nprocs}x1 -> 1x1",
            "meshes": f"fsdp{nprocs} -> none",
            "save_step": SAVE_STEP,
            "train_eval_loss": round(train_eval, 6),
            "restore_eval_loss": round(restore_eval, 6),
            "restore_s": _field(restored, "restore_s"),
            "post_restore_loss": _field(restored, "next_loss"),
            "killed_rank_rc": killed_rc,
            "survivor_rcs": survivor_rcs,
        }
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        _drop_segments(tag, nprocs)
        if own_dir:
            import shutil

            shutil.rmtree(ckpt_dir, ignore_errors=True)


def main(argv: List[str]) -> int:
    mode = argv[0]
    if mode == "worker_train":
        return _worker_train(int(argv[1]), int(argv[2]), int(argv[3]),
                             argv[4], argv[5], argv[6])
    if mode == "worker_restore":
        return _worker_restore(argv[1], argv[2], argv[3])
    if mode == "drill":
        device = argv[1] if len(argv) > 1 else "cuda"
        print(json.dumps(run_multi_controller_drill(device=device)))
        return 0
    print(f"unknown mode {mode!r}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
