"""Elastic Llama training with Flash Checkpoint: the survival demo.

Port of the reference's ``examples/train_llama_ckpt.py``, run as a module
so that it stays inside the port.  Run::

    python -m dlrover_tpu_torch.trainer.elastic_run --standalone \\
        --nproc_per_node=1 -m dlrover_tpu_torch.examples.train_llama_ckpt \\
        /path/to/ckpt_dir [tiny|llama2_1b]

Saves to host memory every 2 steps and to disk every 10; on restart
(crash, preemption, rescale) it resumes from the freshest snapshot: memory
if the world is unchanged, disk otherwise.  ``DLROVER_TPU_CRASH_AT_STEP=N``
simulates a hard crash (``os._exit(17)``) at step N of the first
incarnation; ``DLROVER_TPU_TOTAL_STEPS`` sets the steps (20).

The optional second argument picks the preset:

- ``tiny`` (the default, as the reference): ``LlamaConfig.tiny()``, a
  global batch of 8 x 33 tokens from seed 0, ``adamw(1e-2)``, over a mesh
  of every worker process (``dp``);
- ``llama2_1b``: the main path's model and recipe (``chip_smoke.py``'s
  ``[training]``): flash attention, remat, B=4, S=2048, bf16 gradients on
  fp32 masters, AdamW with bf16 moments; ``llama2_1b:N`` cuts its depth
  to N of its 22 layers.  Its snapshot is ~10 GB (at 22), and its
  memory saves are synchronous: an asynchronous one would still be
  staging when the crash one step later tears it.  Each step line also
  carries the step's flash kernel launches.

Every step prints ``step=N loss=<repr>``, and the worker ``ready_ts=
load_s=`` once its state is made and restored; the markers ``starting
fresh``, ``resumed from step N``, ``simulating crash at step N``,
``crash_ts=``, ``resume_ts= step=`` and ``done at step N, loss=`` are the
reference's.
"""

import os
import sys
import time

PRESETS = ("tiny", "llama2_1b")


def _subject(preset: str, device, layers: int = 0):
    """(model, optimizer, trainer kwargs, global batch) of a preset, at
    ``layers`` layers when not 0."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from dlrover_tpu_torch.trainer import optim

    if preset == "tiny":
        cfg = LlamaConfig.tiny()
        rows, seq = 8, 32
        optimizer, kwargs = optim.adamw(lambda count: 1e-2), {}
    else:
        rows, seq = 4, 2048
        cfg = LlamaConfig.llama2_1b(max_seq_len=seq, attention_impl="flash",
                                    **({"num_layers": layers} if layers
                                       else {}))
        optimizer = optim.create_optimizer(
            peak_lr=3e-4, warmup_steps=10, total_steps=10_000,
            moment_dtype=torch.bfloat16)
        kwargs = {"grads_dtype": torch.bfloat16}
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            size=(rows, seq + 1))
    global_batch = {"input_ids": ids[:, :-1].astype(np.int32),
                    "labels": ids[:, 1:].astype(np.int32)}
    return model, optimizer, kwargs, global_batch


def main() -> int:
    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.trainer import bootstrap

    ctx = bootstrap.init()
    ckpt_dir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/dlrover_tpu_ckpt"
    preset = sys.argv[2] if len(sys.argv) > 2 else "tiny"
    preset, _, layers = preset.partition(":")
    if preset not in PRESETS:
        raise ValueError(f"preset {preset!r} not in {PRESETS}")

    from dlrover_tpu_torch.common import envs
    from dlrover_tpu_torch.ops.cuda import flash_attention as fa
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        Checkpointer,
        StorageType,
    )
    from dlrover_tpu_torch.trainer.train import Trainer
    from dlrover_tpu_torch.utils.timing import hard_block

    total_steps = int(os.getenv("DLROVER_TPU_TOTAL_STEPS", "20"))
    crash_at = int(os.getenv("DLROVER_TPU_CRASH_AT_STEP", "-1"))

    device = ("cpu" if envs.get_str("DLROVER_TPU_PLATFORM") == "cpu"
              else torch.device("cuda", torch.cuda.current_device()))
    model, optimizer, kwargs, global_batch = _subject(preset, device,
                                                       int(layers or 0))
    mesh = build_mesh(MeshConfig(dp=-1), device=device)
    trainer = Trainer(model, optimizer, mesh=mesh, device=device, **kwargs)
    # every process feeds its rows of the global batch
    batch = trainer.shard_batch(trainer.rows_of_global_batch(global_batch))

    ckpt = Checkpointer(ckpt_dir, device=device,
                        async_snapshot=preset == "tiny")
    try:
        target = trainer.create_state()
        t0 = time.time()
        state, start_step = ckpt.load_checkpoint(target, trainer=trainer)
        if state is None:
            state, start_step = target, 0
            print("starting fresh", flush=True)
        else:
            print(f"resumed from step {start_step}", flush=True)
        del target
        # when the worker was ready to train, and how long its restore took
        print(f"ready_ts={time.time():.3f} load_s={time.time() - t0:.3f}",
              flush=True)

        metrics = None
        first_resumed_step = ctx.restart_count > 0
        for step in range(start_step + 1, total_steps + 1):
            before = dict(fa.launches)
            state, metrics = trainer.train_step(state, batch)
            if first_resumed_step:
                # recovery benchmark marker: the step is only claimed
                # done once the device finished it (the recovery drill's
                # recovery_s parses the crash_ts -> resume_ts span)
                hard_block(metrics["loss"])
                print(f"resume_ts={time.time():.3f} step={step}",
                      flush=True)
                first_resumed_step = False
            line = f"step={step} loss={metrics['loss'].item()!r}"
            if preset == "llama2_1b":
                line += " launches=" + repr(
                    {k: fa.launches[k] - before[k] for k in fa.launches})
            print(line, flush=True)
            if step == crash_at and ctx.restart_count == 0:
                print(f"simulating crash at step {step}", flush=True)
                print(f"crash_ts={time.time():.3f}", flush=True)
                os._exit(17)
            # DISK implies the same shm snapshot, so never pair both at
            # one step (the second save would just re-stage the state)
            if step % 10 == 0:
                ckpt.save_checkpoint(step, state, StorageType.DISK,
                                     trainer=trainer)
            elif step % 2 == 0:
                ckpt.save_checkpoint(step, state, StorageType.MEMORY,
                                     trainer=trainer)
        if not ckpt.wait_latest_checkpoint(timeout=300):
            print("WARNING: final checkpoint persist did not complete",
                  flush=True)
        if metrics is not None:
            loss = metrics["loss"].item()
            print(f"done at step {total_steps}, loss={loss:.4f}", flush=True)
        else:
            print(f"done at step {total_steps} (already complete)",
                  flush=True)
        ckpt.engine.unlink_memory()  # clean completion: drop the snapshot
    finally:
        ckpt.close()
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
