"""Flagship configuration: elastic Llama-2-7B pretraining on leased shards.

Port of the reference's ``examples/train_llama7b.py``, run as a module so
that it stays inside the port::

    python -m dlrover_tpu_torch.trainer.elastic_run --nnodes=4:16 \\
        --master-addr=$MASTER -m dlrover_tpu_torch.examples.train_llama7b \\
        /mnt/ckpt/llama7b

Scale knobs come from env so the same script runs the tiny CPU smoke
(``DLROVER_TPU_PRESET=tiny python -m dlrover_tpu_torch.trainer.elastic_run
--standalone --platform=cpu -m dlrover_tpu_torch.examples.train_llama7b
<dir>``).  The presets are the reference's:

- ``7b`` (the default): ``LlamaConfig.llama2_7b`` with flash attention,
  S=4096, one sequence a process, fsdp over every process,
  ``DLROVER_TPU_TOTAL_STEPS`` steps (1000);
- ``tiny``: ``LlamaConfig.tiny()``, S=32, 4 sequences a process, 12
  steps, dp over every process.

Process 0 leases the data from the master through ``SPMDShardingClient``
and the others replay its shard sequence; every step reports its batch
done, and the master's shard position goes into each checkpoint's
``extras["shards"]``.  On resume it is restored, so the shards consumed
after the snapshot are replayed, not skipped.  Besides the reference's
markers (``starting fresh``, ``resumed from step N``, ``restored
data-shard position``, ``done at step N, loss=``) each leased shard prints
``shard=<name> [start, end)`` and each step ``step=N loss=<repr>``.
"""

import os
import sys

PRESETS = ("7b", "tiny")


def _say(line: str) -> None:
    """One marker line in one write: the workers share the launcher's
    unbuffered stdout, where print's text and newline are two writes
    that another process's line can land between."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def main() -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.trainer import bootstrap

    ctx = bootstrap.init()
    ckpt_dir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/llama7b_ckpt"

    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.agent.sharding import SPMDShardingClient
    from dlrover_tpu_torch.common import envs
    from dlrover_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        Checkpointer,
        StorageType,
    )
    from dlrover_tpu_torch.trainer.optim import create_optimizer
    from dlrover_tpu_torch.trainer.train import Trainer

    preset = os.getenv("DLROVER_TPU_PRESET", "7b")
    if preset not in PRESETS:
        raise ValueError(f"preset {preset!r} not in {PRESETS}")
    device = ("cpu" if envs.get_str("DLROVER_TPU_PLATFORM") == "cpu"
              else torch.device("cuda", torch.cuda.current_device()))
    if preset == "tiny":
        cfg = LlamaConfig.tiny()
        seq, micro, total_steps = 32, 4, 12
        mesh = build_mesh(MeshConfig(dp=-1), device=device)
    else:
        # Llama-2-7B; fsdp over every process, flash attention kernels,
        # remat'd layers
        cfg = LlamaConfig.llama2_7b(attention_impl="flash")
        seq, micro = 4096, 1
        total_steps = int(os.getenv("DLROVER_TPU_TOTAL_STEPS", "1000"))
        mesh = build_mesh(MeshConfig(dp=1, fsdp=-1), device=device)

    model = LlamaForCausalLM(cfg, device=device, seed=0)
    optimizer = create_optimizer(
        peak_lr=3e-4, warmup_steps=min(200, total_steps // 10),
        total_steps=total_steps,
    )
    trainer = Trainer(model, optimizer, mesh=mesh, device=device)

    global_batch = micro * ctx.num_processes
    rng = np.random.default_rng(ctx.process_id)

    ckpt = Checkpointer(ckpt_dir, replica=ctx.num_processes > 1,
                        device=device)
    try:
        target = trainer.create_state()
        state, start_step = ckpt.load_checkpoint(target, trainer=trainer)
        if state is None:
            state, start_step = target, 0
            _say("starting fresh")
        else:
            _say(f"resumed from step {start_step}")
        del target

        client = MasterClient.singleton_instance()
        if client is not None and ctx.process_id == 0:
            client.report_model_info(
                num_params=model.num_params(),
                num_layers=cfg.num_layers,
                hidden_size=cfg.hidden_size,
                seq_len=seq,
                batch_size_per_device=micro,
            )
        shards = SPMDShardingClient(
            dataset_name="pretrain",
            batch_size=global_batch,
            num_epochs=1,
            dataset_size=global_batch * total_steps,
            process_id=ctx.process_id,
            client=client,
        )
        # resume the DATA position together with the model: shards
        # consumed after the restored snapshot must be replayed, not
        # skipped
        shard_state = (ckpt.last_extras or {}).get("shards", "")
        if shard_state and ctx.process_id == 0:
            shards.restore_shard_from_checkpoint(shard_state)
            _say("restored data-shard position")

        metrics = None
        step = start_step
        while step < total_steps:
            shard = shards.fetch_shard()
            if shard is None:
                break
            _say(f"shard={shard.name} [{shard.start}, {shard.end})")
            for _ in range(max(1, (shard.end - shard.start) // global_batch)):
                # synthetic tokens stand in for the real corpus reader
                host_ids = rng.integers(
                    0, cfg.vocab_size, size=(micro, seq + 1)
                )
                batch = trainer.shard_batch(
                    {
                        "input_ids": np.asarray(host_ids[:, :-1], np.int32),
                        "labels": np.asarray(host_ids[:, 1:], np.int32),
                    }
                )
                state, metrics = trainer.train_step(state, batch)
                step += 1
                shards.report_batch_done()
                _say(f"step={step} loss={metrics['loss'].item()!r}")
                if client is not None and ctx.process_id == 0:
                    client.report_global_step(step)
                extras = {}
                if ctx.process_id == 0:
                    extras["shards"] = shards.get_shard_checkpoint()
                # DISK implies the same shm snapshot; elif avoids
                # re-staging identical state in the same iteration
                if step % 200 == 0:
                    ckpt.save_checkpoint(step, state, StorageType.DISK,
                                         extras=extras, trainer=trainer)
                elif step % 10 == 0:
                    ckpt.save_checkpoint(step, state, StorageType.MEMORY,
                                         extras=extras, trainer=trainer)
                if step >= total_steps:
                    break
        final_extras = {}
        if ctx.process_id == 0:
            final_extras["shards"] = shards.get_shard_checkpoint()
        ckpt.save_checkpoint(step, state, StorageType.DISK,
                             extras=final_extras, trainer=trainer)
        if not ckpt.wait_latest_checkpoint():
            _say("WARNING: final checkpoint persist did not complete")
        if metrics is not None:
            _say(f"done at step {step}, loss="
                 f"{metrics['loss'].item():.4f}")
        if step >= total_steps:
            # clean completion: drop the shm snapshot (a model-sized
            # segment must not outlive the job, and a stale one would
            # fake a resume)
            ckpt.engine.unlink_memory()
    finally:
        ckpt.close()
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
