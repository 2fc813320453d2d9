"""Rank functions for the flash checkpoint tests over ranks (not a test
module: pytest does not collect it).

``decision_worker`` walks the restore's decision table on a replicated
state; ``ef_worker`` saves and restores the error-feedback residuals of a
quantized dp trainer on ``MLP``, the port's copy of the reference tests'
regression MLP (``nn.Dense`` kernels ``[in, out]``, so that the leaves, their
names and their shapes are the JAX model's).  This module imports torch
and the port only, so a spawned rank that unpickles a function never
imports JAX.
"""

import os
import struct
from typing import Any, Dict

import numpy as np
import torch

from dlrover_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu_torch.trainer import optim
from dlrover_tpu_torch.trainer.flash_checkpoint import (
    Checkpointer,
    StorageType,
)
from dlrover_tpu_torch.trainer.train import Trainer

# (in, out) of the MLP's three Dense layers.  Dense_1's bias (6,) and
# Dense_2's kernel (6, 1) split over 2 ranks and not over 4: a dp shrink
# makes them shardable, and they have no stored residual
MLP_DIMS = ((16, 32), (32, 6), (6, 1))


class MLP(torch.nn.Module):
    """``tanh(tanh(x W0 + b0) W1 + b1) W2 + b2``, the weights seeded."""

    def __init__(self):
        super().__init__()
        rng = np.random.default_rng(0)
        for i, (n_in, n_out) in enumerate(MLP_DIMS):
            layer = torch.nn.Module()
            layer.kernel = torch.nn.Parameter(torch.from_numpy(
                rng.standard_normal((n_in, n_out)).astype(np.float32)
                / np.sqrt(n_in)))
            layer.bias = torch.nn.Parameter(torch.zeros(n_out))
            setattr(self, f"Dense_{i}", layer)

    def set_data_parallel(self, groups) -> None:
        """The mesh path's hook (``Trainer(mesh=...)``): nothing of the
        MLP depends on the data ranks."""

    def forward(self, x):
        h = x
        for i in range(len(MLP_DIMS)):
            layer = getattr(self, f"Dense_{i}")
            h = h @ layer.kernel + layer.bias
            if i < len(MLP_DIMS) - 1:
                h = torch.tanh(h)
        return h[..., 0]


def mlp_trainer(group, on_mesh: bool) -> Trainer:
    """``MLP`` under ``grad_sync="int8_sharded"``: over the dp group, or
    ``on_mesh`` over a mesh whose only axis is dp (the Trainer's two
    paths to the sync)."""
    model = MLP()

    def loss_fn(batch):
        return ((model(batch["x"]) - batch["y"]) ** 2).mean()

    where = (dict(mesh=build_mesh(MeshConfig(dp=group.world),
                                  device=group.device)) if on_mesh
             else dict(dp_group=group))
    return Trainer(model, optim.adamw(lambda count: 1e-2), loss_fn=loss_fn,
                   grad_sync="int8_sharded", device=group.device, **where)


def _barrier(group) -> None:
    group.all_reduce(torch.zeros(1, device=group.device))


def ef_worker(group, spec: Dict[str, Any]) -> Dict[str, Any]:
    """With ``spec["stacks"]`` (``{param name: (world, *leaf)}``): a fresh
    state of ``mlp_trainer`` (on a dp mesh with ``spec["on_mesh"]``) at
    step ``spec["step"]`` whose residuals are this rank's rows of the
    stacks, saved to storage in ``spec["dir"]``.  Then, on every rank,
    ``Trainer.load_state`` from that directory in a scope of its own (no
    shm).  Returns the restored step and residuals (numpy)."""
    trainer = mlp_trainer(group, spec.get("on_mesh", False))
    if "stacks" in spec:
        state = trainer.create_state()
        state.step = spec["step"]
        state.ef_residual = {
            n: torch.from_numpy(spec["stacks"][n][group.rank].copy())
            for n in state.ef_residual}
        ckpt = Checkpointer(spec["dir"], scope=spec["scope"],
                            async_snapshot=False, device=group.device)
        try:
            ckpt.save_checkpoint(state.step, state, StorageType.DISK,
                                 trainer=trainer)
            if not ckpt.wait_latest_checkpoint(timeout=60):
                raise RuntimeError("the save was not persisted")
            _barrier(group)
        finally:
            ckpt.engine.unlink_memory()
            ckpt.close()
    ckpt = Checkpointer(spec["dir"], scope=spec["scope"] + "_load",
                        device=group.device)
    try:
        state, step = trainer.load_state(ckpt)
    finally:
        ckpt.engine.unlink_memory()
        ckpt.close()
    return {"rank": group.rank, "step": step,
            "ef": {n: t.numpy().copy() for n, t in state.ef_residual.items()}}


def _replicated(value: float, step: int) -> Dict[str, Any]:
    return {"step": step, "w": torch.full((4, 8), float(value)),
            "b": torch.arange(6.0) + value}


def _load(ckpt):
    """``(step, w[0, 0])`` of a restore into a fresh replicated state
    (``w`` None when nothing restored); the state is whole on every rank,
    so its layout is ``{}``."""
    got, step = ckpt.load_checkpoint(_replicated(-1.0, 0), layout={})
    return step, None if got is None else got["w"][0, 0].item()


def _without_layout(group, ckpt) -> Dict[str, Any]:
    """``{call: ValueError message or None}`` of each save and restore of
    a tp=2 trainer's state (this rank's halves of the tp-split leaves)
    made with neither its trainer nor a layout: the async memory and
    storage saves, the engine's synchronous save, and the restore; and
    ``written``, the engine's newest shm step after them."""
    mesh = build_mesh(MeshConfig(dp=1, tp=2), device=group.device)
    trainer = Trainer(LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32),
                                       device=group.device),
                      optim.adamw(lambda count: 1e-3), mesh=mesh,
                      device=group.device)
    state = trainer.create_state()
    assert trainer.state_layout(state), "tp=2 splits no leaf"
    calls = {
        "memory": lambda: ckpt.save_checkpoint(1, state),
        "storage": lambda: ckpt.save_checkpoint(1, state, StorageType.DISK),
        "sync": lambda: ckpt.engine.save_to_memory(1, state),
        "load": lambda: ckpt.load_checkpoint(trainer.create_state()),
    }
    out: Dict[str, Any] = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    out["written"] = ckpt.engine.latest_memory_step
    return out


def _flip_payload_byte(step_dir: str, path: str) -> None:
    """Flip one byte of leaf ``path``'s stored shard in every process's
    payload file (each holds a copy of a replicated leaf)."""
    import json

    for name in os.listdir(step_dir):
        if not name.startswith("meta_"):
            continue
        with open(os.path.join(step_dir, name)) as f:
            meta = json.load(f)
        (leaf,) = [leaf for leaf in meta["leaves"] if leaf["path"] == path]
        offset = leaf["shards"][0]["offset"] + 1
        with open(os.path.join(step_dir, meta["bin_file"]), "r+b") as f:
            f.seek(offset)
            byte = f.read(1)
            f.seek(offset)
            f.write(bytes([byte[0] ^ 0xFF]))


def decision_worker(group, spec: Dict[str, Any]) -> Dict[str, Any]:
    """The restore's decision table over ranks (the reference's
    ``_load_traced`` and ``_load_from_storage``) on a replicated state,
    each outcome ``(step, w[0, 0])``: ``nothing`` (no checkpoint
    anywhere); ``shm`` (storage step 1, then step 2 in every rank's shm);
    ``torn`` (rank 1's shm generation made odd); ``mismatch`` (rank 0's
    shm at step 3, rank 1's at 2); ``eager_disagrees`` (a byte of step 1's
    payload flipped, a fresh scope with no shm, and rank 1 alone checking
    the CRCs at probe time, so it alone rejects step 1); ``corrupt``
    (both lazy: the agreed step fails at assembly, which raises on every
    rank, the error's type name); ``conflict``, the error a
    ``DLROVER_TPU_PROCESS_ID`` that names another rank gives; and
    ``no_layout``, ``_without_layout``'s refusals."""
    from dlrover_tpu_torch.trainer.flash_checkpoint import snapshot

    rank, root, scope = group.rank, spec["dir"], spec["scope"]
    out: Dict[str, Any] = {}
    made = []

    def checkpointer(name, sub):
        c = Checkpointer(os.path.join(root, sub), scope=f"{scope}{name}",
                         async_snapshot=False, device=group.device)
        made.append(c)
        return c

    try:
        out["nothing"] = _load(checkpointer("e", "empty"))
        ckpt = checkpointer("t", "table")
        ckpt.save_checkpoint(1, _replicated(1.0, 1), StorageType.DISK,
                             layout={})
        if not ckpt.wait_latest_checkpoint(timeout=60):
            raise RuntimeError("step 1 was not persisted")
        _barrier(group)
        ckpt.save_checkpoint(2, _replicated(2.0, 2), layout={})
        out["shm"] = _load(ckpt)
        if rank == 1:
            buf = ckpt.engine._shm.buf
            gen = struct.unpack(">Q", bytes(buf[8:16]))[0]
            buf[8:16] = struct.pack(">Q", gen | 1)
            assert snapshot.is_torn(ckpt.engine._shm)
        _barrier(group)
        out["torn"] = _load(ckpt)
        mine = 3 if rank == 0 else 2
        ckpt.save_checkpoint(mine, _replicated(float(mine), mine),
                             layout={})
        out["mismatch"] = _load(ckpt)
        _barrier(group)
        if rank == 0:
            _flip_payload_byte(os.path.join(root, "table", "1"), "w")
        _barrier(group)
        if rank == 1:
            os.environ["DLROVER_TPU_VERIFY_CRC"] = "eager"
        out["eager_disagrees"] = _load(checkpointer("f", "table"))
        os.environ.pop("DLROVER_TPU_VERIFY_CRC", None)
        try:
            out["corrupt"] = _load(checkpointer("g", "table"))
        except Exception as e:  # noqa: BLE001 - the error is the result
            out["corrupt"] = type(e).__name__
        os.environ["DLROVER_TPU_PROCESS_ID"] = str(1 - rank)
        try:
            checkpointer("h", "other")
            out["conflict"] = None
        except ValueError as e:
            out["conflict"] = str(e)
        finally:
            os.environ.pop("DLROVER_TPU_PROCESS_ID", None)
        no_layout = Checkpointer(os.path.join(root, "none"),
                                 scope=f"{scope}n", device=group.device)
        made.append(no_layout)
        out["no_layout"] = _without_layout(group, no_layout)
    finally:
        for c in made:
            c.engine.unlink_memory()
            c.close()
    return out
