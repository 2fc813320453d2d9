"""What the gloo ranks of tests/test_torch_replica.py and
tests/test_torch_peer_restore.py run (``process_group.spawn`` imports this
module in every rank from the parent's ``sys.path``).

``lose_spec`` and ``jax_losses`` are the engine runs' tiny Llama on a dp=2
mesh, from the JAX model's init, and the JAX Trainer's losses for it (both
import JAX inside, so the ranks never do).  ``replica_worker`` drives
``CkptReplicaManager`` on raw segments, case by case: each rank writes its
payload, backs it up over the ring, checks what its backup segment holds,
then the case's lost rank drops its segment and its backup, and every rank
restores from the ring.  ``store_client_worker`` drives
``StorePeerClient`` over the world's store.
"""

import uuid
from typing import Any, Dict, List

import numpy as np
import torch

from dlrover_tpu_torch.common.multi_process import SharedMemoryBuffer
from dlrover_tpu_torch.master.ckpt_coordinator import PeerRestoreBroker
from dlrover_tpu_torch.parallel.process_group import DpGroup
from dlrover_tpu_torch.trainer.flash_checkpoint import peer_restore
from dlrover_tpu_torch.trainer.flash_checkpoint.replica import (
    BACKUP_SHM_SUFFIX,
    CkptReplicaManager,
)

B, S, STEPS = 16, 16, 2
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=100)
LOSS_RTOL = 1e-6


def _batch():
    ids = np.random.default_rng(0).integers(0, 256, size=(B, S + 1))
    return {"input_ids": ids[:, :-1].astype(np.int32),
            "labels": ids[:, 1:].astype(np.int32)}


def jax_losses(jax, steps):
    """The JAX Trainer's uninterrupted steps on a dp=2 mesh of the
    conftest's virtual CPU devices, and its initial params."""
    import flax.linen as nn
    import jax.numpy as jnp

    from dlrover_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from dlrover_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu.trainer import optim as joptim
    from dlrover_tpu.trainer.train import Trainer as JaxTrainer

    mesh = build_mesh(MeshConfig(dp=2), devices=jax.devices()[:2])
    trainer = JaxTrainer(JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32)),
                         joptim.create_optimizer(**OPT), mesh)
    batch = _batch()
    state = trainer.create_state(jax.random.PRNGKey(0), batch["input_ids"])
    init = jax.tree.map(np.asarray, nn.meta.unbox(state.params))
    losses = []
    for _ in range(steps):
        state, metrics = trainer.train_step(state, batch)
        losses.append(float(metrics["loss"]))
    return init, np.array(losses)


def lose_spec(tmp_path_factory, modes):
    """The ``train_worker`` spec of the tiny Llama on dp=2 from the JAX
    model's init, one run per mode of ``lose_and_restore``."""
    import jax
    import flax.linen as nn
    import jax.numpy as jnp

    from dlrover_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from dlrover_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from dlrover_tpu_torch.models.convert import flax_llama_to_state_dict
    from dlrover_tpu_torch.models.llama import LlamaConfig

    model = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32))
    init = jax.tree.map(np.asarray, nn.meta.unbox(jax.jit(
        lambda rng: model.init(rng, _batch()["input_ids"]))(
            jax.random.PRNGKey(0))["params"]))
    state_dict = {k: v.numpy() for k, v in flax_llama_to_state_dict(
        init, LlamaConfig.tiny(dtype=torch.float32)).items()}
    runs = [dict(name=mode, axes=dict(dp=2), steps=STEPS,
                 lose=dict(dir=str(tmp_path_factory.mktemp(mode)),
                           scope=f"l{uuid.uuid4().hex[:8]}", mode=mode))
            for mode in modes]
    spec = dict(preset="tiny", model=dict(dtype=torch.float32),
                state_dict=state_dict, batch=_batch(), optimizer=OPT,
                grads_dtype=None, runs=runs)
    return spec, init


def payload_for(rank: int, size: int, torn: bool = False) -> bytes:
    """The reference drill's bytes (tests/scripts/replica_asym_worker.py),
    with the seqlock generation word ``[8, 16)`` set even (0), or odd (1)
    for a torn segment.  The drill's own bytes there are the pattern's,
    and rank 0's end in 45: an odd generation, which both packages'
    ``backup`` read as a torn segment and skip."""
    data = ((np.arange(size) * (rank + 3)) % 251).astype(np.uint8)
    if size >= 16:
        data[8:16] = 0
        data[15] = 1 if torn else 0
    return data.tobytes()


def _barrier(group: DpGroup) -> None:
    group.all_reduce(torch.zeros(1))


def _read(name: str, nbytes: int):
    shm = SharedMemoryBuffer(name)
    if not shm.attach():
        return None
    got = bytes(shm.buf[:nbytes])
    shm.close()
    return got


def _drop(name: str) -> None:
    shm = SharedMemoryBuffer(name)
    if shm.attach():
        shm.unlink()


def replica_worker(group: DpGroup, cases: List[Dict[str, Any]]
                   ) -> Dict[str, Dict[str, Any]]:
    """Each case: ``name``, ``scope``, ``sizes`` and ``chunks`` by rank,
    ``torn`` (ranks whose segment is torn) and ``lost`` (the rank that
    loses its segment and backup).  Returns, by case: whether the backup
    holds the predecessor's bytes exactly (None when it holds nothing),
    the exchange record, whether ``restore_from_peers`` wrote the segment
    and whether it holds this rank's bytes again."""
    rank, n = group.rank, group.world
    out = {}
    for case in cases:
        name = f"rep_{case['scope']}_{rank}"
        torn = case.get("torn", [])
        mine = payload_for(rank, case["sizes"][rank], rank in torn)
        shm = SharedMemoryBuffer(name)
        shm.init(len(mine))
        shm.buf[:len(mine)] = mine
        shm.close()
        record: Dict[str, Any] = {}
        try:
            mgr = CkptReplicaManager(name, rank, n,
                                     chunk_bytes=case["chunks"][rank],
                                     device="cpu")
            record["backup"] = mgr.backup()
            record["exchange"] = dict(mgr.last_exchange)
            prev = (rank - 1) % n
            expected = payload_for(prev, case["sizes"][prev], prev in torn)
            got = _read(name + BACKUP_SHM_SUFFIX, len(expected))
            record["backup_equal"] = None if got is None else got == expected
            mgr.close()
            _barrier(group)
            if rank == case["lost"]:
                _drop(name)
                _drop(name + BACKUP_SHM_SUFFIX)
                record["dropped"] = _read(name, 1) is None
            _barrier(group)
            fresh = CkptReplicaManager(name, rank, n,
                                       chunk_bytes=case["chunks"][rank],
                                       device="cpu")
            record["restored"] = fresh.restore_from_peers()
            record["restore_exchange"] = dict(fresh.last_exchange)
            record["restore_equal"] = _read(name, len(mine)) == mine
            fresh.close()
            _barrier(group)
        finally:
            _drop(name)
            _drop(name + BACKUP_SHM_SUFFIX)
        out[case["name"]] = record
    return out


def store_client_worker(group: DpGroup, spec: Dict[str, Any]
                        ) -> Dict[str, Any]:
    """``StorePeerClient`` over the world's store: every rank announces
    ``spec["announce"][rank]`` (``[step, addr]`` or None), then asks for
    its assignment with ``spec["groups"][rank]``; rank 1 files a report
    and evicts rank 0.  Returns each assignment, the assignment of a
    ``PeerRestoreBroker`` fed the same announcements in this process, the
    reports every rank reads back and the assignment after the
    eviction."""
    import torch.distributed as dist

    rank, n = group.rank, group.world
    scope = spec["scope"]
    client = peer_restore.default_client(n)
    assert isinstance(client, peer_restore.StorePeerClient)
    assert peer_restore.default_client(n) is client
    mine = spec["announce"][rank]
    if mine is not None:
        client.report_peer_announce(scope, mine[0], mine[1], num_processes=n)
    _barrier(group)
    broker = PeerRestoreBroker()
    for pid, entry in enumerate(spec["announce"]):
        if entry is not None:
            broker.announce(scope, pid, n, entry[0], entry[1])
    group_hint = spec["groups"][rank]
    got = client.get_peer_assignment(scope, step=-1, group=group_hint)
    out: Dict[str, Any] = {
        "assignment": {"step": got.step, "donors": got.donors},
        "broker": broker.assign(scope, rank, step=-1, group=group_hint),
        "pinned": client.get_peer_assignment(scope, step=spec["pinned"]
                                             ).donors,
    }
    _barrier(group)
    if rank == 1:
        client.report_recovery({"scope": scope, "process_id": 1, "step": 5,
                                "rung": "peer_shm", "filled": True})
        client.evict(scope, 0)
    _barrier(group)
    out["recoveries"] = client.recoveries()
    out["after_evict"] = client.get_peer_assignment(scope).donors
    out["world"] = dist.get_world_size()
    _barrier(group)
    return out
