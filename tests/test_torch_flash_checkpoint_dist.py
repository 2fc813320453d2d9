"""The port's flash checkpoint over a torch.distributed world (gloo ranks
on the CPU) against the JAX package's rules.

- A dp=2 x tp=2 mesh trainer of the tiny Llama (the JAX model's init,
  models/convert.py; B=16, S=16; create_optimizer with lr 1e-3 after one
  warm-up step) trains 2 steps, and every rank makes an async memory save
  and an async storage save of its local shards.  Every rank's restore
  from shm and from storage (a fresh scope) is ``torch.equal`` to a copy
  taken at the save, and the step after each restore has the loss of the
  uninterrupted run's next step.  Then 2 ranks on fsdp=2 restore the
  stored step (the reference's test_restore_with_different_mesh,
  tests/test_flash_checkpoint.py:135) and train 2 more steps: the 4
  losses match the JAX Trainer's 4 uninterrupted steps on a dp=2 x tp=2
  mesh of the conftest's virtual CPU devices within 1e-6 relative, the
  tolerance tests/test_torch_train_mesh.py states for fp32 meshes (the
  two trainers differ in summation order only).
- The decision table of the reference's ``_load_traced`` and
  ``_load_from_storage``, on 2 ranks of a replicated state
  (tests/torch_ckpt_checks.py ``decision_worker``).
- A world refuses a save or a restore of a tp=2 state made with neither
  its trainer nor a layout: its local shards would pass for whole leaves.
- The stored boxes: a replicated box stored by every rank counts once.

Each spawn has its own timeout, so a rank that skipped a collective fails
the test instead of stalling the suite.
"""

import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.parallel import dp_workers, process_group
from dlrover_tpu_torch.trainer.flash_checkpoint.snapshot import ShardIndexMap
from dlrover_tpu_torch.trainer.train import _placed_box
from torch.distributed.tensor import Replicate, Shard

from torch_ckpt_checks import decision_worker

B, S, STEPS = 16, 16, 2
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=100)
LOSS_RTOL = 1e-6
SPAWN_TIMEOUT_S = 180.0


def _batch():
    ids = np.random.default_rng(0).integers(0, 256, size=(B, S + 1))
    return {"input_ids": ids[:, :-1].astype(np.int32),
            "labels": ids[:, 1:].astype(np.int32)}


def _jax_run(jax):
    """The JAX Trainer's 4 uninterrupted steps on dp=2 x tp=2, and its
    initial params."""
    import flax.linen as nn
    import jax.numpy as jnp

    from dlrover_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from dlrover_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu.trainer import optim as joptim
    from dlrover_tpu.trainer.train import Trainer as JaxTrainer

    mesh = build_mesh(MeshConfig(dp=2, tp=2), devices=jax.devices()[:4])
    trainer = JaxTrainer(JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32)),
                         joptim.create_optimizer(**OPT), mesh)
    batch = _batch()
    state = trainer.create_state(jax.random.PRNGKey(0), batch["input_ids"])
    init = jax.tree.map(np.asarray, nn.meta.unbox(state.params))
    losses = []
    for _ in range(2 * STEPS):
        state, metrics = trainer.train_step(state, batch)
        losses.append(float(metrics["loss"]))
    return init, np.array(losses)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """dp=2 x tp=2 (4 ranks: train, save, restore) and then fsdp=2 (2
    ranks: resume from its storage, train), and the decision table's 2
    ranks, in the background, while the JAX Trainer runs here; the
    trainers from the JAX model's init."""
    jax = pytest.importorskip("jax")
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
    ckpt_dir = str(tmp_path_factory.mktemp("mesh_ckpt"))
    scope = f"m{uuid.uuid4().hex[:8]}"
    spec = dict(preset="tiny", model=dict(dtype=torch.float32),
                state_dict=state_dict, batch=_batch(), optimizer=OPT,
                grads_dtype=None)
    saving = dict(spec, runs=[dict(
        name="dp2_tp2", axes=dict(dp=2, tp=2), steps=STEPS,
        save=dict(dir=ckpt_dir, scope=scope))])
    resuming = dict(spec, runs=[dict(
        name="fsdp2", axes=dict(dp=1, fsdp=2), steps=STEPS,
        resume=dict(dir=ckpt_dir, scope=scope + "r"))])

    def port():
        saved = process_group.spawn(dp_workers.train_worker, 4, (saving,),
                                    device="cpu", timeout_s=SPAWN_TIMEOUT_S)
        resumed = process_group.spawn(dp_workers.train_worker, 2,
                                      (resuming,), device="cpu",
                                      timeout_s=SPAWN_TIMEOUT_S)
        return ([r["runs"]["dp2_tp2"] for r in saved],
                [r["runs"]["fsdp2"] for r in resumed])

    table = dict(dir=str(tmp_path_factory.mktemp("table")),
                 scope=f"d{uuid.uuid4().hex[:8]}")
    with ThreadPoolExecutor(2) as pool:
        background = pool.submit(port)
        decisions = pool.submit(process_group.spawn, decision_worker, 2,
                                (table,), device="cpu",
                                timeout_s=SPAWN_TIMEOUT_S)
        jax_init, jax_losses = _jax_run(jax)
        saved, resumed = background.result()
        decisions = decisions.result()
    for a, b in zip(jax.tree.leaves(init), jax.tree.leaves(jax_init)):
        np.testing.assert_array_equal(a, b)
    return dict(saved=saved, resumed=resumed, jax_loss=jax_losses,
                table=decisions)


def test_every_rank_restores_its_shards_exactly(runs):
    """From shm and from storage, on every rank of dp=2 x tp=2: every
    leaf ``torch.equal`` to the copy taken at the save, the step saved,
    and the next step's loss the uninterrupted run's."""
    for rec in runs["saved"]:
        ckpt = rec["ckpt"]
        assert ckpt["persisted"] and ckpt["step"] == STEPS
        for source in ("shm", "storage"):
            assert ckpt[f"{source}_step"] == STEPS, source
            assert ckpt[f"{source}_equal"], source
            np.testing.assert_allclose(ckpt[source]["loss"],
                                       ckpt["next"]["loss"], rtol=LOSS_RTOL)
        assert ckpt["next"]["loss"] == runs["saved"][0]["ckpt"]["next"]["loss"]


def test_storage_restore_onto_another_mesh_matches_jax(runs):
    """dp=2 x tp=2's 2 steps, then fsdp=2's 2 steps from its stored
    state: the JAX Trainer's 4 uninterrupted steps."""
    want = runs["jax_loss"]
    for rec in runs["saved"]:
        np.testing.assert_allclose(rec["loss"], want[:STEPS],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(rec["ckpt"]["next"]["loss"],
                                   want[STEPS:STEPS + 1], rtol=LOSS_RTOL)
    for rec in runs["resumed"]:
        assert rec["resumed_step"] == STEPS
        assert rec["shape"]["fsdp"] == 2 and rec["shape"]["tp"] == 1
        np.testing.assert_allclose(rec["loss"], want[STEPS:],
                                   rtol=LOSS_RTOL)


@pytest.fixture(scope="module")
def table(runs):
    """``decision_worker`` on 2 ranks (spawned beside the mesh's)."""
    return runs["table"]


@pytest.mark.parametrize("case,want", [
    ("nothing", (-1, None)),
    ("shm", (2, 2.0)),
    ("torn", (1, 1.0)),
    ("mismatch", (1, 1.0)),
    ("eager_disagrees", (-1, None)),
    ("corrupt", "OSError"),
])
def test_restore_decision_is_agreed_by_every_rank(table, case, want):
    """The reference's rules: shm only when every rank offers the same
    step; one torn shm, or shm steps that differ, send every rank to
    storage; a storage step that one rank cannot read is no step for any
    (every rank starts fresh); nothing anywhere is ``(None, -1)`` on
    every rank; and an agreed step that fails at assembly raises on every
    rank instead of one rank falling back alone."""
    assert [rank[case] for rank in table] == [want, want]


def test_process_id_that_names_another_rank_raises(table):
    for rank, got in enumerate(table):
        assert got["conflict"] == (
            f"DLROVER_TPU_PROCESS_ID={1 - rank} conflicts with the "
            f"torch.distributed world (process_id {rank})")


def test_a_world_refuses_a_state_without_its_layout(table):
    """Saves (async memory, async storage, the engine's sync save) and the
    restore of a tp=2 trainer's state with neither ``trainer=`` nor
    ``layout=`` raise on every rank, and nothing is written."""
    for rank in table:
        got = dict(rank["no_layout"])
        assert got.pop("written") == -1
        assert set(got) == {"memory", "storage", "sync", "load"}
        for call, message in got.items():
            assert message is not None, call
            assert message.startswith(
                "a world of 2 processes needs the state's layout"), message


def test_a_box_stored_by_every_rank_counts_once():
    """A replicated leaf is in every rank's file: its box counts once, so
    two copies of the first half never pass for the whole leaf."""
    m = ShardIndexMap("float32", [4, 2])
    half = torch.arange(4.0).reshape(2, 2)
    m.add([[0, 2], [0, 2]], half)
    m.add([[0, 2], [0, 2]], half + 100)
    assert not m.covers((slice(0, 4), slice(0, 2)))
    assert torch.equal(m.exact([[0, 2], [0, 2]]), half)
    m.add([[2, 4], [0, 2]], half + 4)
    assert torch.equal(m.read((slice(1, 3), slice(0, 2))),
                       torch.tensor([[2.0, 3.0], [4.0, 5.0]]))


def test_fsdp_box_sits_inside_the_tp_shard():
    """A local [2, 3] shard of a leaf split over tp=2 and fsdp=2 along dim
    0 and over ep=2 along dim 1: tp rank 1 holds rows [4, 8), fsdp rank 0
    the first half of those; ep rank 1 the columns [3, 6)."""
    place = [Replicate()] * 6
    place[1] = Shard(0)  # fsdp
    place[2] = Shard(0)  # tp
    place[4] = Shard(1)  # ep
    coord = dict(dp=0, fsdp=0, tp=1, cp=0, ep=1, pp=0)
    sizes = dict(dp=1, fsdp=2, tp=2, cp=1, ep=2, pp=1)
    assert _placed_box((2, 3), place, coord, sizes) == (
        [8, 6], [[4, 6], [3, 6]])
