"""The port's worker bootstrap (dlrover_tpu_torch/trainer/bootstrap.py)
against the JAX package's (dlrover_tpu/trainer/bootstrap.py): the
WorkerContext both read from the same agent environment, a world of one
process that initialises nothing, and 2 worker processes started as the
agent starts them (process_group.launch: the rendezvous env with a
127.0.0.1 coordinator) that join one gloo group over tcp through
``init(platform="cpu")``; and the refusals (no card without
platform="cpu", a distributed world without a coordinator)."""

import dataclasses

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from dlrover_tpu.trainer import bootstrap as jbootstrap  # noqa: E402
from dlrover_tpu_torch.parallel import mesh_workers, process_group  # noqa: E402
from dlrover_tpu_torch.trainer import bootstrap  # noqa: E402

ENV = {
    "DLROVER_TPU_NODE_RANK": "3", "DLROVER_TPU_LOCAL_RANK": "1",
    "DLROVER_TPU_PROCESS_ID": "7", "DLROVER_TPU_NUM_PROCESSES": "8",
    "DLROVER_TPU_NODE_NUM": "4", "DLROVER_TPU_RESTART_COUNT": "2",
    "DLROVER_TPU_RDZV_ROUND": "5", "DLROVER_TPU_MASTER_ADDR": "m:1",
    "DLROVER_TPU_COORDINATOR_ADDR": "c:2",
}


@pytest.fixture
def fresh_context(monkeypatch):
    """Both packages read the environment anew."""
    monkeypatch.setattr(bootstrap, "_worker_ctx", None)
    monkeypatch.setattr(jbootstrap, "_worker_ctx", None)
    yield monkeypatch
    assert not dist.is_initialized()


def test_worker_context_matches_the_reference(fresh_context):
    for key, value in ENV.items():
        fresh_context.setenv(key, value)
    got = dataclasses.asdict(bootstrap.worker_context())
    assert got == dataclasses.asdict(jbootstrap.worker_context())
    assert got["process_id"] == 7 and got["coordinator_addr"] == "c:2"
    assert bootstrap.worker_context().is_distributed


def test_defaults_match_the_reference(fresh_context):
    for key in ENV:
        fresh_context.delenv(key, raising=False)
    assert dataclasses.asdict(bootstrap.worker_context()) == \
        dataclasses.asdict(jbootstrap.worker_context())
    assert not bootstrap.worker_context().is_distributed


def test_world_of_one_initialises_nothing(fresh_context):
    fresh_context.setenv("DLROVER_TPU_NUM_PROCESSES", "1")
    fresh_context.setenv("DLROVER_TPU_COORDINATOR_ADDR", "127.0.0.1:1")
    ctx = bootstrap.init(platform="cpu")
    assert ctx.num_processes == 1 and not ctx.is_distributed
    assert not dist.is_initialized()


@pytest.mark.skipif(torch.cuda.is_available(), reason="has a card")
def test_the_card_without_one_raises(fresh_context):
    fresh_context.setenv("DLROVER_TPU_NUM_PROCESSES", "1")
    fresh_context.delenv("DLROVER_TPU_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bootstrap.init()


def test_a_world_without_a_coordinator_raises(fresh_context):
    fresh_context.setenv("DLROVER_TPU_NUM_PROCESSES", "2")
    fresh_context.delenv("DLROVER_TPU_COORDINATOR_ADDR", raising=False)
    with pytest.raises(ValueError, match="DLROVER_TPU_COORDINATOR_ADDR"):
        bootstrap.init(platform="cpu")


@pytest.mark.parametrize("world", [1, 2])
def test_launched_workers_join_one_group(world):
    """2 workers meet at the tcp coordinator through ``init`` (gloo on
    the CPU); 1 worker initialises nothing and ``build_mesh`` gives it a
    one-rank group."""
    got = process_group.launch(mesh_workers.bootstrap_worker, world,
                               (dict(platform="cpu"),), timeout_s=120.0)
    for rank, w in enumerate(got):
        assert w["initialised_by_init"] == (world > 1)
        assert w["backend"] == "gloo" and w["world"] == world
        assert w["ranks_seen"] == list(range(world))
        ctx = w["context"]
        assert (ctx["process_id"], ctx["num_processes"],
                ctx["local_rank"]) == (rank, world, rank)
        assert ctx["coordinator_addr"].startswith("127.0.0.1:")
