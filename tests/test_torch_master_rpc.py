"""The master's commit and peer-broker RPCs, found without injection
(the port's ``distributed.get_commit_client`` and
``peer_restore.default_client``), held to the JAX package's discovery.

* With a master configured (``DLROVER_TPU_MASTER_ADDR``), both packages
  commit over the master's RPC (``MasterCommitClient`` over
  ``MasterClient.singleton_instance()``), and the port's peer client is
  the master client itself; an injected client still comes first.
* The master comes before the world: 2 gloo ranks pick the world's store
  clients with no master, and the master's with one.
* With neither a master nor a world, a commit or a peer restore of
  several processes is refused, naming both; one process keeps its own
  coordinator and broker.
* A commit found this way seals through a real servicer over HTTP, and
  the two-host dist-commit smoke (``dist_commit_smoke``, two processes
  with no world) passes every check the reference's smoke has.
* The agent's peer endpoint serves its kernel build directory as the
  compile cache (``DLROVER_TPU_PEER_RESTORE=1``), as the reference's
  serves its cache, and registers it; with ``DLROVER_TPU_COMPILE_CACHE=off``
  it serves none.
"""

import json
import os
import urllib.request

import numpy as np
import pytest

import dlrover_tpu.agent.elastic_agent as j_agent
import dlrover_tpu.agent.master_client as j_client
import dlrover_tpu.common.global_context as j_gctx
import dlrover_tpu.master.job_context as j_jctx
import dlrover_tpu.trainer.flash_checkpoint.peer_restore as j_peer
import dlrover_tpu.trainer.flash_checkpoint.distributed as j_dist
import dlrover_tpu.trainer.flash_checkpoint.dist_commit_smoke as j_smoke
import dlrover_tpu_torch.agent.elastic_agent as p_agent
import dlrover_tpu_torch.agent.master_client as p_client
import dlrover_tpu_torch.common.global_context as p_gctx
import dlrover_tpu_torch.master.job_context as p_jctx
import dlrover_tpu_torch.trainer.flash_checkpoint.distributed as p_dist
import dlrover_tpu_torch.trainer.flash_checkpoint.dist_commit_smoke as p_smoke
from dlrover_tpu_torch.master.master_service import HttpMasterServer
from dlrover_tpu_torch.master.servicer import MasterServicer
from dlrover_tpu_torch.parallel import process_group
from dlrover_tpu_torch.trainer.flash_checkpoint import peer_restore
from torch_master_rpc_checks import discovery_worker

_SINGLETONS = (j_client.MasterClient, p_client.MasterClient)


def _reset():
    for cls in _SINGLETONS:
        cls.reset_singleton()
    for gctx, jctx in ((j_gctx, j_jctx), (p_gctx, p_jctx)):
        gctx.Context.reset()
        jctx.JobContext.reset()
    j_dist.set_commit_client(None)
    p_dist.set_commit_client(None)
    peer_restore.clear_context()
    j_peer.clear_context()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for key in ("DLROVER_TPU_MASTER_ADDR", "DLROVER_TPU_MASTER_SERVICE_TYPE",
                "DLROVER_TPU_NODE_ID"):
        monkeypatch.delenv(key, raising=False)
    _reset()
    yield
    _reset()


@pytest.fixture
def master(monkeypatch):
    """A real servicer behind an HTTP master, configured in the env."""
    servicer = MasterServicer()
    server = HttpMasterServer(0, servicer)
    server.start()
    monkeypatch.setenv("DLROVER_TPU_MASTER_ADDR", f"127.0.0.1:{server.port}")
    monkeypatch.setenv("DLROVER_TPU_MASTER_SERVICE_TYPE", "http")
    monkeypatch.setenv("DLROVER_TPU_NODE_ID", "0")
    yield servicer
    server.stop()


def test_both_packages_commit_over_the_configured_master(master):
    got = p_dist.get_commit_client(2)
    want = j_dist.get_commit_client()
    assert type(got).__name__ == type(want).__name__ == "MasterCommitClient"
    assert got.client is p_client.MasterClient.singleton_instance()
    assert isinstance(got.client, p_client.HttpMasterClient)


def test_the_peer_client_is_the_master_client(master):
    client = peer_restore.default_client(4)
    assert client is p_client.MasterClient.singleton_instance()
    # the broker's three calls reach the master's broker
    assert client.report_peer_announce("s", 3, "127.0.0.1:1",
                                       num_processes=2, process_id=1)
    donors = client.get_peer_assignment("s", process_id=0).donors
    assert {int(k): v for k, v in donors.items()} == {1: "127.0.0.1:1"}
    assert master.peer_broker.snapshot()["scopes"]["s"]


def test_an_injected_client_comes_before_the_master(master):
    local = p_dist.LocalCommitClient()
    p_dist.set_commit_client(local)
    assert p_dist.get_commit_client(2) is local


def test_without_master_or_world_several_processes_are_refused():
    for call in (lambda: p_dist.get_commit_client(2),
                 lambda: peer_restore.default_client(2)):
        with pytest.raises(NotImplementedError,
                           match="no master and no torch.distributed world"):
            call()
    assert isinstance(p_dist.get_commit_client(1), p_dist.LocalCommitClient)
    assert isinstance(peer_restore.default_client(1),
                      peer_restore.LocalPeerClient)
    # the reference keeps a process-local coordinator there
    assert isinstance(j_dist.get_commit_client(), j_dist.LocalCommitClient)


def test_the_master_comes_before_the_world(master, monkeypatch):
    # the ranks start with no master configured and set the address
    # themselves (discovery_worker)
    addr = os.environ["DLROVER_TPU_MASTER_ADDR"]
    monkeypatch.delenv("DLROVER_TPU_MASTER_ADDR")
    ranks = process_group.spawn(discovery_worker, 2, (addr,), device="cpu",
                                timeout_s=120)
    for rank in ranks:
        assert rank == {"world": "StoreCommitClient",
                        "world_peer": "StorePeerClient",
                        "master": "MasterCommitClient",
                        "master_peer": "HttpMasterClient"}


def test_a_discovered_commit_seals_through_the_master(master, tmp_path):
    import torch

    ckpt_dir = str(tmp_path / "ckpt")
    engine = p_dist.DistributedCheckpointEngine(ckpt_dir, process_id=0,
                                                num_processes=1)
    state = {"w": torch.arange(64, dtype=torch.float32)}
    stats = engine.save(3, state, wait_seal=True, timeout=30)
    assert stats["reported"] and stats["sealed"]
    assert master.ckpt_coordinator.committed_step(ckpt_dir) == 3
    assert isinstance(engine._client, p_dist.MasterCommitClient)


@pytest.fixture(scope="module")
def smokes():
    return p_smoke.run_smoke("cpu"), j_smoke.run_smoke()


def test_dist_commit_smoke_passes_every_reference_check(smokes):
    port, ref = smokes
    assert ref["ok"] and port["ok"], port["checks"]
    assert set(ref["checks"]) < set(port["checks"])
    assert port["checks"]["hosts_found_the_master_commit_rpc"]


@pytest.mark.parametrize("what", ["hosts", "diff"])
def test_dist_commit_smoke_writes_the_reference_bytes(smokes, what):
    """Each host's write stats (bytes written, reused and skipped, shard
    counts) are the reference's for the same state."""
    port, ref = smokes
    for host in ("0", "1"):
        for key in ("bytes_written", "bytes_reused", "shards_written",
                    "shards_reused", "shards_skipped_replica"):
            assert port[what][host][key] == ref[what][host][key], (host, key)


class _Client:
    """What the agent reads of its master client."""

    master_addr = "127.0.0.1:5000"
    node_id = 1


def _cache_list(endpoint):
    with urllib.request.urlopen(f"http://{endpoint.addr}/peer/cache_list",
                                timeout=30) as resp:
        return sorted(e["name"] for e in json.loads(resp.read())["entries"])


@pytest.mark.parametrize("cache", ["dir", "off"])
def test_agent_serves_its_kernel_directory(cache, tmp_path, monkeypatch):
    kernels = tmp_path / "kernels"
    kernels.mkdir()
    rng = np.random.default_rng(0)
    for name in ("libflash_attention_0a1b.so", "libring_reduce_scatter_2c3d.so"):
        (kernels / name).write_bytes(rng.bytes(512))
    monkeypatch.setenv("DLROVER_TPU_PEER_RESTORE", "1")
    monkeypatch.setenv("DLROVER_TPU_COMPILE_CACHE",
                       str(kernels) if cache == "dir" else "off")
    served = []
    for pkg in (j_agent, p_agent):
        agent = pkg.ElasticAgent(_Client(), pkg.ElasticLaunchConfig(),
                                 node_rank=1)
        agent._start_peer_serve()
        try:
            served.append(_cache_list(agent._peer_serve))
        finally:
            agent._peer_serve.stop()
    want = (["libflash_attention_0a1b.so", "libring_reduce_scatter_2c3d.so"]
            if cache == "dir" else [])
    assert served == [want, want]
    registered = peer_restore.get_context()["cache_dir"]
    assert registered == (str(kernels) if cache == "dir" else "")


class _VanishingStore:
    """A store whose key is deleted by another process right after a
    ``check`` saw it: a ``get`` then waits out the store's timeout."""

    def __init__(self):
        self.values = {"status/d/3": b'{"reported": 1, "expected": 2}'}

    def check(self, keys):
        found = all(k in self.values for k in keys)
        self.values.clear()  # the coordinator prunes right after
        return found

    def get(self, key):
        raise RuntimeError(f"Timeout waiting for key: {key}")

    def compare_set(self, key, expected, desired):
        return self.values.get(key, expected.encode())


def test_commit_status_reads_a_pruned_key_without_waiting():
    """Process 0 deletes a step's status key once the step is committed;
    a reader that checked the key before reading it waited out the
    store's timeout (300 s, which failed a card run), so the key is read
    in one atomic store operation; the same for the peer broker's
    announcements, which an eviction deletes."""
    client = p_dist.StoreCommitClient.__new__(p_dist.StoreCommitClient)
    client.store = _VanishingStore()
    status = client.commit_status("d", 3)
    assert status["reported"] == 1 and not status["sealed"]
    client.store = _VanishingStore()
    client.store.values.clear()
    assert client.commit_status("d", 3)["reported"] == 0
    peer = peer_restore.StorePeerClient.__new__(peer_restore.StorePeerClient)
    peer.store = _VanishingStore()
    peer.store.values = {"announce/s/1": b'{"step": 4}'}
    assert peer._get("announce/s/1") == {"step": 4}
    assert peer._get("announce/s/2") is None
