"""The port's sharding clients and elastic sampler against the JAX
package's, on the CPU.

The same scripted lease sequences go through both packages' clients, each
against its own package's in-process servicer: ``ShardingClient``,
``SPMDShardingClient`` (a leader and a follower replaying the leader's
stream through the KV store) and ``IndexShardingClient`` must give the
reference's shard and record sequences; the shard-checkpoint strings taken
at the same point must be byte-equal, and each restores into the other
package's master with the same next leases.  ``ElasticDistributedSampler``
must yield the reference's indices for the same seed, epoch, rank and
world, and a ``state_dict`` of either loads into the other (with a changed
``num_replicas``) to yield the same indices; ``ElasticDataLoader`` picks up
the same batch-size suggestion."""

import json

import pytest

from dlrover_tpu.agent import master_client as jmc
from dlrover_tpu.agent import sharding as jsharding
from dlrover_tpu.master import servicer as jservicer
from dlrover_tpu.trainer.elastic import sampler as jsampler
from dlrover_tpu_torch.agent import master_client as pmc
from dlrover_tpu_torch.agent import sharding as psharding
from dlrover_tpu_torch.master import servicer as pservicer
from dlrover_tpu_torch.trainer.elastic import sampler as psampler

PACKAGES = {
    "port": (pservicer, pmc, psharding),
    "ref": (jservicer, jmc, jsharding),
}


@pytest.fixture(autouse=True)
def _one_lease_per_envelope(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_SHARD_LEASE_BATCH", "1")


def _client(pkg, servicer=None, node_id=0):
    servicer_mod, mc, _ = PACKAGES[pkg]
    servicer = servicer or servicer_mod.MasterServicer()
    return servicer, mc.LocalMasterClient(servicer, node_id)


def _drain(client, batch_size=0, limit=100):
    """Lease every shard; report each done at once, or with
    ``batch_size``, a batch at a time (``report_batch_done``: the client
    completes a shard once its batches are reported)."""
    out = []
    for _ in range(limit):
        shard = client.fetch_shard()
        if shard is None:
            return out
        out.append((shard.name, shard.start, shard.end,
                    list(shard.record_indices)))
        if not batch_size:
            client.report_shard_done()
            continue
        for _ in range(-(-(shard.end - shard.start) // batch_size)):
            client.report_batch_done()
    raise AssertionError("dataset never finished")


SHARDING_CASES = {
    "even": dict(batch_size=4, num_epochs=1, dataset_size=32,
                 num_minibatches_per_shard=2),
    "ragged": dict(batch_size=3, num_epochs=1, dataset_size=20,
                   num_minibatches_per_shard=2),
    "two_epochs": dict(batch_size=2, num_epochs=2, dataset_size=10,
                       num_minibatches_per_shard=1),
    "shuffled": dict(batch_size=2, num_epochs=2, dataset_size=12,
                     num_minibatches_per_shard=2, shuffle=True),
}


def _sharding_run(pkg, kwargs, by_batch):
    _, _, sharding = PACKAGES[pkg]
    _, client = _client(pkg)
    sc = sharding.ShardingClient(dataset_name="ds", client=client, **kwargs)
    shards = _drain(sc, kwargs["batch_size"] if by_batch else 0)
    return shards, sc.get_current_epoch(), sc.get_shard_checkpoint()


@pytest.mark.parametrize("report", ["shard", "batch"])
@pytest.mark.parametrize("case", sorted(SHARDING_CASES))
def test_sharding_client_sequence_matches(case, report):
    by_batch = report == "batch"
    port = _sharding_run("port", SHARDING_CASES[case], by_batch)
    ref = _sharding_run("ref", SHARDING_CASES[case], by_batch)
    assert port == ref
    assert port[0]


def _spmd_run(pkg, n_followers=1):
    servicer_mod, mc, sharding = PACKAGES[pkg]
    servicer = servicer_mod.MasterServicer()
    leader = sharding.SPMDShardingClient(
        dataset_name="pretrain", batch_size=8, num_epochs=1,
        dataset_size=64, process_id=0,
        client=mc.LocalMasterClient(servicer, 0), session="s")
    followers = [sharding.SPMDShardingClient(
        dataset_name="pretrain", batch_size=8, num_epochs=1,
        dataset_size=64, process_id=i + 1,
        client=mc.LocalMasterClient(servicer, i + 1), session="s",
        fetch_timeout=5.0) for i in range(n_followers)]
    streams = [[] for _ in range(1 + n_followers)]
    checkpoints = []
    while True:
        shards = [c.fetch_shard() for c in [leader] + followers]
        for stream, shard in zip(streams, shards):
            stream.append(None if shard is None
                          else (shard.name, shard.start, shard.end))
        if shards[0] is None:
            break
        for c in [leader] + followers:
            for _ in range((shards[0].end - shards[0].start) // 8):
                c.report_batch_done()
        checkpoints.append(leader.get_shard_checkpoint())
    return streams, checkpoints, [f.get_shard_checkpoint()
                                  for f in followers]


def test_spmd_sharding_client_streams_match():
    port, ref = _spmd_run("port", 2), _spmd_run("ref", 2)
    assert port[0] == ref[0]
    # every process replays the leader's stream, end of data included
    assert all(stream == port[0][0] for stream in port[0])
    assert port[0][0][-1] is None and len(port[0][0]) == 5
    assert port[1] == ref[1]
    # followers hold no position of their own
    assert port[2] == ref[2] == ["", ""]


def test_spmd_follower_times_out_without_a_leader():
    for pkg in PACKAGES:
        servicer_mod, mc, sharding = PACKAGES[pkg]
        follower = sharding.SPMDShardingClient(
            dataset_name="d", batch_size=1, num_epochs=1, dataset_size=1,
            process_id=1,
            client=mc.LocalMasterClient(servicer_mod.MasterServicer(), 1),
            session="x", fetch_timeout=0.2)
        with pytest.raises(TimeoutError, match="never arrived"):
            follower.fetch_shard()


@pytest.mark.parametrize("shuffle", [False, True])
def test_index_sharding_client_records_match(shuffle):
    out = {}
    for pkg in PACKAGES:
        _, _, sharding = PACKAGES[pkg]
        _, client = _client(pkg)
        sc = sharding.IndexShardingClient(
            dataset_name="idx", batch_size=2, num_epochs=1,
            dataset_size=12, client=client, shuffle=shuffle,
            num_minibatches_per_shard=2)
        records = []
        while True:
            index = sc.fetch_record_index()
            if index is None:
                break
            records.append(index)
            if len(records) % 4 == 0:
                sc.report_shard_done()
        out[pkg] = records
    assert out["port"] == out["ref"]
    assert sorted(out["port"]) == list(range(12))


def _consume(sc, shards):
    got = []
    for _ in range(shards):
        shard = sc.fetch_shard()
        got.append((shard.start, shard.end))
        sc.report_shard_done()
    return got


@pytest.mark.parametrize("src,dst", [("port", "ref"), ("ref", "port")])
def test_shard_checkpoint_restores_across_packages(src, dst):
    kwargs = dict(batch_size=4, num_epochs=2, dataset_size=40,
                  num_minibatches_per_shard=1, shuffle=True)
    # the source job consumes 7 shards (the second epoch started) and
    # takes its position; one more lease is in flight when it is taken
    _, src_client = _client(src)
    src_sc = PACKAGES[src][2].ShardingClient(
        dataset_name="ds", client=src_client, **kwargs)
    _consume(src_sc, 7)
    in_flight = src_sc.fetch_shard()
    content = src_sc.get_shard_checkpoint()
    # the same script on the destination package gives the same string
    _, twin_client = _client(dst)
    twin = PACKAGES[dst][2].ShardingClient(
        dataset_name="ds", client=twin_client, **kwargs)
    _consume(twin, 7)
    twin.fetch_shard()
    assert twin.get_shard_checkpoint() == content
    json.loads(content)
    # a fresh destination master restores the source's position: its
    # next leases are the source's (the in-flight shard replayed first)
    _, dst_client = _client(dst)
    dst_sc = PACKAGES[dst][2].ShardingClient(
        dataset_name="ds", client=dst_client, **kwargs)
    assert dst_sc.restore_shard_from_checkpoint(content)
    src_sc.report_shard_done()
    want = [(in_flight.start, in_flight.end)] + _drain_ranges(src_sc)
    assert _drain_ranges(dst_sc) == want
    assert dst_sc.get_current_epoch() == src_sc.get_current_epoch() == 2


def _drain_ranges(sc):
    return [(s[1], s[2]) for s in _drain(sc)]


# -- the sampler ----------------------------------------------------------


SAMPLER_CASES = [
    dict(dataset_size=17, num_replicas=1, rank=0, shuffle=False),
    dict(dataset_size=17, num_replicas=4, rank=3, shuffle=True, seed=5),
    dict(dataset_size=16, num_replicas=3, rank=1, shuffle=True, seed=1,
         drop_last=True),
    dict(dataset_size=9, num_replicas=2, rank=0, shuffle=True, seed=0),
]


@pytest.mark.parametrize("case", range(len(SAMPLER_CASES)))
def test_sampler_indices_and_state_match(case):
    kwargs = SAMPLER_CASES[case]
    port = psampler.ElasticDistributedSampler(**kwargs)
    ref = jsampler.ElasticDistributedSampler(**kwargs)
    for epoch in range(3):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert len(port) == len(ref)
        assert list(port) == list(ref)
        assert port.state_dict() == ref.state_dict()
    port.record_batch(5)
    ref.record_batch(5)
    assert port.state_dict() == ref.state_dict()


@pytest.mark.parametrize("src,dst", [("port", "ref"), ("ref", "port")])
def test_sampler_state_dict_crosses_packages(src, dst):
    mods = {"port": psampler, "ref": jsampler}
    source = mods[src].ElasticDistributedSampler(
        dataset_size=50, num_replicas=4, rank=2, shuffle=True, seed=3)
    source.set_epoch(1)
    it = iter(source)
    for _ in range(5):
        next(it)
    state = source.state_dict()
    # a rescaled job (3 replicas) continues where the old one stopped
    want = []
    for rank in range(3):
        ref = mods[src].ElasticDistributedSampler(
            dataset_size=50, num_replicas=3, rank=rank)
        ref.load_state_dict(state, num_replicas=3, rank=rank)
        want.append(list(ref))
    for rank in range(3):
        target = mods[dst].ElasticDistributedSampler(
            dataset_size=50, num_replicas=4, rank=0)
        target.load_state_dict(state, num_replicas=3, rank=rank)
        assert list(target) == want[rank]
        assert target.state_dict()["completed_global"] == 50
    # between them the ranks cover the rest of the epoch exactly once
    rest = sorted(i for indices in want for i in indices)
    assert len(rest) == 50 - state["completed_global"]
    assert len(set(rest)) == len(rest)


def test_sampler_refuses_rank_outside_world():
    for mod in (psampler, jsampler):
        with pytest.raises(ValueError, match="num_replicas"):
            mod.ElasticDistributedSampler(dataset_size=4, num_replicas=2,
                                          rank=2)


def test_data_loader_batches_and_batch_size_suggestion(tmp_path):
    config = tmp_path / "paral.json"
    got = {}
    for name, mod in (("port", psampler), ("ref", jsampler)):
        config.write_text(json.dumps({}))
        sampler = mod.ElasticDistributedSampler(dataset_size=10,
                                                shuffle=True, seed=2)
        loader = mod.ElasticDataLoader(lambda idx: list(idx), sampler,
                                       batch_size=4,
                                       config_path=str(config))
        first = list(loader)
        config.write_text(json.dumps(
            {"dataloader": {"version": 1, "batch_size": 3}}))
        sampler.set_epoch(1)
        second = list(loader)
        got[name] = (first, second, loader.batch_size)
    assert got["port"] == got["ref"]
    assert [len(b) for b in got["port"][0]] == [4, 4, 2]
    assert got["port"][2] == 3
