"""The port's job runtime (the launcher, the local master, the elastic
agent and the master client) held to the JAX package's, in process.

- Wire: the two message registries hold the same classes and fields; a
  seeded instance of every message serialises to the same bytes in both
  packages, and each package decodes the other's.
- Rendezvous: both packages' training and network-check rendezvous
  managers, fed one seeded sequence of joins (1-8 nodes, node_unit 1 and
  2, slice ids, a late joiner, a lost node), give the same worlds, rounds
  and waiting counts.
- Servicer: one seeded script of messages (join, comm world, the KV
  store, a heartbeat carrying the digest the port's Trainer wrote, node
  events, pre-check, data shards, global step, a failure, succeeded)
  through both packages' servicers gives replies equal as JSON.
- Diagnosis: NodeFailureDiagnostician on every crash signature and exit
  code with 0, 1 and 3 restarts left, and TrainingHangDiagnostician on
  the same perf-monitor and device feeds, give the same actions.
- Cross-transport: each package's HTTP and gRPC client against the other
  package's server.
- Launcher and agent: ``parse_args`` on the same argv lists, the worker
  environment (``PYTHONPATH`` and the platform aside) and the heartbeat
  digest merged from the same rank files.

The process singletons (``Context``, the job context, the master client)
of both packages are reset around every test.
"""

import dataclasses
import json
import os
import time
import typing

import numpy as np
import pytest

import dlrover_tpu.agent.elastic_agent as j_agent
import dlrover_tpu.agent.master_client as j_client
import dlrover_tpu.common.comm as j_comm
import dlrover_tpu.common.constants as j_const
import dlrover_tpu.common.global_context as j_gctx
import dlrover_tpu.common.serialize as j_ser
import dlrover_tpu.diagnosis.diagnostician as j_diag
import dlrover_tpu.diagnosis.diagnosticians as j_diags
import dlrover_tpu.master.job_context as j_jctx
import dlrover_tpu.master.local_master as j_local
import dlrover_tpu.master.master_service as j_service
import dlrover_tpu.master.metric_context as j_metric
import dlrover_tpu.master.perf_monitor as j_perf
import dlrover_tpu.master.rdzv_manager as j_rdzv
import dlrover_tpu.master.servicer as j_servicer
import dlrover_tpu.trainer.elastic_run as j_run
import dlrover_tpu_torch.agent.elastic_agent as p_agent
import dlrover_tpu_torch.agent.master_client as p_client
import dlrover_tpu_torch.common.comm as p_comm
import dlrover_tpu_torch.common.constants as p_const
import dlrover_tpu_torch.common.global_context as p_gctx
import dlrover_tpu_torch.common.serialize as p_ser
import dlrover_tpu_torch.diagnosis.diagnostician as p_diag
import dlrover_tpu_torch.diagnosis.diagnosticians as p_diags
import dlrover_tpu_torch.master.job_context as p_jctx
import dlrover_tpu_torch.master.local_master as p_local
import dlrover_tpu_torch.master.master_service as p_service
import dlrover_tpu_torch.master.metric_context as p_metric
import dlrover_tpu_torch.master.perf_monitor as p_perf
import dlrover_tpu_torch.master.rdzv_manager as p_rdzv
import dlrover_tpu_torch.master.servicer as p_servicer
import dlrover_tpu_torch.trainer.elastic_run as p_run

# the two packages, module by module
J = dict(comm=j_comm, ser=j_ser, const=j_const, rdzv=j_rdzv,
         servicer=j_servicer, local=j_local, diag=j_diag, diags=j_diags,
         perf=j_perf, metric=j_metric, service=j_service, client=j_client,
         agent=j_agent, run=j_run)
P = dict(comm=p_comm, ser=p_ser, const=p_const, rdzv=p_rdzv,
         servicer=p_servicer, local=p_local, diag=p_diag, diags=p_diags,
         perf=p_perf, metric=p_metric, service=p_service, client=p_client,
         agent=p_agent, run=p_run)
PACKAGES = (J, P)


def _reset_singletons():
    for gctx, jctx, client in ((j_gctx, j_jctx, j_client),
                               (p_gctx, p_jctx, p_client)):
        gctx.Context.reset()
        jctx.JobContext.reset()
        client.MasterClient.reset_singleton()


@pytest.fixture(autouse=True)
def fresh_singletons():
    _reset_singletons()
    yield
    _reset_singletons()


# ---------------------------------------------------------------------------
# Wire
# ---------------------------------------------------------------------------

REGISTRY_NAMES = sorted(j_ser._MESSAGE_REGISTRY)


def _fields(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING
             else repr(f.default_factory()))
            for f in dataclasses.fields(cls)]


def test_registries_hold_the_same_messages():
    assert sorted(p_ser._MESSAGE_REGISTRY) == REGISTRY_NAMES
    assert len(REGISTRY_NAMES) > 50
    for name in REGISTRY_NAMES:
        assert (_fields(p_ser._MESSAGE_REGISTRY[name])
                == _fields(j_ser._MESSAGE_REGISTRY[name])), name


def _value(hint, rng, pkg):
    """A seeded value of the field type ``hint``, nested messages made of
    ``pkg``'s classes (the same draws for both packages)."""
    origin = typing.get_origin(hint)
    args = typing.get_args(hint)
    if hint is bool:
        return bool(rng.integers(2))
    if hint is int:
        return int(rng.integers(-1000, 1000))
    if hint is float:
        return float(np.round(rng.normal() * 100, 6))
    if hint is str:
        return f"s{int(rng.integers(10**6))}"
    if hint is bytes:
        return rng.bytes(int(rng.integers(1, 9)))
    if origin in (list, typing.List):
        if args[0] is typing.Any:
            return [{"action": "restart_worker",
                     "node_id": int(rng.integers(8))}]
        return [_value(args[0], rng, pkg) for _ in range(2)]
    if origin in (dict, typing.Dict):
        return {_value(args[0], rng, pkg): _value(args[1], rng, pkg)
                for _ in range(2)}
    if dataclasses.is_dataclass(hint):
        return _message(hint.__name__, rng, pkg)
    raise TypeError(f"no seeded value for {hint}")


def _message(name, rng, pkg):
    cls = pkg["ser"]._MESSAGE_REGISTRY[name]
    hints = typing.get_type_hints(cls)
    return cls(**{f.name: _value(hints[f.name], rng, pkg)
                  for f in dataclasses.fields(cls)})


@pytest.mark.parametrize("name", REGISTRY_NAMES)
def test_message_bytes_equal_and_cross_decode(name):
    seed = sum(map(ord, name))
    ref = _message(name, np.random.default_rng(seed), J)
    port = _message(name, np.random.default_rng(seed), P)
    ref_bytes, port_bytes = ref.to_json(), port.to_json()
    assert port_bytes == ref_bytes
    decoded = p_ser.deserialize_message(ref_bytes)
    assert type(decoded) is p_ser._MESSAGE_REGISTRY[name]
    assert decoded == port and decoded.to_json() == ref_bytes
    back = j_ser.deserialize_message(port_bytes)
    assert type(back) is j_ser._MESSAGE_REGISTRY[name]
    assert back == ref


def test_envelope_carries_a_payload_across_packages():
    rng = np.random.default_rng(3)
    payload = _message("HeartBeat", rng, P)
    envelope = p_comm.Message(node_type="worker", node_id=2).pack(payload)
    ref = j_comm.Message.from_json(envelope.to_json())
    assert ref.unpack() == _message("HeartBeat", np.random.default_rng(3), J)


# ---------------------------------------------------------------------------
# Rendezvous
# ---------------------------------------------------------------------------


def _world(world):
    return {int(rank): (m.node_id, m.node_rank, m.process_unit, m.addr,
                        m.slice_id) for rank, m in world.items()}


def _rdzv_script(seed):
    """A seeded sequence of rendezvous operations: parameters, joins in a
    shuffled order (slices, node_unit), probes after each join, then a
    late joiner and a lost node."""
    rng = np.random.default_rng(seed)
    nodes = int(rng.integers(1, 9))
    unit = int(rng.choice([1, 2]))
    slices = int(rng.integers(1, 3))
    # a round seals at max_nodes joined, or at min_nodes (whole units
    # and slices) when a probe finds them waiting
    ops = [("params", unit, nodes, 0.0, unit)]
    ops += [("alive", n) for n in range(nodes)]
    order = rng.permutation(nodes)
    for n in order:
        n = int(n)
        ops.append(("join", n, n, int(rng.integers(1, 3)), f"10.0.0.{n}",
                    n % slices, unit))
        if rng.random() < 0.3:
            ops.append(("probe", n))
    ops += [("probe", n) for n in range(nodes)] + [("waiting",)]
    late = nodes
    ops += [("alive", late), ("join", late, late, 1, "10.0.1.1", 0, unit),
            ("waiting",), ("probe", late)]
    if nodes > 1:
        lost = int(order[0])
        ops += [("lost", lost), ("waiting",)]
        for n in range(nodes + 1):
            if n != lost:
                ops += [("join", n, n, 1, f"10.0.2.{n}", n % slices, unit)]
        ops += [("probe", n) for n in range(nodes + 1)] + [("waiting",)]
    return ops


def _drive_rdzv(manager, ops, network_check=False):
    seen = []
    for op in ops:
        kind = op[0]
        if kind == "params":
            manager.update_rdzv_params(min_nodes=op[1], max_nodes=op[2],
                                       waiting_timeout=op[3],
                                       node_unit=op[4])
        elif kind == "alive":
            manager.add_alive_node(op[1])
        elif kind == "lost":
            manager.remove_alive_node(op[1])
        elif kind == "join":
            seen.append(("join", manager.join_rendezvous(
                op[1], op[2], op[3], node_ip=op[4], slice_id=op[5],
                node_unit=op[6])))
        elif kind == "probe":
            round_, group, world = manager.get_comm_world(op[1])
            seen.append(("probe", round_, group, _world(world)))
            if network_check and world:
                # each probed member reports; odd node ids look slow
                manager.report_network_check_result(
                    op[1], op[1] != 3, 1.0 + (op[1] % 2) * 5.0)
        elif kind == "waiting":
            seen.append(("waiting", manager.num_nodes_waiting(),
                         manager.rdzv_round))
    if network_check:
        seen.append(("fault", manager.check_fault_node()))
        seen.append(("straggler", manager.get_straggler()))
        seen.append(("success", manager.network_check_success()))
    return seen


@pytest.mark.parametrize("seed", range(10))
@pytest.mark.parametrize("kind", ["training", "network_check"])
def test_rendezvous_managers_agree(kind, seed):
    ops = _rdzv_script(seed)
    results = []
    for pkg in PACKAGES:
        cls = (pkg["rdzv"].ElasticTrainingRendezvousManager
               if kind == "training"
               else pkg["rdzv"].NetworkCheckRendezvousManager)
        results.append(_drive_rdzv(cls(), ops, kind == "network_check"))
    assert results[1] == results[0]
    assert any(step[0] == "probe" and step[3] for step in results[0])


# ---------------------------------------------------------------------------
# Servicer
# ---------------------------------------------------------------------------

# reply fields that carry a wall-clock time, left out of the comparison
WALL_CLOCK_FIELDS = ("timestamp", "ts", "elapsed_time")


def _strip_wall_clock(value):
    if isinstance(value, dict):
        return {k: _strip_wall_clock(v) for k, v in value.items()
                if k not in WALL_CLOCK_FIELDS}
    if isinstance(value, list):
        return [_strip_wall_clock(v) for v in value]
    return value


def _reply_json(reply):
    outer = json.loads(reply.to_json())
    inner = json.loads(reply.data)
    outer.pop("data")
    return _strip_wall_clock({"envelope": outer, "payload": inner})


def _make_servicer(pkg):
    training = pkg["rdzv"].ElasticTrainingRendezvousManager()
    check = pkg["rdzv"].NetworkCheckRendezvousManager()
    for manager in (training, check):
        manager.update_rdzv_params(min_nodes=2, max_nodes=2,
                                   waiting_timeout=0.0, node_unit=1)
        for node in (0, 1):
            manager.add_alive_node(node)
    names = pkg["const"].RendezvousName
    job_manager = pkg["local"].LocalJobManager()
    for node in (0, 1):
        job_manager.add_node(node)
    return pkg["servicer"].MasterServicer(
        rdzv_managers={names.TRAINING: training, names.NETWORK_CHECK: check},
        job_manager=job_manager,
        diagnosis_manager=pkg["diag"].DiagnosisManager(),
    )


@pytest.fixture(scope="module")
def trainer_digest(tmp_path_factory):
    """The runtime digest the port's Trainer wrote (a tiny Llama, 3 steps
    on the CPU, a digest every step), as a heartbeat carries it."""
    from dlrover_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from dlrover_tpu_torch.trainer import optim
    from dlrover_tpu_torch.trainer.train import Trainer

    path = str(tmp_path_factory.mktemp("digest") / "runtime_metrics.json")
    knobs = {"DLROVER_TPU_RUNTIME_METRICS_PATH": path,
             "DLROVER_TPU_DIGEST_EVERY": "1"}
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        cfg = LlamaConfig.tiny()
        model = LlamaForCausalLM(cfg, device="cpu", seed=0)
        trainer = Trainer(model, optim.adamw(lambda count: 1e-3),
                          device="cpu")
        state = trainer.create_state()
        ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 17))
        batch = {"input_ids": ids[:, :-1].astype(np.int32),
                 "labels": ids[:, 1:].astype(np.int32)}
        for _ in range(3):
            state, _ = trainer.train_step(state, batch)
        with open(path + ".rank0") as f:
            digest = json.load(f)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {k: float(v) for k, v in digest.items()}


def _servicer_script(digest):
    """(method, node id, message name, fields) of the seeded script."""
    const = p_const
    rng = np.random.default_rng(11)
    script = [
        ("report", 0, "NodeEventRequest",
         dict(node_id=0, node_type="worker",
              event_type=const.NodeEventType.ADDED, reason="connected")),
        ("report", 1, "NodeEventRequest",
         dict(node_id=1, node_type="worker",
              event_type=const.NodeEventType.ADDED, reason="connected")),
        ("get", 0, "PreCheckRequest", dict(node_id=0)),
        ("get", 0, "JoinRendezvousRequest",
         dict(node_id=0, node_rank=0, local_world_size=2,
              node_ip="127.0.0.1", rdzv_name=const.RendezvousName.TRAINING)),
        ("get", 0, "CommWorldRequest",
         dict(rdzv_name=const.RendezvousName.TRAINING, node_id=0)),
        ("get", 0, "WaitingNodeNumRequest",
         dict(node_id=0, rdzv_name=const.RendezvousName.TRAINING)),
        ("get", 1, "JoinRendezvousRequest",
         dict(node_id=1, node_rank=1, local_world_size=2,
              node_ip="127.0.0.2", rdzv_name=const.RendezvousName.TRAINING)),
        ("get", 0, "RdzvWaitRequest",
         dict(rdzv_name=const.RendezvousName.TRAINING, node_id=0,
              timeout=1.0)),
        ("get", 1, "CommWorldRequest",
         dict(rdzv_name=const.RendezvousName.TRAINING, node_id=1)),
        ("report", 0, "KeyValuePair",
         dict(key="jax/coordinator/1", value=b"127.0.0.1:4242")),
        ("get", 1, "KVStoreGetRequest", dict(key="jax/coordinator/1")),
        ("get", 0, "KVStoreAddRequest", dict(key="barrier/n", amount=1)),
        ("get", 1, "KVStoreAddRequest", dict(key="barrier/n", amount=1)),
        ("get", 0, "KVStoreWaitRequest",
         dict(key="barrier/n", timeout=0.2, min_value=2)),
        ("get", 0, "KVStoreWaitRequest",
         dict(key="never", timeout=0.05, min_value=0)),
        ("report", 0, "KeyValuePairs",
         dict(kvs={"a": rng.bytes(5), "b": rng.bytes(3)})),
        ("get", 1, "KVStoreMultiGetRequest", dict(keys=["a", "b", "c"])),
        ("get", 0, "KVStorePutIndexedRequest",
         dict(key="idx", value=b"payload")),
        ("get", 0, "KVStoreDeleteRequest", dict(key="a")),
        ("get", 0, "HeartBeat",
         dict(node_id=0, timestamp=1.5e9, digest=dict(digest))),
        ("get", 1, "HeartBeat", dict(node_id=1, timestamp=1.5e9, digest={})),
        ("report", 0, "DatasetShardParams",
         dict(batch_size=4, dataset_size=64, dataset_name="train",
              num_epochs=1, shuffle=False, num_minibatches_per_shard=2,
              task_type="training", storage_type="", splitter="batch")),
        ("get", 0, "TaskRequest", dict(dataset_name="train")),
        ("get", 1, "TaskRequest", dict(dataset_name="train")),
        ("report", 0, "TaskResult",
         dict(dataset_name="train", task_id=0, err_message="")),
        ("get", 0, "TaskBatchRequest",
         dict(dataset_name="train", count=3, wait_timeout=0.0)),
        ("report", 0, "TaskResults",
         dict(dataset_name="train", task_ids=[2, 3], err_message="")),
        ("get", 0, "ShardCheckpointRequest", dict(dataset_name="train")),
        ("get", 0, "DatasetEpochRequest", dict(dataset_name="train")),
        ("report", 0, "GlobalStep",
         dict(timestamp=1.5e9 + 10, step=5, elapsed_time_per_step=0.25)),
        ("get", 0, "TrainingStatusRequest", dict()),
        ("report", 1, "NodeFailureRequest",
         dict(node_id=1, error_data="worker exit codes: {0: 17}",
              level=const.TrainingExceptionLevel.PROCESS_ERROR,
              restart_count=0)),
        ("get", 1, "HeartBeat", dict(node_id=1, timestamp=1.5e9, digest={})),
        ("get", 0, "NetworkReadyRequest", dict()),
        ("get", 0, "StragglerExistRequest", dict()),
        ("get", 0, "ElasticRunConfigRequest", dict()),
        ("get", 0, "ParallelConfigRequest", dict()),
        ("get", 0, "CkptCommitStatusRequest", dict(ckpt_dir="/x", step=3)),
        ("get", 0, "PeerAssignmentRequest",
         dict(scope="job", process_id=0, step=-1, group=[0, 1])),
        ("report", 0, "IncidentDumpReport",
         dict(incident_id="i1", node_id=0, payload="{}")),
        ("report", 0, "BrainActionAck",
         dict(job="j", node_id=0, action_ids=["a1"])),
        ("report", 0, "SucceededRequest",
         dict(node_id=0, node_type="worker")),
        ("report", 1, "SucceededRequest",
         dict(node_id=1, node_type="worker")),
        ("get", 0, "NodeCountRequest", dict()),
    ]
    return script


def _run_script(pkg, script):
    servicer = _make_servicer(pkg)
    comm = pkg["comm"]
    replies = []
    for method, node_id, name, fields in script:
        envelope = comm.Message(node_type="worker", node_id=node_id)
        envelope.pack(getattr(comm, name)(**fields))
        reply = getattr(servicer, method)(envelope)
        replies.append((name, _reply_json(reply)))
    digests = servicer.metric_context.latest_digests(1e9)
    return replies, {n: _strip_wall_clock(d) for n, d in digests.items()}


def test_servicers_answer_one_script_alike(trainer_digest):
    assert "last_step" in trainer_digest and "step_p50_s" in trainer_digest
    script = _servicer_script(trainer_digest)
    ref, port = (_run_script(pkg, script) for pkg in PACKAGES)
    for (name, want), (_, got) in zip(ref[0], port[0]):
        assert got == want, name
    assert port[1] == ref[1] and port[1][0]["last_step"] == \
        trainer_digest["last_step"]
    # the script ran what it means to: a world of 2, data, a failure
    replies = dict(ref[0])
    assert len(replies["RdzvWaitRequest"]["payload"]["world"]) == 2
    assert replies["TaskRequest"]["payload"]["shard"]["end"] > 0


# ---------------------------------------------------------------------------
# Diagnosis
# ---------------------------------------------------------------------------

# a log tail for each pattern of the crash-signature table, and the
# generic fallbacks
SIGNATURE_LOGS = (
    "ValueError: sharding mismatch between input and mesh",
    "x of size 7 does not evenly divide the mesh axis",
    "mesh axis shape mismatch: 'fsdp' not found",
    "pjit incompatible shardings",
    "received incompatible devices for jitted computation",
    "RESOURCE_EXHAUSTED: out of memory allocating 1.2G",
    "ran out of HBM memory",
    "OOM when allocating tensor",
    "allocation of 3 GiB exceeds device memory",
    "failed to connect to the coordinator at 10.0.0.1",
    "coordination service unavailable",
    "DEADLINE_EXCEEDED while waiting for barrier",
    "barrier timed out after 300s",
    "missed heartbeat from task 3",
    "PJRT client timed out",
    "libtpu fatal error",
    "tpu device error: halted",
    "slice 2 unreachable",
    "DATA_LOSS: corrupted",
    "torch.OutOfMemoryError: CUDA out of memory",
    "OOM",
    "Cannot allocate memory",
    "",
    "Traceback: KeyError: 'x'",
)
EXIT_CODES = ({0: 1}, {0: 17}, {0: -9}, {0: -15}, {0: None},
              {0: 0, 1: 1}, {0: 0})


@pytest.mark.parametrize("log", SIGNATURE_LOGS)
def test_node_failure_diagnosticians_agree(log):
    for codes in EXIT_CODES:
        for left in (0, 1, 3):
            actions = []
            for pkg in PACKAGES:
                d = pkg["diags"].NodeFailureDiagnostician()
                observation = d.observe(exit_codes=dict(codes),
                                        error_log=log)
                action = d.resolve(observation, node_id=4,
                                   remaining_restarts=left)
                actions.append((observation.observed, observation.detail,
                                observation.extra, action.to_dict()))
            assert actions[1] == actions[0], (codes, left)


# the duty-cycle key of a chip sample (both packages' metric taxonomy)
DUTY_CYCLE = "duty_cycle_pct"
HANG_FEEDS = (
    # (step reports as seconds before now, device duty cycles per node
    # or None for no metric context, hang detection mode)
    ((), None, 1),
    ((-30.0, -20.0, -10.0), None, 1),
    ((-900.0, -800.0, -700.0), None, 1),
    ((-900.0, -800.0, -700.0), None, 0),
    ((-900.0, -800.0, -700.0), {0: 1.0, 1: 2.0}, 1),
    ((-900.0, -800.0, -700.0), {0: 90.0, 1: 95.0}, 1),
    ((-900.0, -800.0, -700.0), {0: 2.0, 1: 95.0}, 1),
)


@pytest.mark.parametrize("feed", range(len(HANG_FEEDS)))
def test_training_hang_diagnosticians_agree(feed, monkeypatch):
    steps, duty, mode = HANG_FEEDS[feed]
    now = time.time()
    actions = []
    for pkg, gctx in ((J, j_gctx), (P, p_gctx)):
        ctx = gctx.Context.singleton_instance()
        ctx.hang_detection = mode
        ctx.hang_downtime_secs = 300
        monitor = pkg["perf"].PerfMonitor()
        for i, dt in enumerate(steps):
            monitor.collect_global_step(i + 1, now + dt)
        metric = None
        if duty is not None:
            metric = pkg["metric"].JobMetricContext()
            for node, value in duty.items():
                metric.record_device(node, [{DUTY_CYCLE: value}] * 2)
        d = pkg["diags"].TrainingHangDiagnostician(monitor,
                                                   metric_context=metric)
        with monkeypatch.context() as m:
            m.setattr(time, "time", lambda: now)
            observation = d.observe()
            first = d.resolve(observation) if observation.observed else None
            second = d.resolve(observation) if observation.observed else None
        actions.append((observation.observed, observation.detail,
                        observation.extra,
                        first.to_dict() if first else None,
                        second.to_dict() if second else None))
    assert actions[1] == actions[0]


# ---------------------------------------------------------------------------
# Cross-transport
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transport", ["http", "grpc"])
@pytest.mark.parametrize("server_pkg,client_pkg", [("jax", "port"),
                                                   ("port", "jax")])
def test_client_talks_to_the_other_packages_server(transport, server_pkg,
                                                   client_pkg):
    if transport == "grpc":
        pytest.importorskip("grpc")
    server_mod = J if server_pkg == "jax" else P
    client_mod = J if client_pkg == "jax" else P
    servicer = _make_servicer(server_mod)
    server = server_mod["service"].create_master_service(0, servicer,
                                                         transport)
    server.start()
    try:
        addr = f"127.0.0.1:{server.port}"
        clients = [client_mod["client"].build_master_client(
            master_addr=addr, node_id=n, node_type="worker",
            service_type=transport) for n in (0, 1)]
        rdzv = client_mod["const"].RendezvousName.TRAINING
        rounds = [c.join_rendezvous(node_rank=n, node_ip=f"127.0.0.{n + 1}")
                  for n, c in enumerate(clients)]
        worlds = [c.wait_comm_world(rdzv, timeout=10.0) for c in clients]
        # a join answers the round it waits in; the round seals as 1
        assert rounds == [0, 0] and [w.round for w in worlds] == [1, 1]
        assert [_world(w.world) for w in worlds] == [
            {0: (0, 0, 1, "127.0.0.1", 0), 1: (1, 1, 1, "127.0.0.2", 0)}] * 2
        assert clients[0].kv_store_set("k", b"v")
        assert clients[1].kv_store_wait("k", timeout=5.0) == b"v"
        assert clients[1].kv_store_add("n", 2) == 2
        assert clients[0].kv_store_multi_get(["k", "x"]) == {"k": b"v",
                                                             "x": b""}
        assert clients[0].get_pre_check_result() == "pass"
        assert clients[0].report_heart_beat(digest={"last_step": 3.0}) == []
        assert clients[0].report_global_step(3, 0.5)
        assert clients[0].report_failure("exit 17", level="process_error")
        assert clients[0].report_succeeded()
        replies = clients[1].batch([
            client_mod["comm"].KVStoreGetRequest(key="k"),
            client_mod["comm"].KeyValuePair(key="z", value=b"1")])
        assert replies[0].value == b"v" and replies[1].success
        for c in clients:
            if hasattr(c, "close"):
                c.close()
    finally:
        server.stop()


def test_grpc_master_without_grpcio_raises(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_grpc(name, *args, **kwargs):
        if name == "grpc" or name.startswith("grpc."):
            raise ImportError("No module named 'grpc'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_grpc)
    servicer = _make_servicer(P)
    with pytest.raises(ImportError):
        p_service.create_master_service(0, servicer, "grpc")
    server = p_service.create_master_service(0, servicer, "http")
    server.start()
    server.stop()


# ---------------------------------------------------------------------------
# Launcher and agent
# ---------------------------------------------------------------------------

ARGVS = (
    ["--standalone", "train.py"],
    ["--standalone", "--nproc_per_node=2", "--platform=cpu", "-m",
     "pkg.mod", "/tmp/ckpt", "tiny"],
    ["--nnodes=2:4", "--max-restarts=5", "--monitor-interval", "0.5",
     "--rdzv-timeout=30", "--node-unit=2", "--log-dir", "/tmp/l",
     "--master-addr=h:1", "--node-rank=3", "train.py", "--lr", "1e-3"],
    ["--max_restarts", "0", "--exclude-straggler", "--network-check",
     "script.py"],
)


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a)[:40])
def test_parse_args_agree(argv):
    (j_ns, j_rest), (p_ns, p_rest) = (j_run.parse_args(list(argv)),
                                      p_run.parse_args(list(argv)))
    assert vars(p_ns) == vars(j_ns) and p_rest == j_rest


def test_launcher_refuses_what_the_port_lacks():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        p_run.main(["--standalone", "--network-check", "train.py"])
    with pytest.raises(ValueError, match="platform"):
        p_run.main(["--standalone", "--platform=tpu", "train.py"])
    from dlrover_tpu_torch.master import args as p_args
    from dlrover_tpu_torch.master import main as p_main

    # --enable_dashboard is served since the dashboard was ported
    # (tests/test_torch_dashboard.py)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        p_main.run(p_args.parse_master_args(["--platform", "k8s"]))


class _Client:
    """What the agent reads of its master client."""

    master_addr = "127.0.0.1:5000"
    node_id = 1


def _agents(config_kwargs):
    return [pkg["agent"].ElasticAgent(
        _Client(), pkg["agent"].ElasticLaunchConfig(**config_kwargs),
        node_rank=1) for pkg in PACKAGES]


@pytest.mark.parametrize("platform", ["", "cpu"])
def test_worker_env_agrees(platform):
    j_ag, p_ag = _agents(dict(nproc_per_node=2, platform=platform))
    envs = []
    for ag, comm in ((j_ag, j_comm), (p_ag, p_comm)):
        world = comm.CommWorld(
            rdzv_name="elastic-training", round=3,
            world={0: comm.NodeMeta(node_id=0, node_rank=0, addr="h0"),
                   1: comm.NodeMeta(node_id=1, node_rank=1, addr="h1")})
        ag._restart_count = 2
        envs.append(ag._worker_env(world, 1, 1, "h0:1234"))
    j_env, p_env = envs
    assert p_env["PYTHONPATH"].split(os.pathsep)[0] == os.path.dirname(
        os.path.dirname(os.path.abspath(p_agent.__file__))).rsplit(
        os.sep, 1)[0]
    for env in envs:
        env.pop("PYTHONPATH")
        env.pop("DLROVER_TPU_PLATFORM", None)
    assert p_env == j_env
    assert p_env["DLROVER_TPU_PROCESS_ID"] == "3"
    assert p_env["DLROVER_TPU_NUM_PROCESSES"] == "4"


def test_collect_digest_agrees(tmp_path, monkeypatch):
    from dlrover_tpu_torch.observability import commscope

    base = str(tmp_path / "runtime_metrics.json")
    monkeypatch.setenv("DLROVER_TPU_RUNTIME_METRICS_PATH", base)
    # the agents' own goodput ledgers run on each package's wall clock
    monkeypatch.setenv("DLROVER_TPU_GOODPUT_LEDGER", "0")
    rng = np.random.default_rng(5)
    now = time.time()
    for rank in range(3):
        digest = {
            "ts": now - rank, "last_step": float(40 + rank),
            "step_p50_s": float(rng.uniform(0.3, 0.5)),
            "step_max_s": float(rng.uniform(0.5, 0.9)),
            "gp_compute": float(rng.uniform(10, 20)),
            "gp_wall": float(rng.uniform(20, 30)),
            commscope.DIGEST_LAT + "dp": float(rng.uniform(100, 900)),
            commscope.DIGEST_BW + "dp": float(rng.uniform(0.1, 2.0)),
            "mem_used_b": float(rng.integers(1 << 30, 1 << 34)),
            "mem_limit_b": float(1 << 36),
            "mem_host_rss_b": float(rng.integers(1 << 28, 1 << 30)),
            "js_hits": float(rng.integers(0, 5)),
            "js_misses": float(rng.integers(0, 5)),
        }
        with open(f"{base}.rank{rank}", "w") as f:
            json.dump(digest, f)
    with open(f"{base}.rank9", "w") as f:  # stale: not evidence
        json.dump({"ts": now - 1e6, "last_step": 1.0}, f)
    j_ag, p_ag = _agents({})
    j_digest, p_digest = j_ag._collect_digest(), p_ag._collect_digest()
    assert p_digest == j_digest
    assert p_digest["ranks"] == 3.0 and p_digest["last_step"] == 40.0


def test_brain_verbs_without_their_items_warn(monkeypatch, tmp_path):
    """``brain_scale_plan`` with ``live_reshard`` stages the target axes
    through ``reshard.stage_reshard_request``: with no trainer in the
    agent's process, into the staging file the training processes poll,
    which ``reshard.staged_request()`` returns, as the reference agent
    stages it.  ``brain_demote`` still logs a warning naming item 6d, its
    ROADMAP item, and returns (the agent loop goes on)."""
    from dlrover_tpu.parallel import reshard as j_reshard
    from dlrover_tpu_torch.parallel import reshard

    monkeypatch.setenv("DLROVER_TPU_RUNTIME_METRICS_PATH",
                       str(tmp_path / "runtime_metrics.json"))
    reshard.register_reshard_target(None)
    j_reshard.register_reshard_target(None)
    warnings = []
    monkeypatch.setattr(p_agent.logger, "warning",
                        lambda msg, *args: warnings.append(msg % args))
    j_ag, agent = _agents({})
    agent._handle_live_reshard({"reason": "grow"},
                               {"live_reshard": True, "target_nodes": 4})
    req = reshard.staged_request()
    assert (req["seq"], req["axes"], req["reason"]) == (1, {"dp": 4}, "grow")
    # the reference agent stages the next request into the same file
    j_ag._handle_live_reshard({"reason": "shrink"},
                              {"live_reshard": True,
                               "mesh_axes": {"dp": 2}})
    req = reshard.staged_request()
    assert (req["seq"], req["axes"], req["reason"]) == (2, {"dp": 2},
                                                        "shrink")
    agent._handle_brain_demote({"reason": "slow dcn"})
    assert len(warnings) == 1
    assert "6d" in warnings[0] and "slow dcn" in warnings[0]