"""Per-host elastic agent: rendezvous, spawn, monitor, recover.

Copy of ``dlrover_tpu/agent/elastic_agent.py``, the counterpart of
DLRover's ``dlrover/python/elastic_agent/torch/training.py``
(``ElasticTrainingAgent:648``, ``_rendezvous:815``,
``_initialize_workers:1073``, ``_invoke_run:1247``,
``_restart_workers:1680``, ``launch_agent:1868``).

The master's comm world decides node ranks; the rank-0 agent picks a
coordinator port and publishes it via the master KV store; every spawned
worker process reads the rendezvous env in ``trainer/bootstrap.init`` and
joins ``torch.distributed`` there.  Elastic scale-up/down = agents notice
membership change and restart workers into a new rendezvous round.  The
flash-checkpoint saver lives here, so the last shm snapshot outlives a
crashed worker: the engine of a worker launched by this agent finds the
saver's queue and takes the agent side.

What differs from the copy: the worker's ``PYTHONPATH`` root is this
package's; the peer serve endpoint exports no compile cache (the port
compiles no step, ROADMAP item 7, the rest); the chaos point of the
heartbeat is a comment; and a ``brain_scale_plan`` with ``live_reshard``
or a ``brain_demote`` logs a warning and the loop goes on (the port has
neither the live reshard, ROADMAP item 6c, nor the hierarchy demotion,
item 6d).
"""

import os
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.common.constants import (
    NodeEnv,
    NodeEventType,
    RendezvousName,
    TrainingExceptionLevel,
)
from dlrover_tpu_torch.common.comm import CommWorld
from dlrover_tpu_torch.common.global_context import Context
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.training_event.emitter import (
    AgentEvents,
    get_default_emitter,
)
from dlrover_tpu_torch.utils.env_utils import find_free_port, get_host_ip


_TEE_CAP_BYTES = 4 << 20  # per-worker capture cap; diagnosis reads tails


def _pump_stream(src, console, log_file):
    """Tee a worker's stderr: stream through to the console AND keep a
    file copy for post-mortem log-tail diagnosis.  Runs until EOF (the
    worker exited); closes the file so the tail is flushed.  The file
    wraps at _TEE_CAP_BYTES (a chatty worker must not fill the temp
    filesystem; the diagnosis only ever reads the tail).  The pipe is
    ALWAYS drained to EOF — a failed file write (full tmpfs) must not
    stop reading, or the worker blocks on a full 64KB pipe buffer and a
    logging problem becomes a training hang."""
    file_ok = True
    try:
        for line in iter(src.readline, b""):
            text = line.decode("utf-8", errors="replace")
            try:
                console.write(text)
                console.flush()
            except (OSError, ValueError):  # graftlint: disable=GL403 (console tee: the fallback log channel IS this stream; logging here would re-enter the dead fd)
                pass
            if not file_ok:
                continue
            try:
                if log_file.tell() > _TEE_CAP_BYTES:
                    log_file.seek(0)
                    log_file.truncate()
                    log_file.write("[... log wrapped at cap ...]\n")
                log_file.write(text)
                log_file.flush()
            except (OSError, ValueError):
                file_ok = False
    except (OSError, ValueError):
        pass
    finally:
        try:
            log_file.close()
        except OSError:
            pass


class WorkerStatus:
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"


class RunResult:
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    RESTART = "restart"


@dataclass
class ElasticLaunchConfig:
    """Launch configuration (reference ``ElasticLaunchConfig``
    training.py:274)."""

    min_nodes: int = 1
    max_nodes: int = 1
    nproc_per_node: int = 1
    max_restarts: int = 3
    monitor_interval: float = 2.0
    rdzv_timeout: float = 600.0
    network_check: bool = False
    exclude_straggler: bool = False
    node_unit: int = 1
    platform: str = ""  # "" (the card) or "cpu": the worker bootstrap
    entrypoint: str = ""
    args: List[str] = field(default_factory=list)
    run_module: bool = False
    log_dir: str = ""
    exit_barrier_timeout: float = 300.0


@dataclass
class WorkerProc:
    local_rank: int
    process_id: int
    proc: subprocess.Popen
    log_path: str = ""
    # the stderr tee thread (implicit-capture mode): joined before the
    # crash log tail is read, so the signature is never raced past
    pump: Optional[threading.Thread] = None


class ElasticAgent:
    def __init__(
        self,
        client: MasterClient,
        config: ElasticLaunchConfig,
        node_rank: int = 0,
    ):
        self._client = client
        self._config = config
        self._node_rank = node_rank
        self._node_ip = get_host_ip()
        self._workers: List[WorkerProc] = []
        self._restart_count = 0
        self._remaining_restarts = config.max_restarts
        self._stop_heartbeat = threading.Event()
        self._pending_actions: List[dict] = []
        self._actions_lock = threading.Lock()
        self._current_world: Optional[CommWorld] = None
        self._events = get_default_emitter("agent")
        self._peer_serve = None  # PeerServeEndpoint when peer restore is on
        self._last_peer_announce = -1

    # -- rendezvous --------------------------------------------------------

    def _rendezvous(self) -> CommWorld:
        """Join the master rendezvous and poll until a world including this
        node is published (reference ``_rendezvous`` training.py:815)."""
        ctx = Context.singleton_instance()
        from dlrover_tpu_torch.common import envs

        self._client.join_rendezvous(
            node_rank=self._node_rank,
            local_world_size=self._config.nproc_per_node,
            rdzv_name=RendezvousName.TRAINING,
            node_ip=self._node_ip,
            # this host's pod-slice index (DCN domain): the manager
            # keeps slices rank-contiguous and groups nodes per slice,
            # so multi-slice meshes cross DCN only between groups
            slice_id=envs.get_int("DLROVER_TPU_SLICE_ID"),
            node_unit=self._config.node_unit,
        )
        # long-poll: the master holds each probe until the round seals
        # (or the chunk expires), so convergence costs one RPC per
        # ~30s of waiting instead of one per second
        world = self._client.wait_comm_world(
            RendezvousName.TRAINING, timeout=self._config.rdzv_timeout
        )
        if world.world:
            ranks = {
                rank: meta.node_id for rank, meta in world.world.items()
            }
            logger.info(
                "rendezvous round %d done: node_ranks=%s", world.round, ranks
            )
            return world
        raise TimeoutError(
            f"rendezvous timed out after {self._config.rdzv_timeout}s"
        )

    def _my_rank_in(self, world: CommWorld) -> int:
        for rank, meta in world.world.items():
            if meta.node_id == self._client.node_id:
                return int(rank)
        return -1

    def _setup_coordinator(self, world: CommWorld, my_rank: int) -> str:
        """Rank-0 agent picks a free port and publishes the workers'
        coordinator address through the master KV store; everyone else
        waits for it.  The key is the reference's, so agents of both
        packages can share a master."""
        key = f"jax/coordinator/{world.round}"
        if my_rank == 0:
            port = find_free_port()
            host = world.world[0].addr or self._node_ip or "localhost"
            addr = f"{host}:{port}"
            self._client.kv_store_set(key, addr.encode())  # graftlint: disable=GL101 (coordinator handoff: rank 0 publishes, peers kv_store_wait below with a 120s bound)
            return addr
        addr = self._client.kv_store_wait(key, timeout=120.0)  # graftlint: disable=GL101 (bounded wait for the rank-0 coordinator publish; timeout raises instead of hanging)
        if not addr:
            raise TimeoutError("coordinator address never published")
        return addr.decode()

    # -- worker processes --------------------------------------------------

    def _worker_env(
        self, world: CommWorld, my_rank: int, local_rank: int,
        coordinator: str,
    ) -> Dict[str, str]:
        import dlrover_tpu_torch

        pkg_root = os.path.dirname(
            os.path.dirname(dlrover_tpu_torch.__file__))
        nproc = self._config.nproc_per_node
        num_nodes = len(world.world)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (pkg_root, env.get("PYTHONPATH", "")) if p
        )
        env.update(
            {
                NodeEnv.COORDINATOR_ADDR: coordinator,
                NodeEnv.PROCESS_ID: str(my_rank * nproc + local_rank),
                NodeEnv.NUM_PROCESSES: str(num_nodes * nproc),
                NodeEnv.NODE_RANK: str(my_rank),
                NodeEnv.NODE_ID: str(self._client.node_id),
                NodeEnv.NODE_NUM: str(num_nodes),
                NodeEnv.MASTER_ADDR: self._client.master_addr,
                "DLROVER_TPU_LOCAL_RANK": str(local_rank),
                "DLROVER_TPU_RESTART_COUNT": str(self._restart_count),
                "DLROVER_TPU_RDZV_ROUND": str(world.round),
            }
        )
        if self._config.platform:
            env["DLROVER_TPU_PLATFORM"] = self._config.platform
        return env

    def _start_workers(self, world: CommWorld):
        my_rank = self._my_rank_in(world)
        coordinator = self._setup_coordinator(world, my_rank)
        self._current_world = world
        cmd_base = [sys.executable]
        if self._config.run_module:
            cmd_base += ["-m", self._config.entrypoint]
        else:
            cmd_base += [self._config.entrypoint]
        cmd_base += list(self._config.args)
        for local_rank in range(self._config.nproc_per_node):
            env = self._worker_env(world, my_rank, local_rank, coordinator)
            stdout = stderr = None
            log_file = None
            tee_stderr = False
            if self._config.log_dir:
                log_root = self._config.log_dir
            else:
                # no log_dir configured: still capture stderr — the
                # crash-signature diagnosis (_read_worker_log_tail)
                # classifies failures from the log tail, and an empty
                # tail degrades every failure to "generic error".
                # stderr is tee'd so tracebacks keep streaming to the
                # console as before.
                log_root = self._implicit_log_root()
                tee_stderr = True
            os.makedirs(log_root, exist_ok=True)
            path = os.path.join(
                log_root,
                f"worker_{my_rank}_{local_rank}_r{self._restart_count}.log",
            )
            log_file = open(path, "w")
            if tee_stderr:
                stdout = None  # passthrough
                stderr = subprocess.PIPE
            else:
                stdout = log_file
                stderr = subprocess.STDOUT
            proc = subprocess.Popen(
                cmd_base, env=env, stdout=stdout, stderr=stderr
            )
            pump = None
            if tee_stderr:
                pump = threading.Thread(
                    target=_pump_stream,
                    args=(proc.stderr, sys.stderr, log_file),
                    daemon=True,
                    name=f"worker-stderr-{local_rank}",
                )
                pump.start()
            else:
                log_file.close()  # the child owns its copy of the fd
            self._workers.append(
                WorkerProc(
                    local_rank=local_rank,
                    process_id=my_rank * self._config.nproc_per_node + local_rank,
                    proc=proc,
                    log_path=path,
                    pump=pump,
                )
            )
        logger.info(
            "started %d worker process(es), node_rank=%d restart=%d",
            len(self._workers), my_rank, self._restart_count,
        )
        self._events.instant(
            AgentEvents.WORKER_START,
            {"workers": len(self._workers), "node_rank": my_rank,
             "restart": self._restart_count, "round": world.round},
        )

    def _stop_workers(self, grace: float = 10.0):
        for w in self._workers:
            if w.proc.poll() is None:
                w.proc.terminate()
        deadline = time.time() + grace
        for w in self._workers:
            remaining = max(0.1, deadline - time.time())
            try:
                w.proc.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                w.proc.kill()
                w.proc.wait()
        self._workers.clear()

    def _workers_status(self) -> str:
        codes = [w.proc.poll() for w in self._workers]
        if any(c is not None and c != 0 for c in codes):
            return WorkerStatus.FAILED
        if all(c == 0 for c in codes):
            return WorkerStatus.SUCCEEDED
        return WorkerStatus.RUNNING

    # -- heartbeat ---------------------------------------------------------

    def _heartbeat_loop(self):
        ctx = Context.singleton_instance()
        while not self._stop_heartbeat.wait(ctx.heartbeat_interval_secs):
            try:
                # chaos point "agent.heartbeat" (DROP/FLAP: swallowed;
                # ROADMAP item 7, the rest)
                actions = self._client.report_heart_beat(
                    digest=self._collect_digest()
                )
                if actions:
                    with self._actions_lock:
                        self._pending_actions.extend(actions)
                self._announce_peer_snapshot()
            except Exception as e:  # noqa: BLE001 - heartbeat best-effort
                logger.warning("heartbeat failed: %s", e)

    def _start_peer_serve(self) -> None:
        """Peer-restore serve endpoint: every agent exports its host's
        shm snapshot so a replacement host can pull the lost shards
        peer-to-peer instead of from storage.  Off unless
        ``DLROVER_TPU_PEER_RESTORE`` is set."""
        if not envs.get_bool("DLROVER_TPU_PEER_RESTORE"):
            return
        try:
            from dlrover_tpu_torch.trainer.flash_checkpoint.peer_restore import (
                PeerServeEndpoint,
                register_context,
            )

            self._peer_serve = PeerServeEndpoint(
                self._client.node_id).start()
            register_context(
                client=self._client, serve=self._peer_serve,
                process_id=self._client.node_id,
            )
        except Exception as e:  # noqa: BLE001 - the fast path is an
            # optimization; the storage restore still works without it
            logger.warning("peer serve endpoint not started: %s", e)
            self._peer_serve = None

    def _announce_peer_snapshot(self) -> None:
        """Heartbeat-rate announce: when the host's committed shm step
        advanced, tell the master's broker this host can now donate it."""
        serve = self._peer_serve
        if serve is None:
            return
        try:
            from dlrover_tpu_torch.common.multi_process import SharedMemoryBuffer
            from dlrover_tpu_torch.trainer.flash_checkpoint import snapshot
            from dlrover_tpu_torch.trainer.flash_checkpoint.engine import shm_name

            shm = SharedMemoryBuffer(
                shm_name(serve.process_id, serve.scope)
            )
            try:
                meta = snapshot.read_snapshot_meta(shm)
            finally:
                shm.close()
            step = int(meta["step"]) if meta else -1
            if step >= 0 and step != self._last_peer_announce:
                if self._client.report_peer_announce(
                    serve.scope, step, serve.addr,
                    process_id=serve.process_id,
                ):
                    self._last_peer_announce = step
        except Exception as e:  # noqa: BLE001 - announce is best-effort
            logger.warning("peer announce failed: %s", e)

    def _collect_digest(self) -> Dict[str, float]:
        """The per-host health digest every heartbeat carries
        (``comm.HeartBeat.digest``): the worst per-rank step-time digest
        among the files this host's workers drop
        (``ConfigPath.RUNTIME_METRICS``.rank<N>, written by
        ``Trainer.train_step`` from the flight recorder's step ring) +
        how long the checkpoint saver has been busy on one persist.
        ONE data source feeds the master's laggard screens and the
        straggler/ckpt-stall diagnosticians."""
        digest: Dict[str, float] = {}
        try:
            saver = getattr(self, "_ckpt_saver", None)
            if saver is not None:
                busy = saver.busy_seconds()
                if busy > 0:
                    digest["ckpt_busy_s"] = round(busy, 3)
            import glob
            import json

            from dlrover_tpu_torch.master.metric_context import DIGEST_FRESH_S

            base = envs.get_str("DLROVER_TPU_RUNTIME_METRICS_PATH")
            cutoff = time.time() - DIGEST_FRESH_S
            ranks = 0
            newest_rank_ts = 0.0
            for path in glob.glob(base + ".rank*"):
                try:
                    with open(path) as f:
                        rank_digest = json.load(f)
                except (OSError, ValueError):
                    continue
                if float(rank_digest.get("ts", 0.0)) < cutoff:
                    continue  # stale rank file: not evidence
                ranks += 1
                newest_rank_ts = max(
                    newest_rank_ts, float(rank_digest.get("ts", 0.0))
                )
                # worst rank on this host, per key: a synchronous job
                # runs at the slowest rank's pace, so durations take
                # max — but the step WATERMARK takes min (the wedged
                # rank has the LOWEST last_step; max would let a
                # healthy peer vouch for it on the laggard screen)
                for key in ("step_p50_s", "step_max_s"):
                    value = rank_digest.get(key)
                    if value is None:
                        continue
                    digest[key] = max(
                        digest.get(key, 0.0), float(value)
                    )
                # goodput ledger: cumulative per-phase seconds SUM
                # across ranks (the master differentiates the sums per
                # heartbeat; a restarted rank's counter reset shows as
                # a negative delta the store skips)
                for key, value in rank_digest.items():
                    if key.startswith("gp_"):
                        digest[key] = (
                            digest.get(key, 0.0) + float(value)
                        )
                # fabric model (comm observatory): the node is as
                # healthy as its slowest link, so latency merges MAX
                # and bandwidth merges MIN across this host's ranks
                from dlrover_tpu_torch.observability import commscope

                for key, value in rank_digest.items():
                    if key.startswith(commscope.DIGEST_LAT):
                        digest[key] = max(
                            digest.get(key, 0.0), float(value)
                        )
                    elif key.startswith(commscope.DIGEST_BW):
                        value = float(value)
                        digest[key] = (
                            value if key not in digest
                            else min(digest[key], value)
                        )
                # memory observatory: worst-chip semantics per key
                # (max used/peak/subsystems, min limit/headroom) with
                # host RSS SUMMED — each rank is its own process
                from dlrover_tpu_torch.observability import memscope

                memscope.merge_digest(digest, rank_digest)
                # compile observatory: counters SUM across ranks (node
                # totals; the hit ratio derives from the sums), the
                # event-ts/warm/cache markers take max
                from dlrover_tpu_torch.observability import jitscope

                jitscope.merge_digest(digest, rank_digest)
                step = rank_digest.get("last_step")
                if step is not None:
                    step = float(step)
                    digest["last_step"] = (
                        step if "last_step" not in digest
                        else min(digest["last_step"], step)
                    )
            if ranks:
                digest["ranks"] = float(ranks)
            # the agent process's own ledger (rendezvous windows, saver
            # persist stalls, overload ride-outs happen HERE, not in a
            # worker rank) joins the same cumulative account.  With
            # worker ranks reporting, only the agent's ATTRIBUTED
            # phases join (each with its seconds added to gp_wall too):
            # the agent's mostly-idle wall clock is not evidence the
            # JOB idled, and summing it whole would dilute the node's
            # goodput by ranks/(ranks+1).  With no rank files (a
            # non-training node, single-process drills) the agent's
            # full account IS the node's account.
            from dlrover_tpu_torch.observability import goodput

            if goodput.enabled():
                own = goodput.ledger().digest()
                if ranks:
                    attributed = 0.0
                    for key, value in own.items():
                        if key in ("gp_wall", f"gp_{goodput.IDLE}"):
                            continue
                        digest[key] = digest.get(key, 0.0) + float(value)
                        attributed += float(value)
                    if attributed:
                        digest["gp_wall"] = (
                            digest.get("gp_wall", 0.0) + attributed
                        )
                    # advance marker: the newest rank-file write.  The
                    # rank accounts only move every DIGEST_EVERY steps,
                    # so the master must differentiate across FILE
                    # advances, not heartbeats — else the heartbeats in
                    # between would plot agent-only deltas (a background
                    # persist as goodput 0 / ckpt share 1.0) and the
                    # real advance would look implausibly large against
                    # a one-heartbeat gap.
                    if newest_rank_ts > 0:
                        digest["gp_seq"] = newest_rank_ts
                else:
                    for key, value in own.items():
                        digest[key] = digest.get(key, 0.0) + float(value)
                    # agent-only account: every heartbeat is an advance
                    digest["gp_seq"] = round(time.time(), 6)
        except Exception as e:  # noqa: BLE001 - the heartbeat must go
            # out even when the digest sources are broken
            logger.debug("heartbeat digest collection failed: %s", e)
        return digest

    def _take_actions(self) -> List[dict]:
        with self._actions_lock:
            actions, self._pending_actions = self._pending_actions, []
            return actions

    # -- main loop ---------------------------------------------------------

    def run(self) -> int:
        """The agent run loop (reference ``_invoke_run`` training.py:1247).

        Returns a process exit code: 0 success, 1 unrecoverable failure
        (master decides whether to relaunch this host).
        """
        self._sweep_stale_log_roots()
        heartbeat = threading.Thread(
            target=self._heartbeat_loop, daemon=True, name="agent-heartbeat"
        )
        heartbeat.start()
        # flash-checkpoint saver lives in the agent so the last shm
        # snapshot survives worker crashes (reference ckpt_saver.py:477)
        from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver

        self._ckpt_saver = AsyncCheckpointSaver.start_async_saving_ckpt()
        # master-suggested dataloader/parallel config -> file workers poll
        from dlrover_tpu_torch.agent.config_tuner import ParalConfigTuner

        self._config_tuner = ParalConfigTuner(client=self._client)
        self._config_tuner.start()
        self._start_peer_serve()
        try:
            while True:
                result = self._run_once()
                if result == RunResult.SUCCEEDED:
                    # exit barriers: (1) checkpoint persists must land,
                    # (2) peers must reach the end before this host tears
                    # down shared state (reference _exit_barrier)
                    ctx = Context.singleton_instance()
                    if not self._ckpt_saver.wait_idle(
                        timeout=ctx.exit_barrier_timeout_secs
                    ):
                        logger.warning(
                            "ckpt saver still busy after exit barrier "
                            "timeout; last persists may be incomplete"
                        )
                    self._exit_barrier(ctx.exit_barrier_timeout_secs)
                    self._client.report_succeeded()
                    self._client.report_node_event(NodeEventType.MODIFIED,
                                                   reason="succeeded")
                    return 0
                if result == RunResult.RESTART:
                    self._restart_count += 1
                    continue
                return 1
        finally:
            self._stop_heartbeat.set()
            if self._peer_serve is not None:
                self._peer_serve.stop()
                self._peer_serve = None
            self._stop_workers()
            # the implicit stderr-capture dir is ours (pid-scoped);
            # configured log_dirs belong to the user and are kept
            if not self._config.log_dir:
                import shutil

                shutil.rmtree(
                    self._implicit_log_root(), ignore_errors=True
                )

    @staticmethod
    def _implicit_log_root() -> str:
        return os.path.join(
            tempfile.gettempdir(), f"dlrover_tpu_wlogs_{os.getpid()}"
        )

    @staticmethod
    def _sweep_stale_log_roots():
        """SIGKILLed agents never reach their cleanup; their pid-scoped
        capture dirs are reaped here by the next agent to start."""
        import glob
        import shutil

        pattern = os.path.join(
            tempfile.gettempdir(), "dlrover_tpu_wlogs_*"
        )
        for path in glob.glob(pattern):
            try:
                pid = int(path.rsplit("_", 1)[1])
                os.kill(pid, 0)  # raises if the owner is gone
            except ValueError:
                continue
            except (ProcessLookupError, PermissionError) as e:
                if isinstance(e, PermissionError):
                    continue  # someone else's live process
                shutil.rmtree(path, ignore_errors=True)

    def _run_once(self) -> str:
        world = self._rendezvous()
        if self._my_rank_in(world) < 0:
            # not selected this round (e.g. truncated by node_unit): wait
            # and rejoin
            time.sleep(2.0)
            return RunResult.RESTART
        self._start_workers(world)
        return self._monitor_workers()

    def _monitor_workers(self) -> str:
        while True:
            time.sleep(self._config.monitor_interval)
            status = self._workers_status()
            if status == WorkerStatus.SUCCEEDED:
                logger.info("all workers succeeded")
                self._workers.clear()
                return RunResult.SUCCEEDED
            if status == WorkerStatus.FAILED:
                return self._handle_worker_failure()
            # membership change: someone new is waiting to join -> rescale
            try:
                waiting = self._client.num_nodes_waiting()
            except Exception:  # noqa: BLE001
                waiting = 0
            if waiting > 0:
                logger.info(
                    "%d node(s) waiting to join: restarting workers to "
                    "rescale", waiting,
                )
                self._stop_workers()
                return RunResult.RESTART
            actions = self._take_actions()
            # evidence first, unconditionally: every dump in the batch
            # runs BEFORE any restart/abort destroys the wedged state it
            # describes — regardless of the order the master enqueued
            # them (the master also opens the incident before emitting
            # the restart, but ordering here is the agent's own
            # guarantee)
            for action in actions:
                if action.get("action") == "flight_dump":
                    self._handle_flight_dump(action)
            acks: List[str] = []
            for action in actions:
                verb = action.get("action")
                if verb == "flight_dump":
                    continue
                extra = action.get("extra") or {}
                brain_id = (extra.get("brain") or {}).get("id", "")
                if verb == "restart_worker":
                    logger.info("master requested worker restart")
                    if brain_id:
                        acks.append(brain_id)
                    # terminal for this monitor pass: the ack must go
                    # out NOW or the tracker re-issues the restart
                    self._flush_brain_acks(acks)
                    self._stop_workers()
                    return RunResult.RESTART
                if verb == "relaunch_node":
                    logger.info("master requested node relaunch")
                    if brain_id:
                        acks.append(brain_id)
                    self._flush_brain_acks(acks)
                    self._stop_workers()
                    return RunResult.FAILED
                if verb == "brain_preempt":
                    logger.warning(
                        "brain preempted this node for job %r: %s",
                        extra.get("beneficiary", "?"),
                        action.get("reason", ""),
                    )
                    if brain_id:
                        acks.append(brain_id)
                    self._flush_brain_acks(acks)
                    self._stop_workers()
                    return RunResult.FAILED
                if verb == "brain_demote":
                    self._handle_brain_demote(action)
                    if brain_id:
                        acks.append(brain_id)
                    continue
                if verb == "brain_scale_plan":
                    if brain_id:
                        acks.append(brain_id)
                    if extra.get("live_reshard"):
                        # a LIVE plan: hand the target mesh axes to
                        # the training process for an in-place
                        # reshard — no teardown, no rendezvous window
                        self._handle_live_reshard(action, extra)
                        continue
                    if extra.get("restart_workers"):
                        # a shrink re-forms the world without the shed
                        # nodes: survivors must re-rendezvous
                        logger.info(
                            "brain scale plan -> %s nodes: restarting "
                            "workers to re-form the world",
                            extra.get("target_nodes", "?"),
                        )
                        self._flush_brain_acks(acks)
                        self._stop_workers()
                        return RunResult.RESTART
                    logger.info(
                        "brain scale plan -> %s nodes (grow: the "
                        "waiting-node rescale handles it)",
                        extra.get("target_nodes", "?"),
                    )
                    continue
            self._flush_brain_acks(acks)

    def _flush_brain_acks(self, acks: List[str]) -> None:
        """Best-effort ack of processed brain actions; clears the
        list.  A lost ack is bounded by the tracker's expiry — loud,
        never corrupting."""
        if not acks:
            return
        try:
            self._client.report_brain_ack(list(acks))
        except Exception as e:  # noqa: BLE001 - ack is telemetry; the
            # action already ran
            logger.warning("brain action ack failed: %s", e)
        acks.clear()

    def _handle_live_reshard(self, action: dict, extra: dict) -> None:
        """A live ``brain_scale_plan`` delivery.  The reference stages the
        target mesh axes on the training process for an in-place
        reshard; the port has no live reshard yet (ROADMAP item 6c), so
        it logs a warning, as the reference does when staging fails."""
        axes = extra.get("mesh_axes") or {
            "dp": int(extra.get("target_nodes", 0))
        }
        logger.warning(
            "live scale plan handling failed: no live reshard to stage "
            "%s on (ROADMAP item 6c); reason %r", axes,
            action.get("reason", ""),
        )

    def _handle_brain_demote(self, action: dict) -> None:
        """A ``brain_demote`` delivery.  The reference hands it to the
        training process's hierarchy; the port has no hierarchical sync
        yet (ROADMAP item 6d), so it logs a warning, as the reference
        does when the demotion fails."""
        logger.warning(
            "brain_demote handling failed: no hierarchy to demote "
            "(ROADMAP item 6d); reason %r", action.get("reason", ""),
        )

    def _handle_flight_dump(self, action: dict):
        """A broadcast ``flight_dump`` action: snapshot this agent's
        flight recorder (+ the workers' live log tails) and report it
        into the named incident over the normal report RPC."""
        import json

        incident_id = (action.get("extra") or {}).get("incident_id", "")
        if not incident_id:
            logger.warning("flight_dump action without incident_id: %s",
                           action)
            return
        try:
            from dlrover_tpu_torch.observability import flight_recorder

            snap = flight_recorder.recorder().snapshot()
            # live workers' stderr tails WITHOUT joining the pump
            # threads: the pipes have not hit EOF (nothing exited), so a
            # join would stall the dump by its full timeout per worker
            snap["worker_log_tail"] = self._read_worker_log_tail(
                max_bytes=4096, join=False
            )
            self._client.report_incident_dump(
                incident_id, json.dumps(snap)
            )
            logger.info("flight dump reported into incident %s",
                        incident_id)
        except Exception as e:  # noqa: BLE001 - evidence is best-effort;
            # the incident finalizes without this node after the grace
            logger.warning("flight dump for incident %s failed: %s",
                           incident_id, e)

    def _read_worker_log_tail(self, workers=None,
                              max_bytes: int = 8192,
                              join: bool = True) -> str:
        workers = self._workers if workers is None else workers
        chunks = []
        for w in workers:
            if join and w.pump is not None:
                # the workers already exited (that is why we are here):
                # their stderr pipes hit EOF, so the tee thread finishes
                # promptly — join so the traceback is flushed BEFORE the
                # tail is classified, or the crash signature races past.
                # (join=False is the flight-dump path: workers are still
                # RUNNING, the pipes are live, and a join would stall.)
                w.pump.join(timeout=5)
        for w in workers:
            if w.log_path and os.path.exists(w.log_path):
                try:
                    with open(w.log_path, "rb") as f:
                        f.seek(0, os.SEEK_END)
                        size = f.tell()
                        f.seek(max(0, size - max_bytes))
                        chunks.append(
                            f.read().decode("utf-8", errors="replace")
                        )
                except OSError as e:
                    logger.debug("log tail read failed: %s", e)
        return "\n".join(chunks)

    def _exit_barrier(self, timeout_secs: float):
        """Wait until every member of the FINAL world finished (kv
        counter), so the fastest host doesn't tear down job-shared state
        under peers.  The denominator is the last rendezvous world — an
        alive-agent count would include hosts truncated out of the world
        that can never succeed, stalling every exit to the timeout."""
        try:
            world = self._current_world
            total = len(world.world) if world is not None else 1
            if total <= 1:
                return
            # scope the counter to the final rendezvous round: a job
            # resubmitted against a long-lived master (or an agent
            # generation restarting after success) must not inherit stale
            # counts and release the barrier early.  All SUCCEEDED agents
            # share this round — success is collective and any world
            # change restarts every agent's workers under the new round —
            # and the node-count term below self-heals the barrier even if
            # a stale-round agent ever did get here.
            key = f"exit_barrier/{world.round}/count"
            self._client.kv_store_add(key, 1)
            done = 0
            deadline = time.time() + timeout_secs
            while time.time() < deadline:
                # counter long-poll: the master blocks until the count
                # reaches the target; 5s chunks so a shrinking node
                # count (dead peers) re-lowers the target promptly
                target = min(
                    total, self._client.get_node_count() or total
                )
                raw = self._client.kv_store_wait(  # graftlint: disable=GL101 (uniform bounded wait: every agent runs the same deadline loop over server-side long-poll chunks; reads are idempotent)
                    key,
                    timeout=min(5.0, max(0.1, deadline - time.time())),
                    min_value=target,
                )
                done = int(raw or b"0")
                if done >= target:
                    return
            logger.warning("exit barrier timed out (%d/%d)", done, total)
        except Exception as e:  # noqa: BLE001 - barrier is best-effort
            logger.warning("exit barrier failed: %s", e)

    def _handle_worker_failure(self) -> str:
        """Restart-vs-relaunch decision via the failure diagnostician
        (reference DiagnosisAgent ``diagnose_training_failure``
        diagnosis_agent.py:153): OOM/unknown errors retry in place while
        budget lasts; hardware-level errors relaunch the host immediately."""
        from dlrover_tpu_torch.diagnosis.diagnosis_action import ActionType
        from dlrover_tpu_torch.diagnosis.diagnosticians import (
            NodeFailureDiagnostician,
        )

        workers = list(self._workers)  # _stop_workers clears the list
        codes = {w.local_rank: w.proc.poll() for w in workers}
        logger.error("worker failure, exit codes: %s", codes)
        # stop BEFORE reading tails: every stderr pipe then hits EOF, so
        # the tee threads flush the crashed worker's traceback promptly
        # and the join in _read_worker_log_tail cannot stall on a
        # still-running peer
        self._stop_workers()
        error_log = self._read_worker_log_tail(workers)
        if getattr(self, "_ckpt_saver", None) is not None:
            # "save at breakpoint": persist any un-persisted shm snapshot
            try:
                self._ckpt_saver.save_shm_on_failure()
            except Exception as e:  # noqa: BLE001
                logger.warning("save-on-failure failed: %s", e)
        diagnostician = NodeFailureDiagnostician()
        observation = diagnostician.observe(
            exit_codes=codes, error_log=error_log
        )
        # the report carries the classified detail (incl. any
        # `signature=<name>` from the crash-signature table): the
        # master's diagnosis manager turns an hbm_oom signature into a
        # post-mortem memory incident with the culprit's mem.* series
        self._client.report_failure(
            error_data=(
                observation.detail or f"worker exit codes: {codes}"
            ),
            level=TrainingExceptionLevel.PROCESS_ERROR,
            restart_count=self._restart_count,
        )
        action = diagnostician.resolve(
            observation,
            node_id=self._client.node_id,
            remaining_restarts=self._remaining_restarts,
        )
        if action.action_type == ActionType.RESTART_WORKER:
            self._remaining_restarts -= 1
            logger.info(
                "restarting workers in place: %s (%d restart(s) left)",
                action.reason, self._remaining_restarts,
            )
            self._events.instant(
                AgentEvents.WORKER_RESTART,
                {"reason": action.reason, "exit_codes": str(codes),
                 "restarts_left": self._remaining_restarts},
            )
            return RunResult.RESTART
        from dlrover_tpu_torch.common.constants import NodeExitReason

        if action.action_type == ActionType.ABORT_JOB:
            # a deterministic failure (sharding/config bug, persistent
            # HBM OOM): JOB_ABORT makes the master fail the WHOLE job
            # now (JobManager.request_abort) — without it, surviving
            # peers would re-rendezvous into the same crash — and
            # FATAL_ERROR keeps this node off the relaunch path
            logger.error("unrecoverable failure (%s); aborting", action.reason)
            self._client.report_failure(
                error_data=action.reason,
                level=TrainingExceptionLevel.JOB_ABORT,
                restart_count=self._restart_count,
            )
            self._client.report_node_event(
                NodeEventType.ERROR, reason=NodeExitReason.FATAL_ERROR
            )
            return RunResult.FAILED
        logger.error("node-level failure (%s); exiting for relaunch",
                     action.reason)
        # machine-readable reason: the master's relaunch policy
        # (node.should_relaunch) and the auto-scaler's OOM memory bump
        # match NodeExitReason constants, not prose.  Priority order:
        # OOM triggers the memory bump, HARDWARE always relaunches,
        # UNKNOWN relaunches (transient), and a purely-FATAL set (a
        # deterministic code crash past its restart budget) reports
        # FATAL_ERROR — which the master deliberately does NOT relaunch;
        # cycling fresh hosts through the same crash is the one policy
        # the constants docstring forbids.
        exit_reasons = set(
            (observation.extra.get("reasons") or {}).values()
        )
        if NodeExitReason.OOM in exit_reasons:
            reason = NodeExitReason.OOM
        elif NodeExitReason.HARDWARE_ERROR in exit_reasons:
            reason = NodeExitReason.HARDWARE_ERROR
        elif exit_reasons <= {NodeExitReason.FATAL_ERROR,
                              NodeExitReason.SUCCEEDED}:
            reason = NodeExitReason.FATAL_ERROR
        else:
            reason = NodeExitReason.UNKNOWN_ERROR
        self._client.report_node_event(NodeEventType.ERROR, reason=reason)
        return RunResult.FAILED


def launch_agent(
    config: ElasticLaunchConfig, client: Optional[MasterClient] = None
) -> int:
    """Build the client + agent and run (reference ``launch_agent``
    training.py:1868)."""
    client = client or MasterClient.singleton_instance()
    if client is None:
        raise RuntimeError(
            "no master address configured; set "
            f"{NodeEnv.MASTER_ADDR} or run via tpurun"
        )
    if config.exclude_straggler:
        # the launch flag was dead: the straggler diagnosticians read
        # Context.exclude_straggler on the MASTER.  An in-process master
        # (tpurun --standalone) shares this singleton; a remote master
        # reads DLROVER_TPU_EXCLUDE_STRAGGLER from its own env, which
        # the job spec forwards — so the flag also lands in this
        # process's env for anything respawned from it.
        Context.singleton_instance().exclude_straggler = True
        os.environ["DLROVER_TPU_EXCLUDE_STRAGGLER"] = "1"
    node_rank = envs.get_int(NodeEnv.NODE_RANK)
    agent = ElasticAgent(client, config, node_rank)
    return agent.run()
