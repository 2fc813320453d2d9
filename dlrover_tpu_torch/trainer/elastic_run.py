"""``tpurun``: the elastic launcher CLI.

Copy of ``dlrover_tpu/trainer/elastic_run.py``, the counterpart of DLRover's
``dlrover/trainer/torch/elastic_run.py`` (``main/parse_args/ElasticLaunch:
132,246``, ``wait_pre_check:295``, ``_launch_dlrover_local_master:326``):
a torchrun-superset-style CLI that auto-spawns a local master when none is
configured, waits for pre-checks, then runs the per-host elastic agent
which rendezvouses and launches the worker processes.

Examples::

    # one host, one worker on the card, the crash-resume example
    python -m dlrover_tpu_torch.trainer.elastic_run --standalone \
        --nproc_per_node=1 -m dlrover_tpu_torch.examples.train_llama_ckpt \
        /path/to/ckpt_dir

    # two worker processes on the CPU (gloo)
    python -m dlrover_tpu_torch.trainer.elastic_run --standalone \
        --nproc_per_node=2 --platform=cpu train.py

What differs from the copy: the local master is spawned by the port's
name; ``--platform`` is ``cpu`` or ``cuda`` (empty: the card, and a worker
raises where there is none: no CPU fallback); and ``--network-check``
raises ``NotImplementedError`` (``ROADMAP_LAUNCHER_REST``: the node check
is not ported).
"""

import argparse
import atexit
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Tuple

from dlrover_tpu_torch.agent.elastic_agent import ElasticLaunchConfig, launch_agent
from dlrover_tpu_torch.agent.master_client import MasterClient, build_master_client
from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.common.constants import (
    ROADMAP_LAUNCHER_REST,
    CommunicationType,
    NodeEnv,
    PreCheckStatus,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.utils.env_utils import port_reachable


# the values of --platform: the card ('' or 'cuda') or the CPU
WORKER_PLATFORMS = ("", "cpu", "cuda")


def parse_args(argv: Optional[List[str]] = None) -> Tuple[argparse.Namespace, List[str]]:
    parser = argparse.ArgumentParser(
        prog="tpurun", description="dlrover-tpu elastic launcher"
    )
    parser.add_argument("--standalone", action="store_true",
                        help="single-host mode: auto-spawn a local master")
    parser.add_argument("--nnodes", type=str, default="1",
                        help="number of hosts, fixed (N) or elastic (MIN:MAX)")
    parser.add_argument("--nproc_per_node", type=int, default=1,
                        help="worker processes per host (TPU: usually 1, "
                             "using all local chips)")
    parser.add_argument("--max-restarts", "--max_restarts", type=int,
                        default=3, dest="max_restarts")
    parser.add_argument("--monitor-interval", type=float, default=2.0,
                        dest="monitor_interval")
    parser.add_argument("--rdzv-timeout", type=float, default=600.0,
                        dest="rdzv_timeout")
    parser.add_argument("--network-check", action="store_true",
                        dest="network_check",
                        help="run pre-flight host/ICI checks before training")
    parser.add_argument("--exclude-straggler", action="store_true",
                        dest="exclude_straggler",
                        help="exit (for relaunch elsewhere) when this host "
                             "is classified a straggler by the check")
    parser.add_argument("--node-unit", type=int, default=1, dest="node_unit",
                        help="hosts per TPU slice; worlds are multiples of it")
    parser.add_argument("--platform", type=str, default="",
                        help="the workers' platform: cpu or cuda (default: "
                             "the card)")
    parser.add_argument("--log-dir", type=str, default="", dest="log_dir")
    parser.add_argument("-m", "--module", action="store_true", dest="run_module",
                        help="treat entrypoint as a python module")
    parser.add_argument("--master-addr", type=str, default="",
                        dest="master_addr",
                        help="job master address (host:port); defaults to "
                             f"${NodeEnv.MASTER_ADDR}")
    parser.add_argument("--node-rank", type=int, default=-1, dest="node_rank")
    parser.add_argument("entrypoint", type=str, help="training script")
    return parser.parse_known_args(argv)


def _parse_nnodes(nnodes: str) -> Tuple[int, int]:
    if ":" in nnodes:
        lo, hi = nnodes.split(":", 1)
        low, high = int(lo), int(hi)
        if low < 1 or low > high:
            raise ValueError(
                f"--nnodes={nnodes!r}: want MIN:MAX with 1 <= MIN <= MAX"
            )
        return low, high
    n = int(nnodes)
    if n < 1:
        raise ValueError(f"--nnodes={nnodes!r} must be >= 1")
    return n, n


def _launch_local_master(node_num: int) -> Tuple[subprocess.Popen, str]:
    """Spawn a LocalJobMaster subprocess and wait for its port (reference
    ``_launch_dlrover_local_master`` elastic_run.py:326)."""
    fd, port_file = tempfile.mkstemp(prefix="dlrover_tpu_master_port_")
    os.close(fd)
    os.unlink(port_file)  # the master creates it; we only claimed the name
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "dlrover_tpu_torch.master.main",
            "--platform", "local",
            "--port", "0",
            "--node_num", str(node_num),
            "--port_file", port_file,
        ],
    )
    deadline = time.time() + 60
    while time.time() < deadline:
        if os.path.exists(port_file):
            with open(port_file) as f:
                content = f.read().strip()
            if content:
                port = int(content)
                addr = f"localhost:{port}"
                if port_reachable("localhost", port, timeout=1.0):
                    logger.info("local master ready at %s", addr)
                    return proc, addr
        if proc.poll() is not None:
            raise RuntimeError("local master exited during startup")
        time.sleep(0.3)
    proc.terminate()
    raise TimeoutError("local master did not start within 60s")


def wait_pre_check(client: MasterClient, timeout: float = 600.0):
    """Block until master pre-checks pass (reference ``wait_pre_check``
    elastic_run.py:295)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        status = client.get_pre_check_result()
        if status in ("", PreCheckStatus.PASS):
            return
        if status == PreCheckStatus.FAIL:
            raise RuntimeError("master pre-check failed")
        # keep heartbeating while gated: the agent's own heartbeat thread
        # only starts after this returns, and a long gate must not look
        # like node death to the master's heartbeat monitor
        try:
            client.report_heart_beat()
        except Exception as e:  # noqa: BLE001 - gate polling is best-effort
            logger.debug("pre-check gate heartbeat failed: %s", e)
        time.sleep(2.0)
    raise TimeoutError("pre-check did not complete in time")


def main(argv: Optional[List[str]] = None) -> int:
    args, script_args = parse_args(argv)
    min_nodes, max_nodes = _parse_nnodes(args.nnodes)
    if args.platform not in WORKER_PLATFORMS:
        raise ValueError(
            f"--platform={args.platform!r}: the port's workers run on "
            f"one of {WORKER_PLATFORMS} ('' = the card)")
    network_check = args.network_check or envs.get_bool(
        "DLROVER_TPU_NETWORK_CHECK"
    )
    if network_check:
        raise NotImplementedError(
            "--network-check: the node check is not ported yet "
            f"({ROADMAP_LAUNCHER_REST})")

    master_proc: Optional[subprocess.Popen] = None
    master_addr = args.master_addr or envs.get_str(NodeEnv.MASTER_ADDR)
    if not master_addr:
        if not args.standalone and max_nodes > 1:
            logger.warning(
                "no master address for a multi-host job; spawning a local "
                "master (fine for tests, wrong for production)"
            )
        master_proc, master_addr = _launch_local_master(max_nodes)
        os.environ[NodeEnv.MASTER_ADDR] = master_addr
        atexit.register(master_proc.terminate)

    # per-job IPC scope: shm/sockets must not collide across jobs sharing
    # a host (a stale snapshot from job A must not "resume" into job B)
    if not envs.get_str(NodeEnv.JOB_NAME):
        import hashlib

        os.environ[NodeEnv.JOB_NAME] = (
            "job" + hashlib.md5(master_addr.encode()).hexdigest()[:8]
        )

    node_rank = args.node_rank
    if node_rank < 0:
        node_rank = envs.get_int(NodeEnv.NODE_RANK)
    os.environ.setdefault(NodeEnv.NODE_ID, str(node_rank))
    client = build_master_client(
        master_addr=master_addr,
        node_id=envs.get_int(NodeEnv.NODE_ID),
        service_type=envs.get_str(
            NodeEnv.MASTER_SERVICE_TYPE, default=CommunicationType.GRPC
        ),
    )
    # announce this agent before the pre-check gate: the master's
    # connection pre-check counts registered (RUNNING) hosts
    from dlrover_tpu_torch.common.constants import NodeEventType

    client.report_node_event(NodeEventType.ADDED, reason="agent_connected")
    wait_pre_check(client)

    config = ElasticLaunchConfig(
        min_nodes=min_nodes,
        max_nodes=max_nodes,
        nproc_per_node=args.nproc_per_node,
        max_restarts=args.max_restarts,
        monitor_interval=args.monitor_interval,
        rdzv_timeout=args.rdzv_timeout,
        network_check=network_check,
        exclude_straggler=args.exclude_straggler,
        node_unit=args.node_unit,
        platform=args.platform,
        entrypoint=args.entrypoint,
        args=script_args,
        run_module=args.run_module,
        log_dir=args.log_dir,
    )

    rc = launch_agent(config, client)
    if master_proc is not None:
        try:
            master_proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            master_proc.terminate()
    return rc


if __name__ == "__main__":
    sys.exit(main())
