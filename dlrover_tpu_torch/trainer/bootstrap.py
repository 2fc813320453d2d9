"""Worker-process bootstrap: env -> torch.distributed.

Port of ``dlrover_tpu/trainer/bootstrap.py``.  The agent exports the
coordinator address, process id and process count chosen by the master's
rendezvous (``common/constants.NodeEnv``), and the training script calls
``init`` once before it builds its mesh (``parallel/mesh.build_mesh``):

    ctx = bootstrap.init()
    mesh = build_mesh(MeshConfig(dp=-1, fsdp=2))
    trainer = Trainer(model, optimizer, mesh=mesh)

``init`` also sets up the persistent compile cache and installs the
compile observatory's hook on the kernel build
(``observability/jitscope.py``) before the first kernel is built.  The
port compiles no step: its compile cache is the kernel build directory
(``ops/cuda/_build.py``; ``DLROVER_TPU_COMPILE_CACHE`` names it, empty is
``build/kernels`` of the checkout).  ``init`` records its boot state
(:func:`compile_cache_info`: where it is, whether it is on, the libraries
it held at boot, whether this process is a restart), which the compile
observatory reads to tell a warm restart's misses from a cold start's;
under peer restore it first pulls the libraries it lacks from a surviving
peer.  Unlike XLA's, the cache is on by default on every device, since
every build is cached.  Not ported (ROADMAP item 7, the rest): the
in-process worker monitor of the reference.
"""

import dataclasses
import logging
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class WorkerContext:
    node_rank: int = 0
    local_rank: int = 0
    process_id: int = 0
    num_processes: int = 1
    num_nodes: int = 1
    restart_count: int = 0
    rdzv_round: int = 0
    master_addr: str = ""
    coordinator_addr: str = ""

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


_worker_ctx: Optional[WorkerContext] = None


def worker_context() -> WorkerContext:
    global _worker_ctx
    if _worker_ctx is None:
        _worker_ctx = WorkerContext(
            node_rank=envs.get_int(NodeEnv.NODE_RANK),
            local_rank=envs.get_int("DLROVER_TPU_LOCAL_RANK"),
            process_id=envs.get_int(NodeEnv.PROCESS_ID),
            num_processes=envs.get_int(NodeEnv.NUM_PROCESSES),
            num_nodes=envs.get_int(NodeEnv.NODE_NUM),
            restart_count=envs.get_int("DLROVER_TPU_RESTART_COUNT"),
            rdzv_round=envs.get_int("DLROVER_TPU_RDZV_ROUND"),
            master_addr=envs.get_str(NodeEnv.MASTER_ADDR),
            coordinator_addr=envs.get_str(NodeEnv.COORDINATOR_ADDR),
        )
    return _worker_ctx


def init(platform: Optional[str] = None) -> WorkerContext:
    """Initialise ``torch.distributed`` for this worker from the agent's
    environment and return the ``WorkerContext``.

    ``platform`` (default ``DLROVER_TPU_PLATFORM``): the card unless it is
    ``"cpu"``.  On the card the worker takes card ``local_rank`` and the
    group is NCCL; on the CPU it is gloo, as the reference's CPU workers
    use gloo collectives.  The group meets at
    ``tcp://{coordinator_addr}`` with ``world_size=num_processes`` and
    ``rank=process_id``.  A world of one process initialises nothing (as
    in the reference; ``build_mesh`` makes its one-rank group)."""
    ctx = worker_context()
    platform = platform or envs.get_str("DLROVER_TPU_PLATFORM")
    device = resolve_device("cpu" if platform == "cpu" else None)
    if device.type == "cuda":
        torch.cuda.set_device(ctx.local_rank)
    if ctx.is_distributed:
        if not ctx.coordinator_addr:
            raise ValueError(
                f"{ctx.num_processes} processes and no "
                f"{NodeEnv.COORDINATOR_ADDR}: the agent publishes the "
                "rendezvous address there")
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://{ctx.coordinator_addr}",
            world_size=ctx.num_processes, rank=ctx.process_id)
        logger.info("torch.distributed initialized: process %d/%d "
                    "coordinator=%s backend=%s", ctx.process_id,
                    ctx.num_processes, ctx.coordinator_addr,
                    dist.get_backend())
    _setup_compile_cache()
    try:
        # the compile observatory's hook must be live before the first
        # kernel build, or the first (usually the biggest) build of the
        # job goes unattributed
        from dlrover_tpu_torch.observability import jitscope

        jitscope.install()
    except Exception as e:  # noqa: BLE001 - observability must not
        logger.warning("jitscope install failed: %s", e)  # break boot
    return ctx


#: persistent-cache boot state the compile observatory reads: whether
#: the cache is on, where it lives, why it is off, how many libraries it
#: held at boot (nonzero = a warm restart is EXPECTED to hit), and whether
#: this process is itself a restart.  None until ``init`` set it up.
_cache_status: Optional[dict] = None


def compile_cache_info() -> dict:
    """The persistent compile cache's boot state (a copy).  Before
    ``init`` it describes the directory a build would use now, with no
    libraries counted (``reason`` ``not-initialized``)."""
    if _cache_status is not None:
        return dict(_cache_status)
    from dlrover_tpu_torch.ops.cuda import _build

    if envs.get_str("DLROVER_TPU_COMPILE_CACHE").lower() == "off":
        return {"enabled": False, "dir": "", "reason": "env-off",
                "entries_at_boot": 0, "restart": False}
    return {"enabled": True, "dir": str(_build.build_dir()),
            "reason": "not-initialized", "entries_at_boot": 0,
            "restart": False}


def _count_cache_entries(cache_dir: str) -> int:
    """The libraries a kernel build directory holds (``lib*_<hash>.so``;
    a build's ``*.tmp`` and ``*.log`` files are not entries)."""
    try:
        return sum(1 for name in os.listdir(cache_dir)
                   if name.startswith("lib") and name.endswith(".so"))
    except OSError:
        return 0


def _note_cache_disabled(reason: str, cache_dir: str = "") -> None:
    """A fleet-wide cold cache must be visible, not a line in a log
    nobody tails: count it and drop a flight-recorder event so every
    incident dump carries it."""
    global _cache_status
    _cache_status = dict(_cache_status or {}, enabled=False, dir=cache_dir,
                         reason=reason)
    _cache_status.setdefault("entries_at_boot", 0)
    _cache_status.setdefault("restart", False)
    try:
        from dlrover_tpu_torch.observability import metrics as obs_metrics

        obs_metrics.registry().counter_inc(
            "dlrover_tpu_compile_cache_disabled_total",
            help=obs_metrics._help(
                "dlrover_tpu_compile_cache_disabled_total"),
            reason=reason.split(":", 1)[0][:40],
        )
    except Exception:  # noqa: BLE001 - telemetry must not break boot
        pass
    try:
        from dlrover_tpu_torch.observability import flight_recorder

        flight_recorder.on_event({
            "ts": round(time.time(), 6),
            "type": "INSTANT",
            "name": "compile_cache.disabled",
            "content": {"reason": reason, "dir": cache_dir},
        })
    except Exception:  # noqa: BLE001 - telemetry must not break boot
        pass


def _setup_compile_cache() -> None:
    """Record the persistent compile cache's boot state, before any
    kernel is built: a restart-based elastic recovery rebuilds every
    kernel unless the directory survived (the host owns it), and the
    compile observatory classifies a warm restart's misses against this
    record.  ``DLROVER_TPU_COMPILE_CACHE=off`` records the cache as off
    (the builds then go to a directory of the process's own).  Under peer
    restore the libraries a surviving peer holds are pulled first, so the
    count below sees them."""
    global _cache_status
    from dlrover_tpu_torch.ops.cuda import _build

    restart = bool(worker_context().restart_count > 0)
    _cache_status = {"enabled": False, "dir": "", "reason": "",
                     "entries_at_boot": 0, "restart": restart}
    if envs.get_str("DLROVER_TPU_COMPILE_CACHE").lower() == "off":
        _cache_status["reason"] = "env-off"
        return
    cache_dir = str(_build.build_dir())
    try:
        os.makedirs(cache_dir, exist_ok=True)
        _prewarm_cache_from_peers(cache_dir)
        _cache_status.update(enabled=True, dir=cache_dir,
                             entries_at_boot=_count_cache_entries(cache_dir))
    except Exception as e:  # noqa: BLE001 - the cache is an optimization
        logger.warning("compile cache disabled: %s", e)
        _note_cache_disabled(f"config-error: {e}", cache_dir)


def _prewarm_cache_from_peers(cache_dir: str) -> None:
    """Peer-restore cache prewarm: before the boot count, pull the kernel
    libraries a surviving peer holds, so a replacement's recovery hits a
    warm cache (``entries_at_boot > 0``) instead of firing the
    ``cache_cold`` sentinel and paying an nvcc run the job already paid.
    A no-op unless peer restore is on and a peer client is registered
    (``peer_restore.register_context``)."""
    if not (envs.get_bool("DLROVER_TPU_PEER_RESTORE")
            and envs.get_bool("DLROVER_TPU_PEER_CACHE_PREWARM")):
        return
    try:
        from dlrover_tpu_torch.trainer.flash_checkpoint import peer_restore

        got = peer_restore.prewarm_from_context(cache_dir)
        if got.get("fetched"):
            logger.info("compile cache prewarmed: %d entr(ies), %d bytes "
                        "from peer %d", got["fetched"], got.get("bytes", 0),
                        got.get("donor", -1))
    except Exception as e:  # noqa: BLE001 - prewarm is an optimization
        logger.warning("compile-cache prewarm failed: %s", e)

