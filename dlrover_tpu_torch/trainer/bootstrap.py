"""Worker-process bootstrap: env -> torch.distributed.

Port of ``dlrover_tpu/trainer/bootstrap.py``.  The agent exports the
coordinator address, process id and process count chosen by the master's
rendezvous (``common/constants.NodeEnv``), and the training script calls
``init`` once before it builds its mesh (``parallel/mesh.build_mesh``):

    ctx = bootstrap.init()
    mesh = build_mesh(MeshConfig(dp=-1, fsdp=2))
    trainer = Trainer(model, optimizer, mesh=mesh)

``init`` also installs the compile observatory's hook on the kernel build
(``observability/jitscope.py``) before the first kernel is built.  Not
ported (ROADMAP item 7, the rest), so ``init`` does not set them up: the
persistent compile cache (the port compiles no step) and the in-process
worker monitor of the reference.
"""

import dataclasses
import logging
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
    try:
        # the compile observatory's hook must be live before the first
        # kernel build, or the first (usually the biggest) build of the
        # job goes unattributed
        from dlrover_tpu_torch.observability import jitscope

        jitscope.install()
    except Exception as e:  # noqa: BLE001 - observability must not
        logger.warning("jitscope install failed: %s", e)  # break boot
    return ctx
