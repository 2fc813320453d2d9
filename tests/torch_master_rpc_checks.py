"""Rank worker of tests/test_torch_master_rpc.py: which commit path and
which peer broker a rank of a torch.distributed world finds."""

import os
from typing import Dict


def discovery_worker(group, master_addr: str) -> Dict[str, str]:
    """The clients a rank picks with no master configured, then with the
    master's address in its environment (the master comes first)."""
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.trainer.flash_checkpoint import distributed
    from dlrover_tpu_torch.trainer.flash_checkpoint import peer_restore

    out = {"world": type(distributed.get_commit_client(2)).__name__,
           "world_peer": type(peer_restore.default_client(2)).__name__}
    os.environ.update({"DLROVER_TPU_MASTER_ADDR": master_addr,
                       "DLROVER_TPU_MASTER_SERVICE_TYPE": "http",
                       "DLROVER_TPU_NODE_ID": str(group.rank)})
    MasterClient.reset_singleton()
    out["master"] = type(distributed.get_commit_client(2)).__name__
    out["master_peer"] = type(peer_restore.default_client(2)).__name__
    MasterClient.reset_singleton()
    return out
