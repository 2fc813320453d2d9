"""The error-feedback invariant of the port's quantized grad sync, for the
dp tests (not a test module: pytest does not collect it).

Each quantized bucket's contribution must equal its dequantized codes plus
the new residual, exactly.  ``ef_violation`` measures one bucket;
``ef_checked_train_worker`` is a rank function for ``process_group.spawn``
that runs ``dp_workers.train_worker`` with every bucket of every step
measured.  This module imports torch and the port only, so a spawned rank
that unpickles the function never imports JAX.
"""

from typing import Any, Dict, List

import torch

from dlrover_tpu_torch.parallel import collectives, dp_workers


def ef_violation(buf: torch.Tensor, residual: torch.Tensor,
                 policy: collectives.GradSyncPolicy) -> float:
    """Largest ``|dequant(q(buf)) + residual - buf|`` of one ``(world,
    width)`` bucket buffer: 0 when the invariant holds exactly."""
    width = buf.shape[1]
    x, _ = collectives.pad_blocks(buf, width, policy.block_size)
    deq = collectives.decode_chunks(collectives.encode_chunks(x, policy),
                                    policy)
    deq = deq.reshape(buf.shape[0], -1)[:, :width]
    return (deq + residual - buf).abs().max().item()


def ef_checked_train_worker(group, spec: Dict[str, Any]) -> Dict[str, Any]:
    """``dp_workers.train_worker``, one run at a time, with this rank's
    ``collectives.bucket_reduce_scatter`` wrapped: each run's record gains
    ``ef_max_error``, the largest violation over its quantized buckets
    (None when no bucket was quantized)."""
    original = collectives.bucket_reduce_scatter
    out = None
    try:
        for run in spec["runs"]:
            errors: List[float] = []

            def checked(buf, policy, group_, transport=None, window=None):
                shard, resid = original(buf, policy, group_, transport,
                                        window)
                if resid is not None:
                    errors.append(ef_violation(buf, resid, policy))
                return shard, resid

            collectives.bucket_reduce_scatter = checked
            got = dp_workers.train_worker(group, dict(spec, runs=[run]))
            got["runs"][run["name"]]["ef_max_error"] = (
                max(errors) if errors else None)
            if out is None:
                out = got
            else:
                out["runs"].update(got["runs"])
    finally:
        collectives.bucket_reduce_scatter = original
    return out
