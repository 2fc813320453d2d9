"""Distributed-persist bench: GB/s vs host count, differential bytes,
partial-read bytes.

Port of ``dlrover_tpu/trainer/flash_checkpoint/dist_bench.py``.  Simulated
hosts in ONE process (independent engines sharing one coordinator, each
holding the whole state: the replicated one-process-per-host shape)
persist a fixed payload concurrently; the headline is persist GB/s as a
function of host count — with replica-group dedup each host writes ~1/H of
the payload, so aggregate bandwidth should scale until the disk saturates.
Two more measurements ride along: bytes written per step for a
differential save (a fraction of leaves mutated) vs the full save, and
bytes read for a half-state partial restore vs the full read.

Prints ONE ``DIST_CKPT_BENCH {json}`` line.  The leaves are CPU tensors
(the persist path starts from host bytes, as the saver's does from shm).
``chip_smoke.py`` runs it on the card's host.  Run standalone::

    python -m dlrover_tpu_torch.trainer.flash_checkpoint.dist_bench --mb 32
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

MARK = "DIST_CKPT_BENCH "


def _make_state(total_mb: float, step: int, n_leaves: int = 8,
                mutate_first: int = 0) -> Dict:
    """Leaf values are step-INDEPENDENT so consecutive saves exercise
    the differential path; ``mutate_first`` leaves get a step-dependent
    delta (the 'training touched these' probe)."""
    import torch

    per = max(1, int(total_mb * (1 << 20) / n_leaves / 4))
    state = {}
    for i in range(n_leaves):
        arr = torch.full((per,), float(i), dtype=torch.float32)
        if i < mutate_first:
            arr = arr + 0.5 * step
        state[f"leaf_{i:02d}"] = arr
    return state


def _bench_hosts(
    ckpt_dir: str, hosts: int, total_mb: float, step: int,
    coordinator, mutate_first: int = 0,
) -> Dict:
    """All H host engines persist concurrently (threads: the posix
    writer pool releases the GIL); wall runs save-start -> step sealed."""
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        distributed as dist,
    )

    client = dist.LocalCommitClient(coordinator)
    state = _make_state(total_mb, step, mutate_first=mutate_first)
    engines = [
        dist.DistributedCheckpointEngine(
            ckpt_dir, process_id=p, num_processes=hosts, client=client
        )
        for p in range(hosts)
    ]
    results: List[Dict] = [{} for _ in range(hosts)]

    def _run(p: int):
        results[p] = engines[p].save(
            step, state, wait_seal=(p == 0), timeout=120
        )

    t0 = time.perf_counter()
    threads = [
        threading.Thread(target=_run, args=(p,), daemon=True)
        for p in range(hosts)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    wall = time.perf_counter() - t0
    bytes_written = sum(r.get("bytes_written", 0) for r in results)
    return {
        "hosts": hosts,
        "wall_s": round(wall, 4),
        "bytes_written": bytes_written,
        "gb_per_s": round(bytes_written / max(wall, 1e-9) / 1e9, 3),
        "sealed": bool(results[0].get("sealed")),
        "per_host_bytes": [r.get("bytes_written", 0) for r in results],
    }


def run(total_mb: float = 32.0, host_counts=(1, 2, 4),
        workdir: Optional[str] = None) -> Dict:
    """The bench in a fresh directory under ``workdir`` (the temp dir by
    default), removed at the end."""
    from dlrover_tpu_torch.master.ckpt_coordinator import (
        CkptCommitCoordinator,
    )
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        distributed as dist,
    )

    out: Dict = {
        "payload_mb": total_mb,
        "persist_scaling": [],
    }
    workdir = tempfile.mkdtemp(prefix="dist_ckpt_bench_", dir=workdir)
    crc_mode = os.environ.get("DLROVER_TPU_VERIFY_CRC")
    try:
        # warm-up: the first save pays lazy imports, which would
        # otherwise be billed to the hosts=1 leg
        _bench_hosts(
            os.path.join(workdir, "warmup"), 1, 1.0, 1,
            CkptCommitCoordinator(),
        )
        for hosts in host_counts:
            ckpt_dir = os.path.join(workdir, f"h{hosts}")
            coordinator = CkptCommitCoordinator()
            out["persist_scaling"].append(
                _bench_hosts(ckpt_dir, hosts, total_mb, 1, coordinator)
            )
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        # differential leg in a fresh 2-host dir: full save, then a
        # step that mutated only 2 of the 8 leaves
        ckpt_dir = os.path.join(workdir, "diffleg")
        coordinator = CkptCommitCoordinator()
        full = _bench_hosts(ckpt_dir, 2, total_mb, 2, coordinator)
        diff = _bench_hosts(
            ckpt_dir, 2, total_mb, 3, coordinator, mutate_first=2
        )
        out["differential"] = {
            "full_bytes_per_step": full["bytes_written"],
            "diff_bytes_per_step": diff["bytes_written"],
            "reduction_x": round(
                full["bytes_written"] / max(1, diff["bytes_written"]), 2
            ),
        }
        # partial-read leg: half of every leaf vs the full payload
        engine = dist.DistributedCheckpointEngine(
            ckpt_dir, process_id=0, num_processes=1,
            client=dist.LocalCommitClient(coordinator),
        )
        os.environ["DLROVER_TPU_VERIFY_CRC"] = "off"
        stats: Dict = {"bytes_read": 0, "shards_fetched": 0}
        step = engine.committed_step()
        manifest = dist.read_manifest(ckpt_dir, step)
        total_bytes = sum(
            int(rec["nbytes"])
            for leaf in manifest["leaves"]
            for rec in leaf["shards"]
        )
        t0 = time.perf_counter()
        for leaf in manifest["leaves"]:
            n = leaf["gshape"][0]
            engine.read_slice(
                leaf["path"], (slice(0, n // 2),), step=step, stats=stats,
            )
        out["partial_read"] = {
            "bytes_read": stats["bytes_read"],
            "full_read_bytes": total_bytes,
            "read_fraction": round(
                stats["bytes_read"] / max(1, total_bytes), 3
            ),
            "wall_s": round(time.perf_counter() - t0, 4),
        }
    finally:
        if crc_mode is None:
            os.environ.pop("DLROVER_TPU_VERIFY_CRC", None)
        else:
            os.environ["DLROVER_TPU_VERIFY_CRC"] = crc_mode
        shutil.rmtree(workdir, ignore_errors=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--mb", type=float, default=32.0)
    parser.add_argument("--hosts", type=str, default="1,2,4")
    args = parser.parse_args(argv)
    hosts = tuple(int(h) for h in args.hosts.split(","))
    result = run(total_mb=args.mb, host_counts=hosts)
    print(MARK + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
