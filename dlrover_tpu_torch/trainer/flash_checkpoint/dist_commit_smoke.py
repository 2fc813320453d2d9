"""Two-host distributed-commit smoke over the master's HTTP wire.

Port of ``dlrover_tpu/trainer/flash_checkpoint/dist_commit_smoke.py``.  Two
real processes (one controller per host, no ``torch.distributed`` world
between them) commit through a real ``MasterServicer`` behind an
``HttpMasterServer``.  Neither host is handed a commit client: each finds
the master's commit RPC itself (``distributed.get_commit_client``, from
``DLROVER_TPU_MASTER_ADDR``), as a worker or a saver in an agent process
does.  Checked end to end:

* **disjoint ownership + replica dedup**: the hosts' owned shard-key sets
  are disjoint, their union covers every shard, each host skips the
  shards the other owns, and the bytes written sum to the state's payload
  exactly once;
* **seal refused while a manifest is missing**: after only host 0
  reported, the step is unsealed (reported 1 of 2) and the committed
  watermark untouched;
* **differential save**: after one leaf changed, the second save writes
  no more than that leaf's bytes (0 for every unchanged leaf);
* **partial-read restore**: this process restores the committed step
  bit-exact, and a half-leaf ranged read fetches half the leaf's bytes.

The hosts' tensors live on the card unless ``--device cpu``.  Run::

    python -m dlrover_tpu_torch.trainer.flash_checkpoint.dist_commit_smoke \\
        --device cpu

Prints ``DIST_COMMIT_SMOKE {json}``; exit 0 iff every check passed.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

HOST_MARK = "DIST_HOST "
N_W = 1 << 16  # the big leaf: 256 KiB of f32


def _make_arrays(step: int) -> Dict:
    import numpy as np

    return {
        "w": np.arange(N_W, dtype=np.float32) + float(step),
        "m": np.full((64, 128), float(step), np.float32),
        "b": np.ones((1024,), np.float32) * float(step),
        "step": np.asarray(step, np.int32),
    }


def _make_state(step: int, device: str, mutate: bool = False) -> Dict:
    """The deterministic state both hosts stage.  ``mutate`` bumps ONLY
    ``w`` relative to the base step: the differential-save probe."""
    import torch

    arrays = _make_arrays(step)
    if mutate:
        arrays["w"] = arrays["w"] + 0.5
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def _host_main(rank: int, ckpt_dir: str, device: str) -> int:
    from dlrover_tpu_torch.trainer.flash_checkpoint import distributed as dist

    engine = dist.DistributedCheckpointEngine(ckpt_dir, process_id=rank,
                                              num_processes=2)
    client = type(engine._commit_client(2)).__name__
    state4 = _make_state(4, device)
    leaves, pid, _ = dist.plan_dist_shards(state4, rank, 2)
    owned_keys = sorted(s["key"] for leaf in leaves for s in leaf["shards"]
                        if s["owner"] == pid)
    all_keys = sorted(s["key"] for leaf in leaves for s in leaf["shards"])
    # host 1 waits for the seals (it reports last); host 0 exits after
    # reporting: the parent probes the refused seal in between
    wait = rank == 1
    full = engine.save(4, state4, wait_seal=wait, timeout=30)
    diff = engine.save(8, _make_state(4, device, mutate=True),
                       wait_seal=wait, timeout=30)
    print(HOST_MARK + json.dumps({
        "rank": rank, "client": client, "owned_keys": owned_keys,
        "all_keys": all_keys, "full": full, "diff": diff,
    }), flush=True)
    return 0


def _run_host(rank: int, ckpt_dir: str, master_addr: str,
              device: str) -> Dict:
    env = dict(os.environ)
    env.update({
        "DLROVER_TPU_MASTER_ADDR": master_addr,
        "DLROVER_TPU_MASTER_SERVICE_TYPE": "http",
        "DLROVER_TPU_NODE_ID": str(rank),
    })
    proc = subprocess.run(
        [sys.executable, "-m",
         "dlrover_tpu_torch.trainer.flash_checkpoint.dist_commit_smoke",
         "host", str(rank), ckpt_dir, device],
        capture_output=True, text=True, timeout=180, env=env,
    )
    for line in proc.stdout.splitlines():
        if line.startswith(HOST_MARK):
            return json.loads(line[len(HOST_MARK):])
    raise RuntimeError(
        f"host {rank} produced no report (rc={proc.returncode}): "
        f"{(proc.stderr or proc.stdout)[-800:]}")


def run_smoke(device: str = "cuda") -> Dict:
    import numpy as np
    import torch

    from dlrover_tpu_torch.master.master_service import HttpMasterServer
    from dlrover_tpu_torch.master.servicer import MasterServicer
    from dlrover_tpu_torch.trainer.flash_checkpoint import distributed as dist

    t0 = time.time()
    checks: Dict[str, bool] = {}

    def check(name: str, ok: bool, detail: str = ""):
        checks[name] = bool(ok)
        if not ok:
            print(f"SMOKE CHECK FAILED: {name} {detail}", file=sys.stderr,
                  flush=True)

    workdir = tempfile.mkdtemp(prefix="dist_commit_smoke_")
    ckpt_dir = os.path.join(workdir, "ckpt")
    servicer = MasterServicer()
    server = HttpMasterServer(0, servicer)
    server.start()
    addr = f"127.0.0.1:{server.port}"
    host0 = host1 = {}
    try:
        host0 = _run_host(0, ckpt_dir, addr, device)
        # only host 0 has reported: the coordinator must refuse to seal
        status4 = servicer.ckpt_coordinator.status(ckpt_dir, 4)
        check("seal_refused_while_manifest_missing",
              not status4["sealed"] and status4["reported"] == 1
              and status4["committed_step"] == -1, f"status {status4}")
        host1 = _run_host(1, ckpt_dir, addr, device)
        check("hosts_found_the_master_commit_rpc",
              host0["client"] == host1["client"] == "MasterCommitClient",
              f"{host0['client']} / {host1['client']}")
        committed = servicer.ckpt_coordinator.committed_step(ckpt_dir)
        check("both_steps_sealed_after_host1", committed == 8,
              f"committed {committed}")
        owned0, owned1 = set(host0["owned_keys"]), set(host1["owned_keys"])
        check("ownership_disjoint", not (owned0 & owned1),
              f"overlap {owned0 & owned1}")
        check("ownership_covers_all_shards",
              owned0 | owned1 == set(host0["all_keys"]),
              f"missing {set(host0['all_keys']) - (owned0 | owned1)}")
        check("replica_dedup_skipped_writers",
              host0["full"]["shards_skipped_replica"] > 0
              and host1["full"]["shards_skipped_replica"] > 0,
              f"{host0['full']} / {host1['full']}")
        payload = sum(v.nbytes for v in _make_arrays(4).values())
        written = (host0["full"]["bytes_written"]
                   + host1["full"]["bytes_written"])
        check("each_byte_written_exactly_once", written == payload,
              f"wrote {written}, payload {payload}")
        # differential: only `w` changed between the saves
        w_bytes = _make_arrays(4)["w"].nbytes
        diff_written = (host0["diff"]["bytes_written"]
                        + host1["diff"]["bytes_written"])
        check("differential_wrote_fewer_bytes",
              0 < diff_written <= w_bytes < payload,
              f"diff wrote {diff_written}, w={w_bytes}, payload={payload}")
        # restore the committed step bit-exact in THIS process
        expected = _make_state(4, device, mutate=True)
        engine = dist.DistributedCheckpointEngine(ckpt_dir, process_id=0,
                                                  num_processes=1)
        target = {k: torch.zeros_like(v) for k, v in expected.items()}
        restored, step = engine.load(target)
        ok = step == 8 and restored is not None and all(
            torch.equal(restored[k], expected[k]) for k in expected)
        check("restore_bit_exact_at_committed_step", ok, f"step {step}")
        full_read = engine.last_read_stats.get("bytes_read", 0)
        # partial read: half of `w`, a ranged read, not a full-blob pull
        os.environ["DLROVER_TPU_VERIFY_CRC"] = "off"
        try:
            stats: Dict = {"bytes_read": 0, "shards_fetched": 0}
            half = engine.read_slice("w", (slice(0, N_W // 2),),
                                     stats=stats)
            check("partial_read_bit_exact", np.array_equal(
                half.numpy(), expected["w"].cpu().numpy()[: N_W // 2]))
            check("partial_read_fetched_fewer_bytes",
                  0 < stats["bytes_read"] == N_W // 2 * 4 < full_read,
                  f"read {stats['bytes_read']} vs full {full_read}")
        finally:
            os.environ.pop("DLROVER_TPU_VERIFY_CRC", None)
    finally:
        server.stop()
        shutil.rmtree(workdir, ignore_errors=True)
    return {
        "ok": all(checks.values()) and bool(checks),
        "checks": checks,
        "device": device,
        "hosts": {"0": host0.get("full"), "1": host1.get("full")},
        "diff": {"0": host0.get("diff"), "1": host1.get("diff")},
        "wall_s": round(time.time() - t0, 2),
    }


def main(argv: List[str]) -> int:
    if argv and argv[0] == "host":
        return _host_main(int(argv[1]), argv[2], argv[3])
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device "
                               "cpu to run the hosts on the CPU")
    result = run_smoke(args.device)
    print("DIST_COMMIT_SMOKE " + json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
