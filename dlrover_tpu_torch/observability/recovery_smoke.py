"""Peer-restore smoke: kill one of 4 local hosts, pull the lost shards back
from the survivors, and prove the recovery contract end to end against
the real components.

Port of ``dlrover_tpu/observability/recovery_smoke.py``:

1. four local "hosts" (shm segments + peer serve endpoints) hold the same
   committed step; each announces its snapshot to a real
   ``MasterServicer``'s peer broker, through the master client;
2. host 1 dies (its segment is unlinked); the replacement asks the
   broker for donors and runs the fallback ladder, which must stop at the
   first rung: every byte from peer shm, **zero storage reads**, the
   recommitted segment byte-identical to a donor's;
3. the compile-cache entries the survivors serve are prewarmed into the
   replacement's cache directory before its first step, byte-identical:
   the survivors serve the directory an agent serves
   (``bootstrap.compile_cache_info``: the kernel build directory), whose
   entries on the card are the built ``lib*.so`` libraries; on the CPU,
   where nothing is built, the smoke serves stand-in entries of the same
   names from a directory of its own;
4. the measured MTTR lands under the drill budget, the recovery report
   reaches the master's time-series store, the dashboard's ``recovery``
   view (``master/dashboard.py``, over HTTP) shows the replica group and
   the recovery, and ``MttrSentinel`` stays quiet.

The snapshot's tensors live on the card unless ``--device cpu``.  Run::

    python -m dlrover_tpu_torch.observability.recovery_smoke --device cpu

Prints ``RECOVERY_SMOKE {json}``; exit 0 iff every check passed.
"""

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import types
import urllib.request
from typing import Dict, List, Optional

_SEED = 24

#: the drill's MTTR budget (s): a local 4-host recovery that cannot finish
#: inside this is broken, not slow
_BUDGET_S = 20.0

_STEP = 6


def _check(checks: Dict[str, bool], name: str, ok: bool, detail: str = ""):
    checks[name] = bool(ok)
    if not ok:
        print(f"recovery smoke check FAILED: {name} {detail}",
              file=sys.stderr, flush=True)


def _entries(cache_dir: str) -> Dict[str, bytes]:
    out = {}
    for root, _dirs, files in os.walk(cache_dir):
        for name in files:
            full = os.path.join(root, name)
            with open(full, "rb") as f:
                out[os.path.relpath(full, cache_dir)] = f.read()
    return out


def _survivor_cache(device: str, workdir: str, rng) -> str:
    """The cache directory the survivors serve: the kernel build
    directory an agent serves, when the run built kernels into it (on the
    card); else stand-in entries in a directory of the smoke's own."""
    from dlrover_tpu_torch.trainer import bootstrap

    info = bootstrap.compile_cache_info()
    cache_dir = info["dir"] if info.get("enabled") else ""
    built = cache_dir and os.path.isdir(cache_dir) and any(
        n.startswith("lib") and n.endswith(".so")
        for n in os.listdir(cache_dir))
    if built:
        return cache_dir
    if device == "cuda":
        raise RuntimeError(
            f"the kernel build directory {cache_dir!r} holds no built "
            "library: build the kernels first (ops/cuda/_build.build)")
    cache_dir = os.path.join(workdir, "cache_survivor")
    os.makedirs(cache_dir, exist_ok=True)
    for i in range(2):
        with open(os.path.join(cache_dir, f"libsmoke{i:02d}_0000.so"),
                  "wb") as f:
            f.write(rng.bytes(2048))
    return cache_dir


def run_smoke(device: str = "cuda", cache_dir: Optional[str] = None
              ) -> Dict:
    import numpy as np
    import torch

    from dlrover_tpu_torch.agent.master_client import LocalMasterClient
    from dlrover_tpu_torch.common.multi_process import SharedMemoryBuffer
    from dlrover_tpu_torch.diagnosis.diagnostician import DiagnosisManager
    from dlrover_tpu_torch.master.dashboard import DashboardServer
    from dlrover_tpu_torch.master.servicer import MasterServicer
    from dlrover_tpu_torch.observability.incidents import IncidentManager
    from dlrover_tpu_torch.observability.sentinel import MttrSentinel
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        peer_restore,
        snapshot,
    )
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import shm_name

    checks: Dict[str, bool] = {}
    workdir = tempfile.mkdtemp(prefix="recovery_smoke_")
    scope = f"recsmoke{os.getpid()}"
    nprocs, dead = 4, 1
    survivors = [p for p in range(nprocs) if p != dead]
    rng = np.random.default_rng(_SEED)
    state = {
        "w": torch.from_numpy(rng.standard_normal(4096).astype(
            np.float32)).to(device),
        "b": torch.from_numpy(rng.standard_normal(512).astype(
            np.float32)).to(device),
        "step": torch.tensor(_STEP, dtype=torch.int32, device=device),
    }
    shms: Dict[int, SharedMemoryBuffer] = {}
    endpoints: Dict[int, peer_restore.PeerServeEndpoint] = {}
    report: Dict = {}
    with contextlib.ExitStack() as stack:
        stack.callback(shutil.rmtree, workdir, True)
        overrides = {
            "DLROVER_TPU_PEER_RESTORE": "1",
            "DLROVER_TPU_PEER_CACHE_PREWARM": "1",
            "DLROVER_TPU_MTTR_BUDGET_S": str(_BUDGET_S),
            "DLROVER_TPU_INCIDENT_DIR": os.path.join(workdir, "incidents"),
            "DLROVER_TPU_INCIDENT_COOLDOWN_S": "0",
        }
        for key, value in overrides.items():
            saved = os.environ.get(key)
            os.environ[key] = value
            stack.callback(
                (lambda k, v: (os.environ.__setitem__(k, v) if v is not None
                               else os.environ.pop(k, None))),
                key, saved,
            )

        def cleanup():
            for endpoint in endpoints.values():
                endpoint.stop()
            for shm in shms.values():
                with contextlib.suppress(Exception):
                    shm.close()
                    shm.unlink()

        stack.callback(cleanup)

        # master + broker, the survivors' serve plane, and the compile
        # cache the fleet already paid for
        servicer = MasterServicer()
        client = LocalMasterClient(servicer, node_id=dead)
        cache_src = cache_dir or _survivor_cache(device, workdir, rng)
        cache_blobs = _entries(cache_src)
        leaves = snapshot.plan_shards(state)
        announced = True
        for pid in range(nprocs):
            shm = SharedMemoryBuffer(shm_name(pid, scope))
            snapshot.write_snapshot(shm, _STEP, leaves, {"smoke": _SEED})
            shms[pid] = shm
            if pid == dead:
                continue
            endpoint = peer_restore.PeerServeEndpoint(
                pid, scope=scope, cache_dir=cache_src).start()
            endpoints[pid] = endpoint
            announced = announced and client.report_peer_announce(
                scope, _STEP, endpoint.addr, num_processes=nprocs,
                process_id=pid)
        _check(checks, "survivors_announced", announced)
        donor_meta_bytes = snapshot.read_meta_bytes(shms[0])
        payload_nbytes = int(
            snapshot.read_snapshot_meta(shms[0])["payload_bytes"])

        # -- the kill: host 1's segment is gone ------------------------
        shms[dead].close()
        shms[dead].unlink()
        shms.pop(dead)

        # -- the recovery: broker-assigned donors, peer rung only ------
        assignment = client.get_peer_assignment(
            scope, step=-1, group=survivors, process_id=dead)
        _check(checks, "broker_assigned_replica_donors",
               assignment.step == _STEP
               and len(assignment.donors or {}) == len(survivors),
               f"step={assignment.step} donors={assignment.donors}")
        shm_new = SharedMemoryBuffer(shm_name(dead, scope))
        shms[dead] = shm_new
        cache_dst = os.path.join(workdir, "cache_replacement")
        os.makedirs(cache_dst, exist_ok=True)
        report = peer_restore.recover(
            scope=scope, process_id=dead, num_processes=nprocs,
            shm=shm_new, checkpoint_dir=os.path.join(workdir, "ckpt"),
            assignment={"step": int(assignment.step),
                        "donors": dict(assignment.donors)},
            cache_dir=cache_dst, client=client)
        _check(checks, "zero_storage_reads",
               report["filled"] and report["rung"] == "peer_shm"
               and report["storage_reads"] == 0
               and report["bytes_manifest"] == 0, str(report))
        _check(checks, "restored_bit_exact",
               snapshot.read_meta_bytes(shm_new) == donor_meta_bytes
               and snapshot.read_payload_range(shm_new, 0, payload_nbytes)
               == snapshot.read_payload_range(shms[0], 0, payload_nbytes))
        _check(checks, "cache_prewarmed",
               report["cache_prewarmed"] == len(cache_blobs) > 0
               and _entries(cache_dst) == cache_blobs,
               f"{report['cache_prewarmed']} of {sorted(cache_blobs)}")
        _check(checks, "mttr_under_drill_budget",
               0.0 < report["mttr_s"] < _BUDGET_S
               and not report["over_budget"],
               f"mttr {report['mttr_s']}s budget {_BUDGET_S}s")

        # -- the control plane saw it ----------------------------------
        store = servicer.timeseries
        recoveries = store.recoveries()
        _check(checks, "recovery_in_timeseries",
               bool(recoveries) and recoveries[-1]["rung"] == "peer_shm"
               and store.latest("job.recovery.mttr_s") is not None,
               str(recoveries[-1:]))
        incident_manager = IncidentManager()
        incident_manager.set_timeseries(store)
        dashboard = DashboardServer(types.SimpleNamespace(
            servicer=servicer, incident_manager=incident_manager))
        dashboard.start()
        stack.callback(dashboard.stop)
        port = dashboard._httpd.server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/recovery", timeout=30) as resp:
            view = json.loads(resp.read())
        scope_view = (view.get("scopes") or {}).get(scope, {})
        _check(checks, "dashboard_replica_health",
               len(scope_view) >= len(survivors)
               and bool(view.get("recoveries"))
               and view.get("job", {}).get("mttr_s") is not None,
               json.dumps(view)[:400])
        diagnosis = DiagnosisManager()
        diagnosis.register(MttrSentinel(store))
        diagnosis.set_incident_manager(incident_manager)
        diagnosis.diagnose_once()
        _check(checks, "mttr_sentinel_quiet",
               not incident_manager.list_incidents(),
               str(incident_manager.list_incidents()))
    return {
        "ok": all(checks.values()),
        "checks": checks,
        "seed": _SEED,
        "device": device,
        "cache_entries": sorted(cache_blobs),
        "recovery_mttr_s": report.get("mttr_s"),
        "peer_read_gbps": report.get("peer_read_gbps"),
        "bytes_peer": report.get("bytes_peer"),
    }


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device "
                               "cpu to run the smoke on the CPU")
    result = run_smoke(args.device)
    print("RECOVERY_SMOKE " + json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
