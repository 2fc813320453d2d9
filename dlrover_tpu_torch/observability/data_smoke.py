"""Data-pipeline smoke (<60s CI gate): datascope end to end.

Copy of ``dlrover_tpu/observability/data_smoke.py``: proof that the data
observatory closes against the REAL components — the ``ShardingClient``
leasing from a real ``MasterServicer`` whose ``TaskManager`` feeds the
master-side ``ShardTelemetry``, the process
goodput ledger booking blocking shard waits as ``input_starved``, the
heartbeat digest shipping the account into the ``TimeSeriesStore``,
the ``DataStarvationDiagnostician`` opening a classified incident, and
the ``/data`` dashboard endpoint serving it all over real HTTP — with
the starvation manufactured deterministically by the chaos engine:

1. a seeded run simulates healthy training steps, then consumes a
   small dataset whose shard leases are each stalled by a chaos DELAY
   on the ``data.lease`` point (the master's dispatch path);
2. the ledger must attribute the stalls to ``input_starved`` — the
   DOMINANT non-idle phase of the run — and the whole account must
   still sum to the process wall clock (±1%);
3. the master's shard telemetry must count every completion, drain the
   backlog to zero, and show the injected stall in the lease p99;
4. the ``DataStarvationDiagnostician`` fires through
   ``DiagnosisManager`` on the ``job.share.input_starved`` spike, and
   the incident classifies phase ``data`` naming the injected
   ``data.lease`` fault;
5. a real ``DashboardServer`` serves the backlog account on ``/data``
   over HTTP.

Run::

    python -m dlrover_tpu_torch.observability.data_smoke

It touches no device (the master, the client and the ledger are host
code), so it runs alike on the CPU and on the card's host.

Prints ``DATA_SMOKE {json}``; exit 0 iff every check passed.
"""

import contextlib
import json
import os
import shutil
import sys
import tempfile
import time
import types
import urllib.request
from typing import Dict

_SEED = 13

#: injected per-lease stall (s) x leases — together they must dominate
#: the run's compute account
_STALL_S = 0.7
_SHARDS = 4


def _check(checks: Dict[str, bool], name: str, ok: bool, detail: str = ""):
    checks[name] = bool(ok)
    if not ok:
        print(f"data smoke check FAILED: {name} {detail}",
              file=sys.stderr, flush=True)


def run_smoke() -> Dict:
    from dlrover_tpu_torch import chaos
    from dlrover_tpu_torch.agent.elastic_agent import (
        ElasticAgent,
        ElasticLaunchConfig,
    )
    from dlrover_tpu_torch.agent.master_client import LocalMasterClient
    from dlrover_tpu_torch.agent.sharding import ShardingClient
    from dlrover_tpu_torch.diagnosis.diagnostician import DiagnosisManager
    from dlrover_tpu_torch.master.dashboard import DashboardServer
    from dlrover_tpu_torch.master.servicer import MasterServicer
    from dlrover_tpu_torch.observability import (
        datascope,
        flight_recorder,
        goodput,
        trace,
    )
    from dlrover_tpu_torch.observability.incidents import IncidentManager
    from dlrover_tpu_torch.observability.sentinel import (
        DataStarvationDiagnostician,
    )

    checks: Dict[str, bool] = {}
    workdir = tempfile.mkdtemp(prefix="data_smoke_")
    with contextlib.ExitStack() as stack:
        stack.callback(shutil.rmtree, workdir, True)
        overrides = {
            "DLROVER_TPU_GOODPUT_RES_S": "0.05",
            "DLROVER_TPU_SENTINEL_MIN_SAMPLES": "3",
            "DLROVER_TPU_SENTINEL_CONSECUTIVE": "1",
            "DLROVER_TPU_INCIDENT_DIR": os.path.join(workdir, "incidents"),
            "DLROVER_TPU_INCIDENT_COOLDOWN_S": "0",
            "DLROVER_TPU_RUNTIME_METRICS_PATH": os.path.join(
                workdir, "runtime_metrics.json"
            ),
            # one task per lease envelope: every shard pays the injected
            # dispatch stall instead of the first lease prefetching all
            "DLROVER_TPU_SHARD_LEASE_BATCH": "1",
            "DLROVER_TPU_DATA_FLUSH_S": "0.05",
        }
        for key, value in overrides.items():
            saved = os.environ.get(key)
            os.environ[key] = value
            stack.callback(
                (lambda k, v: (os.environ.__setitem__(k, v) if v is not None
                               else os.environ.pop(k, None))),
                key, saved,
            )
        trace.seed_ids(_SEED)
        stack.callback(trace.seed_ids, 0)
        flight_recorder.recorder().reset()
        ledger = goodput.reset_ledger()
        stack.callback(goodput.reset_ledger)
        datascope.reset_scope()
        stack.callback(datascope.reset_scope)

        chaos.configure(chaos.ChaosPlan(
            name="data_smoke", seed=_SEED,
            faults=[chaos.FaultSpec(
                point="data.lease", kind=chaos.DELAY,
                delay_s=_STALL_S, on_calls=list(range(_SHARDS)),
                times=_SHARDS,
            )],
        ))
        stack.callback(chaos.clear)

        # master: servicer (owns the store + shard telemetry), sentinel
        servicer = MasterServicer()
        store = servicer.timeseries
        telemetry = servicer.shard_telemetry
        client = LocalMasterClient(servicer, node_id=0)
        agent = ElasticAgent(client, ElasticLaunchConfig())
        incident_manager = IncidentManager()
        incident_manager.set_timeseries(store)
        diagnosis = DiagnosisManager()
        diagnosis.register(DataStarvationDiagnostician(store, res_s=1.0))
        diagnosis.set_incident_manager(incident_manager)

        last_hb = 0.0

        def heartbeat(force: bool = False):
            nonlocal last_hb
            if force or time.time() - last_hb >= 0.3:
                client.report_heart_beat(digest=agent._collect_digest())  # noqa: SLF001
                last_hb = time.time()

        # phase A — healthy: sparse simulated steps (the compute feed
        # must NOT dominate the injected starvation), digests shipping
        # the cumulative account into the store's share series
        t_end = time.time() + 3.6
        step = 0
        while time.time() < t_end:
            time.sleep(0.3)
            step += 1
            goodput.on_step(step, 0.05)
            heartbeat()

        # phase B — starved: every shard lease pays the injected
        # data.lease DELAY; the client books the blocking wait
        sharding = ShardingClient(
            dataset_name="smoke_data",
            batch_size=4,
            num_epochs=1,
            dataset_size=_SHARDS * 4,
            client=client,
            num_minibatches_per_shard=1,
        )
        consumed = 0
        while True:
            shard = sharding.fetch_shard()
            if shard is None:
                break
            consumed += 1
            sharding.report_shard_done()
            heartbeat(force=True)
        _check(checks, "all_shards_consumed", consumed == _SHARDS,
               f"consumed {consumed}/{_SHARDS}")

        # phase C — healthy again, so the dip bucket COMPLETES and the
        # sentinel (which skips the live bucket) can see it
        t_end = time.time() + 1.4
        while time.time() < t_end:
            time.sleep(0.3)
            step += 1
            goodput.on_step(step, 0.05)
            heartbeat()
        heartbeat(force=True)

        injected = _STALL_S * _SHARDS

        # -- ledger invariants (per-process wall-clock account) --------
        summary = ledger.summary()
        phases = summary["phases"]
        total = sum(phases.values())
        wall = summary["wall_s"]
        _check(
            checks, "ledger_sums_to_wall_within_1pct",
            abs(total - wall) <= max(0.01 * wall, summary["res_s"]),
            f"phases sum {total:.3f}s vs wall {wall:.3f}s",
        )
        _check(
            checks, "stall_attributed_to_input_starved",
            phases["input_starved"] >= 0.8 * injected,
            f"input_starved {phases['input_starved']:.3f}s of "
            f"{injected}s injected ({summary})",
        )
        _check(
            checks, "input_starved_dominant",
            summary["dominant"] == "input_starved",
            f"dominant {summary['dominant']!r} phases {phases}",
        )

        # -- agent-side fetch account ----------------------------------
        scope = datascope.scope_summary()
        _check(checks, "fetches_recorded",
               scope.get("fetches", 0) >= _SHARDS, json.dumps(scope))
        _check(checks, "starved_fetches_attributed",
               scope.get("starved_fetches", 0) >= _SHARDS,
               json.dumps(scope))

        # -- master-side shard telemetry -------------------------------
        telemetry.flush()
        data = telemetry.summary()
        _check(checks, "telemetry_counts_completions",
               data.get("completions") == _SHARDS, json.dumps(data))
        _check(checks, "telemetry_backlog_drained",
               data.get("backlog") == 0, json.dumps(data))
        _check(checks, "lease_p99_shows_stall",
               data.get("lease_p99_ms", 0) >= _STALL_S * 1000 * 0.8,
               json.dumps(data))
        backlog_series = store.series("job.data.backlog", res=1.0)
        _check(checks, "backlog_series_recorded",
               len(backlog_series) >= 1, f"series {backlog_series}")
        p99_series = store.series("job.data.lease_p99_ms", res=1.0)
        _check(
            checks, "lease_p99_series_spiked",
            any(p["max"] >= _STALL_S * 1000 * 0.8 for p in p99_series),
            f"series {p99_series}",
        )
        share = store.series("job.share.input_starved", res=1.0)
        _check(
            checks, "starved_share_series_spiked",
            any(p["max"] > 0.3 for p in share),
            f"share {share}",
        )

        # -- the sentinel fires and the incident classifies ------------
        actions = diagnosis.diagnose_once()
        _check(checks, "sentinel_fired",
               any(a.action_type == "event" for a in actions),
               f"actions {[a.action_type for a in actions]}")
        incidents = incident_manager.list_incidents()
        _check(
            checks, "incident_opened",
            len(incidents) == 1
            and incidents[0]["kind"] == "data_starvation",
            json.dumps(incidents),
        )
        incident_id = incidents[0]["incident_id"] if incidents else ""
        incident = incident_manager.finalize(incident_id, force=True) or {}
        _check(checks, "incident_phase_is_data",
               incident.get("phase") == "data",
               f"phase {incident.get('phase')!r}")
        fault = incident.get("chaos") or {}
        _check(checks, "incident_names_injected_fault",
               fault.get("point") == "data.lease"
               and fault.get("kind") == "delay", json.dumps(fault))

        # -- /data over real HTTP --------------------------------------
        dash = DashboardServer(
            types.SimpleNamespace(servicer=servicer), port=0
        )
        dash.start()
        try:
            url = f"http://127.0.0.1:{dash.port}/data"
            with urllib.request.urlopen(url, timeout=5) as resp:
                payload = json.loads(resp.read())
            page = payload.get("summary") or {}
            _check(checks, "data_endpoint_serves_backlog",
                   page.get("backlog") == 0
                   and page.get("completions") == _SHARDS,
                   json.dumps(payload)[:400])
            _check(checks, "data_endpoint_serves_series",
                   "job.data.backlog" in (payload.get("series") or {}),
                   json.dumps(list((payload.get("series") or {}))))
        finally:
            dash.stop()
    return {
        "ok": all(checks.values()),
        "checks": checks,
        "seed": _SEED,
    }


def main() -> int:
    result = run_smoke()
    print("DATA_SMOKE " + json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
