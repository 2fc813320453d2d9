"""The scripted scenario library the recovery drill runs.

Each scenario is a factory returning a :class:`ChaosPlan` for a given
seed — a *description* of which injection points misbehave and when,
decoupled from the drill harness that asserts recovery invariants
(``diagnosis/chaos_drill.py``).  Keeping plans declarative
means a scenario can also be armed on a real job through
``DLROVER_TPU_CHAOS_SPEC`` (the plans serialize to JSON).

Scenario catalog (copy of ``dlrover_tpu/chaos/scenarios.py``; the
port's drill runs every scenario but ``fabric_reroute``, which waits for
the modules it drives, see ``diagnosis/chaos_drill.py``):

=====================  =====================================================
``master_restart``     master process dies mid-save; agents ride the retry
                       policy through the restart window
``torn_shm``           the shm stream is killed mid-write; restore must
                       reject the torn snapshot and fall back to storage
``storage_stall``      persist writes stall (slow NFS/GCS); the save path
                       stays bounded and the commit still lands
``storage_crc``        persisted chunk bytes are corrupted (torn write);
                       CRC verification must refuse the step on restore
``node_flap``          a node joins rendezvous, vanishes, rejoins; the
                       round still seals with the flapping node included
``kv_timeout``         kv long-poll chunks black-hole during a barrier
                       window; the barrier completes once it passes
``heartbeat_loss``     agent heartbeats are swallowed long enough to cross
                       the no-heartbeat threshold, then recover
``torn_commit``        a writer host dies between persisting its shards and
                       its phase-1 manifest report, then the coordinator
                       dies at phase-2; the step never seals and restore
                       lands bit-exact on the previous committed step
``slow_link``          one mesh axis gains a seeded injected latency (the
                       simulated DCN slice boundary); the active mesh
                       probe must price the asymmetry, the slow-link
                       sentinel must fire, and the incident must name the
                       axis with ``phase=comm``
``dcn_slow_link``      the slice boundary itself degrades: every
                       cross-slice exchange (hierarchical DCN leg, flat
                       combined collective, slice-axis probe) pays a
                       static injected latency via
                       ``comm.axis_delay.slice`` — the link price the
                       hierarchy smoke beats flat mode under
``fabric_reroute``     a healthy probe window commits a dual-fabric
                       striped plan, then ``comm.axis_delay.slice``
                       degrades the DCN boundary; the fabric tuner must
                       re-route the stripe off the slow axis (plan swap)
                       BEFORE the quantization-demotion backstop fires
``live_reshard``       a node flap opens a rendezvous-restart window on
                       the legacy path (measured as the baseline), then
                       the same transition is replayed as a Brain-
                       ordered LIVE in-place reshard: bit-exact
                       continuation, an incident proving no restart,
                       and a ledger showing the live path an order of
                       magnitude cheaper than the restart it replaced
``peer_restore``       a node dies at dp>=4 and the replacement pulls the
                       lost shards straight from surviving peers' shm:
                       torn peer payloads force the retry-then-demote
                       protocol, dropped fetches push single shards down
                       to the sealed-manifest rung, and the continuation
                       must stay bit-exact with zero full-storage
                       restores and zero cold compiles
``hbm_leak``           the memory observatory's reported in-use bytes
                       inflate cumulatively every sample after a healthy
                       window (a synthetic leak); the forecast sentinel
                       must open an ``hbm_leak`` incident with
                       ``phase=mem`` STRICTLY BEFORE the injected OOM
                       threshold, and the post-mortem hbm_oom incident
                       must record that the forecast had breached
``data_starved``       every shard lease pays an injected delay at the
                       master's ``data.lease`` point; workers block on an
                       empty prefetch, the ledger books the stall to
                       ``input_starved`` (dominating non-compute), and
                       the starvation sentinel opens a ``phase=data``
                       incident naming the injected point
=====================  =====================================================
"""

from typing import Callable, Dict

from dlrover_tpu_torch.chaos.engine import (
    DELAY,
    DROP,
    EXCEPTION,
    FLAP,
    TORN_WRITE,
    ChaosPlan,
    FaultSpec,
)


def _master_restart(seed: int) -> ChaosPlan:
    # The transport drops a contiguous window of master RPCs — exactly
    # what agents observe while a master respawns on the same port.
    return ChaosPlan(
        name="master_restart",
        seed=seed,
        faults=[
            FaultSpec(
                point="master_client.transport",
                kind=EXCEPTION,
                on_calls=[4, 5, 6],
                message="chaos: master restarting (connection refused)",
            ),
        ],
    )


def _torn_shm(seed: int) -> ChaosPlan:
    return ChaosPlan(
        name="torn_shm",
        seed=seed,
        faults=[
            FaultSpec(
                point="snapshot.stream_chunk",
                kind=EXCEPTION,
                after=2,
                times=1,
                message="chaos: stager killed mid-stream",
            ),
        ],
    )


def _storage_stall(seed: int) -> ChaosPlan:
    return ChaosPlan(
        name="storage_stall",
        seed=seed,
        faults=[
            FaultSpec(
                point="storage.write",
                kind=DELAY,
                delay_s=0.5,
                times=3,
            ),
        ],
    )


def _storage_crc(seed: int) -> ChaosPlan:
    return ChaosPlan(
        name="storage_crc",
        seed=seed,
        faults=[
            FaultSpec(
                point="storage.write_chunk",
                kind=TORN_WRITE,
                on_calls=[1],
            ),
        ],
    )


def _node_flap(seed: int) -> ChaosPlan:
    return ChaosPlan(
        name="node_flap",
        seed=seed,
        faults=[
            FaultSpec(
                point="rdzv.join",
                kind=FLAP,
                on_calls=[1],
                flap_count=2,
            ),
        ],
    )


def _live_reshard(seed: int) -> ChaosPlan:
    # Same fault shape as node_flap — the flap is what opens the
    # rendezvous-restart window the drill prices as the BASELINE leg;
    # the live leg then replays the identical transition in place and
    # must never touch rdzv.join at all.
    return ChaosPlan(
        name="live_reshard",
        seed=seed,
        faults=[
            FaultSpec(
                point="rdzv.join",
                kind=FLAP,
                on_calls=[1],
                flap_count=2,
            ),
        ],
    )


def _kv_timeout(seed: int) -> ChaosPlan:
    # kv_store.wait is the client's long-poll chunk point (r11): a DROP
    # reads as "chunk expired without the key", exactly what a
    # master-side wait timeout looks like to the caller
    return ChaosPlan(
        name="kv_timeout",
        seed=seed,
        faults=[
            # the first 4 chunks expire faultily (after=0: a long-poll
            # issues ONE chunk unless it expires, so the window must
            # start at the first call), then the real wait completes
            FaultSpec(
                point="kv_store.wait",
                kind=DROP,
                after=0,
                times=4,
            ),
        ],
    )


def _heartbeat_loss(seed: int) -> ChaosPlan:
    return ChaosPlan(
        name="heartbeat_loss",
        seed=seed,
        faults=[
            FaultSpec(
                point="agent.heartbeat",
                kind=DROP,
                after=2,
                times=5,
            ),
        ],
    )


def _torn_commit(seed: int) -> ChaosPlan:
    # The drill runs three committed-save rounds of a 2-host job (host
    # phase-1 report call indices, 0-based: 0,1 = step A, 2,3 = step B,
    # 4,5 = step C).  Step B: BOTH hosts die after persisting shard
    # bytes but before reporting (drops 2,3) — the step must never
    # seal.  Step C: the coordinator dies at its 2nd seal attempt
    # (phase-2 exception, call index 1); a re-reported manifest retries
    # the seal and commits.
    return ChaosPlan(
        name="torn_commit",
        seed=seed,
        faults=[
            FaultSpec(
                point="ckpt.phase1_report",
                kind=DROP,
                on_calls=[2, 3],
            ),
            FaultSpec(
                point="ckpt.phase2_commit",
                kind=EXCEPTION,
                on_calls=[1],
                message="chaos: coordinator killed at phase-2 commit",
            ),
        ],
    )


def _slow_link(seed: int) -> ChaosPlan:
    # The probe fires comm.axis_delay.dp once per probe round: the
    # first 4 rounds establish the healthy baseline, then every later
    # round pays the injected per-axis latency — a degraded link (or a
    # DCN slice boundary) on exactly one mesh axis.
    return ChaosPlan(
        name="slow_link",
        seed=seed,
        faults=[
            FaultSpec(
                point="comm.axis_delay.dp",
                kind=DELAY,
                delay_s=0.05,
                after=4,
            ),
        ],
    )


def _dcn_slow_link(seed: int) -> ChaosPlan:
    # The slice boundary degrades: every cross-slice exchange (the
    # hierarchical grad sync's DCN leg, the flat baseline's combined
    # collective, the commscope probe's slice-axis window) pays an
    # extra injected latency via comm.axis_delay.slice.  Fires from
    # the first call — the simulated-DCN benches use it as a STATIC
    # link price; pair with after= in ad-hoc plans for a baseline.
    return ChaosPlan(
        name="dcn_slow_link",
        seed=seed,
        faults=[
            FaultSpec(
                point="comm.axis_delay.slice",
                kind=DELAY,
                delay_s=0.002,
            ),
        ],
    )


def _fabric_reroute(seed: int) -> ChaosPlan:
    # The r21 re-route drill: a healthy window (4 clean probe rounds /
    # tolled exchanges) lets the fabric tuner commit a dual-fabric
    # striped plan, then the slice boundary degrades — every later
    # comm.axis_delay.slice crossing pays a 4 ms injected latency, far
    # past the slow-link breach threshold.  The expected cure is the
    # CHEAP one: the tuner re-routes the stripe off the degraded DCN
    # (a plan swap at the next train_step) BEFORE the quantization
    # demotion backstop fires.
    return ChaosPlan(
        name="fabric_reroute",
        seed=seed,
        faults=[
            FaultSpec(
                point="comm.axis_delay.slice",
                kind=DELAY,
                delay_s=0.004,
                after=4,
            ),
        ],
    )


def _hbm_leak(seed: int) -> ChaosPlan:
    # The memory observatory fires mem.pressure once per sample: the
    # first 4 samples establish the healthy baseline, then every later
    # sample inflates the reported in-use bytes by a cumulative
    # DLROVER_TPU_MEM_CHAOS_INFLATE_B — a deterministic synthetic leak
    # whose slope the forecast sentinel must price before the inflated
    # figure crosses the chip limit (the injected OOM threshold).
    return ChaosPlan(
        name="hbm_leak",
        seed=seed,
        faults=[
            FaultSpec(
                point="mem.pressure",
                kind=DROP,
                after=4,
            ),
        ],
    )


def _peer_restore(seed: int) -> ChaosPlan:
    # The replacement host's second peer fetch returns a torn payload
    # (crc mismatch under a moving seqlock): the restorer must retry
    # that read ONCE against the same donor — and the retry, which the
    # plan leaves clean, succeeds, so the recovery stays on the peer
    # rung with zero storage reads and no demotion.  Recurring short
    # serve-side delays price the MTTR ledger without blowing the drill
    # budget.  (Demote-after-second-tear and drop->manifest-rung are
    # pinned by tests/test_peer_restore.py, which arms its own plans.)
    return ChaosPlan(
        name="peer_restore",
        seed=seed,
        faults=[
            FaultSpec(
                point="peer.fetch",
                kind=TORN_WRITE,
                on_calls=[2],
                times=1,
            ),
            FaultSpec(
                point="peer.serve",
                kind=DELAY,
                delay_s=0.02,
                every=4,
                times=3,
            ),
        ],
    )


def _cache_cold(seed: int) -> ChaosPlan:
    # The compile observatory fires jitscope.compile inside every
    # detected compile window: the first two boots (cold first trace,
    # warm persistent-cache restart) stay clean, then the cache-wiped
    # third boot's recompile pays an injected DELAY — deterministic
    # extra compile seconds the cache-cold sentinel and the goodput
    # ledger must both price.
    return ChaosPlan(
        name="cache_cold",
        seed=seed,
        faults=[
            FaultSpec(
                point="jitscope.compile",
                kind=DELAY,
                delay_s=0.05,
                after=2,
            ),
        ],
    )


def _data_starved(seed: int) -> ChaosPlan:
    # The data observatory: every shard lease pays an injected DELAY
    # at the master's data.lease point (fired OUTSIDE the dispatch
    # lock, so only the faulted lease stalls) — workers block on an
    # empty prefetch, the ledger books input_starved, and the
    # starvation sentinel opens a phase=data incident naming the
    # point.
    return ChaosPlan(
        name="data_starved",
        seed=seed,
        faults=[
            FaultSpec(
                point="data.lease",
                kind=DELAY,
                delay_s=0.4,
                times=6,
            ),
        ],
    )


SCENARIOS: Dict[str, Callable[[int], ChaosPlan]] = {
    "master_restart": _master_restart,
    "torn_shm": _torn_shm,
    "storage_stall": _storage_stall,
    "storage_crc": _storage_crc,
    "node_flap": _node_flap,
    "live_reshard": _live_reshard,
    "kv_timeout": _kv_timeout,
    "heartbeat_loss": _heartbeat_loss,
    "torn_commit": _torn_commit,
    "slow_link": _slow_link,
    "dcn_slow_link": _dcn_slow_link,
    "fabric_reroute": _fabric_reroute,
    "hbm_leak": _hbm_leak,
    "cache_cold": _cache_cold,
    "peer_restore": _peer_restore,
    "data_starved": _data_starved,
}


def scenario_plan(name: str, seed: int = 0) -> ChaosPlan:
    try:
        factory = SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown chaos scenario {name!r}; have {sorted(SCENARIOS)}"
        ) from None
    return factory(seed)
