"""Goodput ledger: every second of wall clock attributed to one phase.

Copy of ``dlrover_tpu/observability/goodput.py``.  Per process, every
second of wall clock lands in exactly one phase of ``compute``,
``exposed_comm``, ``ckpt_stall``, ``rendezvous_restart``,
``overload_rideout``, ``live_reshard``, ``peer_restore``,
``input_starved``, ``compile`` or the unattributed ``idle_unknown``.

Wall clock is sliced into ``DLROVER_TPU_GOODPUT_RES_S`` slots; a charge
claims every slot it overlaps, and on a contested slot the
higher-priority claim wins (:data:`_CLAIMS`).  Slots beyond
``DLROVER_TPU_GOODPUT_WINDOW`` fold into cumulative per-phase totals.
Feeds: ``trace._export`` pushes finished spans (:func:`on_span`, by name
prefix), the trainer pushes step durations (:func:`on_step`) and, in the
port, charges the first step's kernel builds as ``compile``
(:func:`charge_compile_window`), and the device prefetcher charges the
loop's blocked, device-idle input waits as ``input_blocked`` (reported as
``input_starved``).  The reference has no such claim: there the trainer's
inter-step compute claim covers such a wait.  :meth:`GoodputLedger.digest`
gives the ``gp_<phase>`` keys of the per-rank digest file.
``DLROVER_TPU_GOODPUT_LEDGER=0`` turns every feed into a flag check.
"""

import threading
import time
from typing import Any, Dict, Optional, Tuple

from dlrover_tpu_torch.common import envs

#: claim priority (first wins a contested slot) -> the REPORTED phase.
#: Claims and phases are decoupled for one reason: checkpoint time has
#: two natures.  The BLOCKING portions (``flash.save`` snapshot,
#: ``flash.restore``, the shm stream) must outrank ``compute`` — the
#: trainer charges compute over the whole inter-dispatch gap, which
#: INCLUDES any in-loop blocking save, and compute winning there would
#: hide the exact stall this ledger exists to expose.  The BACKGROUND
#: portions (the saver's ``flash.persist``/``storage.*`` writers) must
#: LOSE to compute — a persist hidden behind training steps costs
#: nothing and must not show as a stall.  ``idle_unknown`` is implicit:
#: the unclaimed remainder, never charged.
_CLAIMS: Tuple[Tuple[str, str], ...] = (
    ("exposed_comm", "exposed_comm"),
    # live_reshard outranks the checkpoint claims: the in-place
    # transition's donor partial reads ride the ckpt/storage machinery,
    # and those seconds belong to the reshard window — not to a phantom
    # checkpoint stall that would muddy the live-vs-restart comparison
    ("live_reshard", "live_reshard"),
    # peer_restore outranks the checkpoint claims for the same reason:
    # the fast-recovery ladder's manifest rung rides read_slice and the
    # storage machinery, and those seconds belong to the recovery
    # window the MTTR sentinel prices — not to a checkpoint stall
    ("peer_restore", "peer_restore"),
    ("ckpt_blocking", "ckpt_stall"),
    # the port's input wait of the same BLOCKING nature: the training
    # loop stood in the device prefetcher's empty queue while the device
    # had nothing left to run (trainer/elastic/prefetch.py measures the
    # idle gap).  No step ran in those slots, so the trainer's
    # inter-dispatch compute claim must not take them; a fetch overlapped
    # by a running step stays the sharding client's input_starved below
    ("input_blocked", "input_starved"),
    ("compute", "compute"),
    ("overload_rideout", "overload_rideout"),
    ("rendezvous_restart", "rendezvous_restart"),
    # input_starved loses to exposed_comm (a comm stall that also
    # empties the prefetch is a COMM problem — never double-booked), to
    # compute (a prefetch wait hidden behind running steps costs
    # nothing, same logic as ckpt_background), and to the rideout /
    # restart claims (those are causes; starvation is their symptom).
    # It beats only the background persist and compile claims: when the
    # trainer is genuinely blocked on an empty input pipeline, that is
    # the attribution — not a cold compile racing in another thread.
    ("input_starved", "input_starved"),
    ("ckpt_background", "ckpt_stall"),
    ("compile", "compile"),
)

#: the reported phase taxonomy (claim ranks collapse into these)
PHASES: Tuple[str, ...] = (
    "exposed_comm",
    "compute",
    "overload_rideout",
    "rendezvous_restart",
    "live_reshard",
    "peer_restore",
    "input_starved",
    "ckpt_stall",
    "compile",
)

IDLE = "idle_unknown"

#: all phases a summary reports (claimable + the remainder)
ALL_PHASES: Tuple[str, ...] = PHASES + (IDLE,)

_RANK: Dict[str, int] = {name: i for i, (name, _) in enumerate(_CLAIMS)}
_PHASE_OF_RANK: Tuple[str, ...] = tuple(phase for _, phase in _CLAIMS)

#: public phase name -> the claim charged for an explicit charge()
#: (an explicit ckpt charge means the caller measured a BLOCKING wait)
_CLAIM_OF_PHASE: Dict[str, str] = {
    **{name: name for name, _ in _CLAIMS},
    "compute": "compute",
    "ckpt_stall": "ckpt_blocking",
}

#: span-name prefix -> claim (first match wins).  Deliberately narrow:
#: control-plane RPC spans (``master.*``, ``kv.*``, ``rpc.*``) fire
#: constantly from background threads and do NOT stall training — they
#: are never charged.  ``data.*`` spans are likewise absent: a shard
#: fetch usually overlaps compute (prefetch), and a span-level charge
#: would claim whole slots for micro-waits — the sharding client
#: charges ``input_starved`` explicitly, and only for blocking waits
#: past DLROVER_TPU_DATA_STARVED_MIN_S.
SPAN_PHASE: Tuple[Tuple[str, str], ...] = (
    ("flash.persist", "ckpt_background"),
    ("flash.", "ckpt_blocking"),
    ("snapshot.", "ckpt_blocking"),
    ("storage.", "ckpt_background"),
    ("reshard.", "live_reshard"),
    ("peer_restore.", "peer_restore"),
    ("ckpt", "ckpt_blocking"),
    ("rdzv", "rendezvous_restart"),
)


def _span_phase(name: str) -> str:
    for prefix, claim in SPAN_PHASE:
        if name.startswith(prefix):
            return claim
    return ""


def enabled() -> bool:
    return envs.get_bool("DLROVER_TPU_GOODPUT_LEDGER")


class GoodputLedger:
    """Per-process slotted wall-clock account.  One instance per
    process (see :func:`ledger`); tests may build private ones."""

    def __init__(self, res_s: Optional[float] = None,
                 window: Optional[int] = None,
                 origin_ts: Optional[float] = None):
        self._res = float(
            res_s if res_s is not None
            else envs.get_float("DLROVER_TPU_GOODPUT_RES_S")
        )
        if self._res <= 0:
            self._res = 1.0
        self._window = max(
            16,
            int(window if window is not None
                else envs.get_int("DLROVER_TPU_GOODPUT_WINDOW")),
        )
        self._mu = threading.Lock()
        self._origin = float(origin_ts if origin_ts else time.time())
        # live slot claims: slot index -> phase rank (lower rank wins)
        self._slots: Dict[int, int] = {}
        # slots folded out of the live window, as seconds per phase
        self._folded: Dict[str, float] = {p: 0.0 for p in PHASES}
        # charges older than the fold horizon are dropped (counted)
        self._fold_horizon = 0
        self._late_dropped = 0

    # -- charging (the hot path) -------------------------------------------

    def charge_interval(self, phase: str, start_ts: float,
                        end_ts: float) -> None:
        """Attribute ``[start_ts, end_ts)`` to ``phase`` (a public
        phase name or an internal claim).  Slots already claimed by a
        higher-priority claim keep theirs; claims in the future are
        clamped to the current slot."""
        rank = _RANK.get(_CLAIM_OF_PHASE.get(phase, phase))
        if rank is None or end_ts <= start_ts:
            return
        now = time.time()
        start_ts = max(start_ts, self._origin)
        end_ts = min(end_ts, now + self._res)
        if end_ts <= start_ts:
            return
        res = self._res
        # normalize BEFORE the end-exclusive epsilon: subtracting 1e-9
        # from an absolute epoch (~1.7e9) is below float precision
        rel0 = start_ts - self._origin
        rel1 = max(rel0, (end_ts - self._origin) - 1e-9)
        i0 = int(rel0 / res)
        i1 = int(rel1 / res)
        with self._mu:
            if i0 < self._fold_horizon:
                self._late_dropped += 1
                i0 = self._fold_horizon
                if i1 < i0:
                    return
            slots = self._slots
            for i in range(i0, i1 + 1):
                held = slots.get(i)
                if held is None or rank < held:
                    slots[i] = rank
            if len(slots) > self._window:
                self._fold_locked()

    def charge(self, phase: str, dur_s: float,
               end_ts: Optional[float] = None) -> None:
        """Attribute the ``dur_s`` seconds ENDING at ``end_ts`` (now by
        default) — the shape step/sleep instrumentation produces."""
        end = end_ts if end_ts is not None else time.time()
        self.charge_interval(phase, end - dur_s, end)

    def _fold_locked(self) -> None:
        """Fold the oldest quarter of live slots into the cumulative
        per-phase totals (under the lock)."""
        keep = int(self._window * 0.75)
        excess = sorted(self._slots)[: max(0, len(self._slots) - keep)]
        for i in excess:
            rank = self._slots.pop(i)
            self._folded[_PHASE_OF_RANK[rank]] += self._res
            if i >= self._fold_horizon:
                self._fold_horizon = i + 1

    # -- feeds --------------------------------------------------------------

    def on_span(self, record: Dict[str, Any]) -> None:
        """A finished SPAN record (``trace.Span.to_record`` shape):
        charged when its name maps to a phase."""
        phase = _span_phase(str(record.get("name", "")))
        if not phase:
            return
        ts = float(record.get("ts", 0.0))
        dur = float(record.get("dur", 0.0))
        if ts <= 0 or dur <= 0:
            return
        self.charge_interval(phase, ts, ts + dur)

    def on_step(self, step: int, dur_s: float) -> None:
        """One finished training step of ``dur_s`` seconds ending now."""
        if dur_s > 0:
            self.charge("compute", float(dur_s))

    # -- reading ------------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        """The full-job account: per-phase seconds (folded + live),
        wall clock since origin, the compute share (``goodput``) and the
        dominant non-idle phase.  ``idle_unknown`` is the remainder, so
        the phases always sum to the wall clock (to within one slot)."""
        now = time.time()
        with self._mu:
            seconds = dict(self._folded)
            for rank in self._slots.values():
                seconds[_PHASE_OF_RANK[rank]] += self._res
            late = self._late_dropped
        wall = max(0.0, now - self._origin)
        attributed = sum(seconds.values())
        seconds[IDLE] = max(0.0, wall - attributed)
        dominant = max(PHASES, key=lambda p: seconds[p])
        out = {
            "wall_s": round(wall, 6),
            "res_s": self._res,
            "origin_ts": round(self._origin, 6),
            "phases": {p: round(seconds[p], 6) for p in ALL_PHASES},
            "attributed_s": round(min(attributed, wall + self._res), 6),
            "goodput": round(
                max(0.0, min(1.0, seconds["compute"] / wall)), 6
            ) if wall > 0 else 0.0,
            "dominant": dominant if seconds[dominant] > 0 else IDLE,
        }
        if late:
            out["late_dropped"] = late
        return out

    def digest(self) -> Dict[str, float]:
        """Flat cumulative account for the heartbeat digest channel
        (``comm.HeartBeat.digest`` carries ``Dict[str, float]``):
        ``gp_<phase>`` seconds + ``gp_wall``.  Cumulative counters are
        robust to missed heartbeats — the master differentiates."""
        s = self.summary()
        out = {f"gp_{p}": s["phases"][p] for p in ALL_PHASES}
        out["gp_wall"] = s["wall_s"]
        return out


_LEDGER: Optional[GoodputLedger] = None
_LEDGER_MU = threading.Lock()


def ledger() -> GoodputLedger:
    """The process singleton every feed writes to."""
    global _LEDGER
    if _LEDGER is None:
        with _LEDGER_MU:
            if _LEDGER is None:
                _LEDGER = GoodputLedger()
    return _LEDGER


def reset_ledger(origin_ts: Optional[float] = None) -> GoodputLedger:
    """Replace the singleton (tests, per-scenario drill isolation);
    re-reads the resolution/window knobs.  ``origin_ts`` backdates the
    account's wall-clock origin (tests charging synthetic windows that
    started before the reset)."""
    global _LEDGER
    with _LEDGER_MU:
        _LEDGER = GoodputLedger(origin_ts=origin_ts)
        return _LEDGER


# -- feed helpers (called from trace/trainer/master_client; every caller
# wraps in try/except so the ledger can never break the host) ---------------


def on_span(record: Dict[str, Any]) -> None:
    if enabled():
        ledger().on_span(record)


def on_step(step: int, dur_s: float) -> None:
    if enabled():
        ledger().on_step(step, dur_s)


def charge(phase: str, dur_s: float, end_ts: Optional[float] = None) -> None:
    if enabled():
        ledger().charge(phase, dur_s, end_ts)


def charge_interval(phase: str, start_ts: float, end_ts: float) -> None:
    if enabled():
        ledger().charge_interval(phase, start_ts, end_ts)


def charge_compile_window(start_ts: float, end_ts: float,
                          compile_s: Optional[float] = None) -> None:
    """Attribute a first-dispatch window with MEASURED compile seconds.

    The old heuristic charged the ENTIRE first-dispatch window to
    ``compile`` — but that window also contains the dispatch itself and
    the first step's execution, and anything overlapping it (a
    checkpoint restore, a rendezvous tail) was mis-billed.  With the
    compile observatory's measured seconds the split is exact: the
    first ``compile_s`` seconds are ``compile``, the remainder is the
    step execution (``compute``).  Higher-priority claims (a blocking
    restore span) still win their slots.  ``compile_s`` None/overlong
    falls back to the whole-window charge (jitscope off or broken)."""
    if not enabled() or end_ts <= start_ts:
        return
    window = end_ts - start_ts
    if compile_s is None or compile_s <= 0 or compile_s >= window:
        ledger().charge_interval("compile", start_ts, end_ts)
        return
    split = start_ts + compile_s
    ledger().charge_interval("compile", start_ts, split)
    ledger().charge_interval("compute", split, end_ts)
