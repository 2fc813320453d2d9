"""Memory observatory: device bytes attributed to owning subsystems.

Port of ``dlrover_tpu/observability/memscope.py``: the byte-side mirror of
the goodput ledger.  :class:`MemScope` (process singleton, :func:`scope`)
samples the device the trainer binds (:func:`device_mem_stats`: on the
card its allocator's bytes in use and their peak,
``torch.cuda.memory_stats``, and its total, ``torch.cuda.mem_get_info``;
on the CPU the bytes of the live CPU tensors, each storage once, the
counterpart of the reference's ``jax.live_arrays`` fallback), the host's
RSS and the registered host byte sources (the flash engine's shm segment,
``ckpt_shm:<name>``), and renders the **account**: device bytes attributed
to

``params`` / ``optimizer`` / ``ef_residual``
    from the registered train state (:meth:`MemScope.register_state`):
    each leaf's per-chip bytes are its global bytes over the product of
    the mesh axes that split it.  The port reads those axes from the
    trainer (``Trainer.state_axes``: the placements of the mesh, and the
    dp split of a sharded update's moments and of the residuals) where
    the reference reads each leaf's ``PartitionSpec``;
``grad_sync``
    the bucketed sync's ``(world, width)`` fp32 exchange buffers
    (:meth:`MemScope.register_buckets`);
``compile_workspace``
    the first step's live-buffer delta (:meth:`MemScope.note_compile_delta`;
    the port compiles nothing, so this is what its first step leaves
    allocated, the libraries' workspaces);
``other``
    the explicit remainder, so the account sums to the bytes in use.  With
    ``grads_dtype`` the port's model holds a persistent bf16 compute copy
    of the fp32 masters, which the reference does not keep; it has no
    subsystem of its own, so it lands here,

with ``headroom`` = limit - used when the limit is known.  The flat digest
(``mm_*`` / ``mms_*``, :meth:`MemScope.digest`) rides the rank's digest
file; an agent folds several ranks' files with :func:`merge_digest`.
:func:`fit_report` prices a proposed mesh layout against the measured
limit.

Everything is guarded: a broken sampler never breaks a training step, and
``DLROVER_TPU_MEM_SCOPE=0`` turns every hook into a flag check.

Chaos: the :data:`PRESSURE_POINT` injection point fires inside every
sample; a seeded fault there (the ``hbm_leak`` drill scenario) inflates
the reported in-use bytes by a cumulative
``DLROVER_TPU_MEM_CHAOS_INFLATE_B`` per firing — a deterministic
synthetic leak.
"""

import gc
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.metric import card_memory
from dlrover_tpu_torch.common.pytree import flatten_with_path
from dlrover_tpu_torch.device import DeviceLike, resolve_device

#: chaos injection point: fires inside every sample; a seeded fault
#: here is an injected synthetic memory-stats inflation (the leak the
#: ``hbm_leak`` drill scenario manufactures)
PRESSURE_POINT = "mem.pressure"

#: digest-key schema (flat floats riding ``comm.HeartBeat.digest``).
#: Scalars: ``mm_<field>``; per-subsystem bytes: ``mms_<subsystem>``.
#: The agent merges rank files per :data:`DIGEST_MERGE` — worst-chip
#: semantics (max used/peak, min limit/headroom) except host RSS, which
#: SUMS (each rank is its own process).
DIGEST_PREFIX = "mm_"
DIGEST_SUB = "mms_"

#: digest key -> merge rule across one host's rank files
#: (``elastic_agent._collect_digest``): "max" | "min" | "sum"
DIGEST_MERGE: Dict[str, str] = {
    "mm_ts": "max",
    "mm_used_b": "max",
    "mm_peak_b": "max",
    "mm_limit_b": "min",
    "mm_rss_b": "sum",
    "mm_shm_b": "max",
}

#: the subsystem taxonomy, attribution order.  ``other`` is the
#: explicit remainder, so the account sums to ``bytes_in_use``.
SUBSYSTEMS: Tuple[str, ...] = (
    "params",
    "optimizer",
    "ef_residual",
    "grad_sync",
    "compile_workspace",
    "other",
)

#: bytes_limit on backends that do not report one
UNKNOWN_LIMIT = 0.0


def enabled() -> bool:
    return envs.get_bool("DLROVER_TPU_MEM_SCOPE")


def merge_digest(dst: Dict[str, float], src: Dict[str, Any]) -> None:
    """Fold one rank file's ``mm_*``/``mms_*`` keys into a host digest
    per :data:`DIGEST_MERGE` (subsystem bytes take the worst chip:
    max)."""
    for key, value in src.items():
        if key.startswith(DIGEST_SUB):
            dst[key] = max(dst.get(key, 0.0), float(value))
            continue
        if not key.startswith(DIGEST_PREFIX):
            continue
        rule = DIGEST_MERGE.get(key, "max")
        value = float(value)
        if rule == "sum":
            dst[key] = dst.get(key, 0.0) + value
        elif rule == "min":
            dst[key] = value if key not in dst else min(dst[key], value)
        else:
            dst[key] = max(dst.get(key, 0.0), value)


# ---------------------------------------------------------------------------
# Device + host byte sources.
# ---------------------------------------------------------------------------


def device_mem_stats(device: DeviceLike = None) -> List[Dict[str, float]]:
    """``[{device, used_b, limit_b, peak_b, source}]`` of the device
    given (the card by default).

    Honesty order (the ``common/metric.py`` contract: unknown is never
    zero): on a card, its allocator's bytes in use and their peak
    (``torch.cuda.memory_stats``) and its total memory
    (``torch.cuda.mem_get_info``), ``source="memory_stats"``; on the CPU,
    the bytes of the live CPU tensors, each storage counted once
    (``source="live_tensors"``), with the limit from
    ``DLROVER_TPU_MEM_CPU_LIMIT_B`` (0: unknown) and the peak unknown
    (0)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        index = (dev.index if dev.index is not None
                 else torch.cuda.current_device())
        return [dict(device=index, **card_memory(index),
                     source="memory_stats")]
    return [{
        "device": 0,
        "used_b": _live_tensor_bytes(),
        "limit_b": float(envs.get_float("DLROVER_TPU_MEM_CPU_LIMIT_B")),
        "peak_b": 0.0,
        "source": "live_tensors",
    }]


def _live_tensor_bytes() -> float:
    """Bytes of the live CPU tensors' storages, each counted once (views
    share one): the CPU's in-use figure."""
    seen: Dict[Tuple[int, int], float] = {}
    for obj in gc.get_objects():
        # type(), not isinstance: the objects include lazy module proxies
        # that warn when their __class__ is read
        if not issubclass(type(obj), torch.Tensor):
            continue
        try:
            if obj.device.type != "cpu" or obj.is_meta:
                continue
            storage = obj.untyped_storage()
            seen[(storage.data_ptr(), storage.nbytes())] = float(
                storage.nbytes())
        except Exception:  # noqa: BLE001 - a tensor without storage
            continue  # (sparse, a wrapper subclass) is not evidence
    return sum(seen.values())


def host_rss_bytes() -> float:
    """This process's resident set size (bytes); 0 when unreadable."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) * 1024.0
    except OSError:
        pass
    try:
        import resource

        usage = resource.getrusage(resource.RUSAGE_SELF)
        return float(usage.ru_maxrss) * 1024.0
    except Exception:  # noqa: BLE001 - rss is best-effort
        return 0.0
    return 0.0


# ---------------------------------------------------------------------------
# The state plan: classified leaves with sharding-aware pricing.
# ---------------------------------------------------------------------------


def _leaf_nbytes(leaf: Any) -> float:
    """Bytes of a tensor leaf where it lives; 0 for anything else (the
    optimizer counts are Python ints on the host)."""
    if not torch.is_tensor(leaf):
        return 0.0
    return float(leaf.numel() * leaf.element_size())


class StatePlan:
    """The registered train state, classified and priced.

    ``leaves``: ``{path, subsystem, global_b, axes}`` records where
    ``axes`` are the mesh axes sharding that leaf.  ``mesh_axes`` is
    the CURRENT axis->size map, so :meth:`per_chip` prices today's
    layout and :func:`fit_report` reprices a proposed one."""

    def __init__(self, leaves: List[Dict[str, Any]],
                 mesh_axes: Dict[str, int]):
        self.leaves = leaves
        self.mesh_axes = {str(a): int(s) for a, s in mesh_axes.items()}

    def per_chip(
        self, mesh_axes: Optional[Dict[str, int]] = None
    ) -> Dict[str, float]:
        """Per-chip bytes per subsystem under ``mesh_axes`` (default:
        the registered layout).  An axis absent from the proposed map
        keeps its registered size; size floors at 1."""
        axes = dict(self.mesh_axes)
        if mesh_axes:
            axes.update(
                {str(a): int(s) for a, s in mesh_axes.items()}
            )
        out: Dict[str, float] = {}
        for leaf in self.leaves:
            factor = 1.0
            for axis in leaf["axes"]:
                factor *= max(1, int(axes.get(axis, 1)))
            out[leaf["subsystem"]] = out.get(
                leaf["subsystem"], 0.0
            ) + leaf["global_b"] / factor
        return out

    def total_global(self) -> float:
        return sum(leaf["global_b"] for leaf in self.leaves)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "mesh_axes": dict(self.mesh_axes),
            "leaves": len(self.leaves),
            "global_b": round(self.total_global(), 1),
            "per_chip_b": {
                k: round(v, 1) for k, v in self.per_chip().items()
            },
        }


def plan_from_state(state: Any,
                    mesh_axes: Optional[Dict[str, int]] = None,
                    leaf_axes: Optional[Dict[str, List[str]]] = None
                    ) -> StatePlan:
    """Classify a ``TrainState`` into the subsystem taxonomy and price
    each leaf.  Top-level fields map to subsystems (``params`` -> params,
    ``opt_state`` -> optimizer, ``ef_residual`` -> ef_residual); a state
    without them is all params.

    Each leaf's global bytes are its local tensor's bytes times the sizes
    of the mesh axes that split it: ``leaf_axes`` (``{path: [axis, ...]}``
    by the leaf's path in the state, ``Trainer.state_axes``) names them
    where the reference reads a leaf's ``PartitionSpec``, and
    ``mesh_axes`` gives their sizes.  Leaves that are not tensors (the
    step, the optimizer counts) hold no device bytes and are skipped."""
    field_map = {
        "params": "params",
        "opt_state": "optimizer",
        "ef_residual": "ef_residual",
    }
    axes_seen = {str(a): int(s) for a, s in (mesh_axes or {}).items()}
    leaf_axes = leaf_axes or {}
    groups: List[Tuple[str, str, Any]] = []
    for field, subsystem in field_map.items():
        sub = getattr(state, field, None)
        if sub is not None:
            groups.append((field, subsystem, sub))
    if not any(hasattr(state, field) for field in field_map):
        groups.append(("", "params", state))
    leaves: List[Dict[str, Any]] = []
    for field, subsystem, subtree in groups:
        for path, leaf in flatten_with_path(subtree, field):
            nbytes = _leaf_nbytes(leaf)
            if nbytes <= 0:
                continue
            axes = [str(a) for a in leaf_axes.get(path, ())]
            factor = math.prod(max(1, axes_seen.get(a, 1)) for a in axes)
            leaves.append({
                "path": path,
                "subsystem": subsystem,
                "global_b": nbytes * factor,
                "axes": axes,
            })
    return StatePlan(leaves, axes_seen)


# ---------------------------------------------------------------------------
# Fit check: does a proposed layout fit measured limits?
# ---------------------------------------------------------------------------


def fit_report(
    plan: Dict[str, Any],
    state_plan: Optional[StatePlan] = None,
    limit_b: Optional[float] = None,
    overhead_b: Optional[float] = None,
    margin_frac: Optional[float] = None,
) -> Dict[str, Any]:
    """Price a proposed mesh/state layout against MEASURED per-chip
    limits — the elastic-decision gate ("does dp2 fit on the surviving
    chips?") answered from the registered state plan and the sampled
    device limits instead of a static HBM table.

    ``plan``: ``{"mesh_axes": {axis: size, ...}}`` (sizes for any axis
    not named keep their registered value).  ``state_plan`` /
    ``limit_b`` / ``overhead_b`` default to the process scope's
    registered plan, its worst measured chip limit, and its measured
    non-state bytes (other + compile workspace) — callers with master-
    side measurements (Brain, the reshard planner) pass their own.

    Returns ``{"fits", "projected_b", "limit_b", "budget_b",
    "margin_frac", "per_subsystem", "headroom_b", "reason"}``."""
    sc = scope()
    if state_plan is None:
        state_plan = sc.state_plan()
    if margin_frac is None:
        margin_frac = envs.get_float("DLROVER_TPU_MEM_FIT_MARGIN")
    margin_frac = min(max(float(margin_frac), 0.0), 0.9)
    account = sc.account()
    if limit_b is None:
        limit_b = float((account or {}).get("limit_b", 0.0) or 0.0)
    if overhead_b is None:
        subs = (account or {}).get("subsystems", {})
        overhead_b = float(subs.get("other", 0.0)) + float(
            subs.get("compile_workspace", 0.0)
        ) + float(subs.get("grad_sync", 0.0))
    mesh_axes = dict((plan or {}).get("mesh_axes") or {})
    if state_plan is None:
        return {
            "fits": False,
            "reason": "no registered state plan to price",
            "projected_b": 0.0,
            "limit_b": round(float(limit_b), 1),
            "margin_frac": margin_frac,
        }
    per_sub = state_plan.per_chip(mesh_axes)
    projected = sum(per_sub.values()) + float(overhead_b)
    budget = float(limit_b) * (1.0 - margin_frac)
    fits = limit_b > 0 and projected <= budget
    reason = ""
    if limit_b <= 0:
        reason = "no measured per-chip limit (unknown backend)"
    elif not fits:
        reason = (
            f"projected {projected / 2**30:.2f}GiB exceeds budget "
            f"{budget / 2**30:.2f}GiB (limit {limit_b / 2**30:.2f}GiB "
            f"- {margin_frac:.0%} margin)"
        )
    return {
        "fits": bool(fits),
        "projected_b": round(projected, 1),
        "limit_b": round(float(limit_b), 1),
        "budget_b": round(budget, 1),
        "margin_frac": margin_frac,
        "overhead_b": round(float(overhead_b), 1),
        "per_subsystem": {k: round(v, 1) for k, v in per_sub.items()},
        "headroom_b": round(budget - projected, 1),
        "mesh_axes": {
            **state_plan.mesh_axes, **{
                str(a): int(s) for a, s in mesh_axes.items()
            },
        },
        "reason": reason,
    }


# ---------------------------------------------------------------------------
# The process scope.
# ---------------------------------------------------------------------------


class MemScope:
    """Per-process memory-ledger owner (see :func:`scope`)."""

    def __init__(self,
                 stats_reader: Optional[
                     Callable[[], List[Dict[str, float]]]
                 ] = None):
        self._mu = threading.Lock()
        self._stats_reader = stats_reader
        # the device sampled (the trainer binds its own); None: the card
        self._device: DeviceLike = None
        self._state_plan: Optional[StatePlan] = None
        self._grad_sync_b = 0.0
        self._compile_b = 0.0
        # name -> callable returning current bytes (the flash engine's
        # shm segment registers here)
        self._host_providers: Dict[str, Callable[[], float]] = {}
        # cumulative injected inflation (the chaos synthetic leak)
        self._inflate_b = 0.0
        self._peak_b = 0.0
        self._last: Optional[Dict[str, Any]] = None
        self.samples_done = 0

    # -- registration (trainer/engine hooks) --------------------------------

    def bind_device(self, device: DeviceLike) -> None:
        """Sample ``device`` from now on (the trainer's)."""
        with self._mu:
            self._device = device

    def register_state(self, state: Any,
                       mesh_axes: Optional[Dict[str, int]] = None,
                       leaf_axes: Optional[Dict[str, List[str]]] = None
                       ) -> Optional[StatePlan]:
        """Adopt a live train state as the attribution plan
        (:func:`plan_from_state`).  Never raises into the caller (a
        training step)."""
        try:
            plan = plan_from_state(state, mesh_axes, leaf_axes)
        except Exception as e:  # noqa: BLE001 - attribution must not
            logger.debug("memscope state plan failed: %s", e)  # break
            return None  # training
        with self._mu:
            self._state_plan = plan
        return plan

    def state_plan(self) -> Optional[StatePlan]:
        with self._mu:
            return self._state_plan

    def register_buckets(self, buckets: Any, world: int) -> None:
        """Price the bucketed grad-sync device buffers: each bucket's
        fused exchange buffer is a ``(world, width)`` fp32 array per
        device."""
        try:
            total = sum(
                4.0 * int(world) * int(b.width)
                for b in getattr(buckets, "buckets", [])
            )
        except Exception as e:  # noqa: BLE001
            logger.debug("memscope bucket pricing failed: %s", e)
            return
        with self._mu:
            self._grad_sync_b = total

    def note_compile_delta(self, before_b: float, after_b: float) -> None:
        """The first step's live-buffer delta (device bytes right before
        and right after it, where the reference measures its first
        dispatch): what the first step leaves allocated that the state
        plan cannot see (the libraries' workspaces)."""
        with self._mu:
            self._compile_b = max(0.0, float(after_b) - float(before_b))

    def register_host_provider(self, name: str,
                               fn: Callable[[], float]) -> None:
        """A host-memory byte source (e.g. the flash engine's shm
        snapshot segment); read at sample time, errors read as 0."""
        with self._mu:
            self._host_providers[str(name)] = fn

    def deregister_host_provider(self, name: str) -> None:
        with self._mu:
            self._host_providers.pop(str(name), None)

    # -- sampling ------------------------------------------------------------

    def device_used_bytes(self) -> float:
        """Worst-chip in-use bytes right now (no account render) — the
        trainer's compile-window probe."""
        stats = self._read_stats()
        return max((s["used_b"] for s in stats), default=0.0)

    def _read_stats(self) -> List[Dict[str, float]]:
        reader = self._stats_reader
        if reader is None:
            with self._mu:
                device = self._device

            def reader():
                return device_mem_stats(device)
        try:
            return list(reader() or [])
        except Exception as e:  # noqa: BLE001 - sampling is best-effort
            logger.debug("memscope device stats failed: %s", e)
            return []

    def sample(self) -> Dict[str, Any]:
        """One full sample: device stats + host RSS/shm + the rendered
        subsystem account.  Returns (and stores) the account dict."""
        from dlrover_tpu_torch import chaos

        now = time.time()
        stats = self._read_stats()
        # an EXCEPTION fault here propagates (the injected behavior);
        # DROP/DELAY faults return and read as synthetic inflation
        fault = chaos.point(PRESSURE_POINT)
        if fault is not None:
            with self._mu:
                self._inflate_b += envs.get_float(
                    "DLROVER_TPU_MEM_CHAOS_INFLATE_B"
                )
        with self._mu:
            inflate = self._inflate_b
            plan = self._state_plan
            grad_sync_b = self._grad_sync_b
            compile_b = self._compile_b
            providers = dict(self._host_providers)
        if inflate > 0:
            stats = [dict(s) for s in stats]
            for entry in stats:
                entry["used_b"] += inflate
                entry["source"] = "injected"
        used = max((s["used_b"] for s in stats), default=0.0)
        known_limits = [
            s["limit_b"] for s in stats if s["limit_b"] > 0
        ]
        limit = min(known_limits) if known_limits else 0.0
        peak = max((s["peak_b"] for s in stats), default=0.0)
        with self._mu:
            self._peak_b = max(self._peak_b, used, peak)
            peak = self._peak_b
        shm: Dict[str, float] = {}
        for name, fn in providers.items():
            try:
                shm[name] = float(fn() or 0.0)
            except Exception:  # noqa: BLE001 - a torn-down segment
                shm[name] = 0.0  # reads as empty
        rss = host_rss_bytes()
        subs: Dict[str, float] = {s: 0.0 for s in SUBSYSTEMS}
        if plan is not None:
            for name, value in plan.per_chip().items():
                subs[name] = subs.get(name, 0.0) + value
        subs["grad_sync"] = grad_sync_b
        subs["compile_workspace"] = compile_b
        known = sum(
            v for k, v in subs.items() if k != "other"
        )
        subs["other"] = max(0.0, used - known)
        total = sum(subs.values())
        tol = max(0.05 * used, 1.0)
        account = {
            "ts": round(now, 6),
            "chips": [
                {
                    "device": int(s["device"]),
                    "used_b": round(s["used_b"], 1),
                    "limit_b": round(s["limit_b"], 1),
                    "peak_b": round(s["peak_b"], 1),
                    "source": s["source"],
                }
                for s in stats
            ],
            "used_b": round(used, 1),
            "limit_b": round(limit, 1),
            "peak_b": round(peak, 1),
            "headroom_b": round(limit - used, 1) if limit > 0 else 0.0,
            "host": {
                "rss_b": round(rss, 1),
                "shm": {k: round(v, 1) for k, v in shm.items()},
                "shm_b": round(sum(shm.values()), 1),
            },
            "subsystems": {
                k: round(v, 1) for k, v in subs.items()
            },
            "account_sum_b": round(total, 1),
            # the account contract: attributed + other == used within
            # tolerance.  A known-subsystem overshoot (known > used)
            # cannot hide behind the remainder — it flags here.
            "account_ok": bool(abs(total - used) <= tol),
        }
        with self._mu:
            self._last = account
            self.samples_done += 1
        self._export_metrics(account)
        return account

    def _export_metrics(self, account: Dict[str, Any]) -> None:
        try:
            from dlrover_tpu_torch.observability import metrics as obs_metrics

            reg = obs_metrics.registry()
            reg.counter_inc(
                "dlrover_tpu_mem_samples_total",
                help=obs_metrics._help("dlrover_tpu_mem_samples_total"),
            )
            reg.gauge_set(
                "dlrover_tpu_mem_host_rss_bytes",
                account["host"]["rss_b"],
                help=obs_metrics._help(
                    "dlrover_tpu_mem_host_rss_bytes"
                ),
            )
        except Exception:  # noqa: BLE001 - instrumentation only
            pass

    # -- reading ------------------------------------------------------------

    def account(self) -> Optional[Dict[str, Any]]:
        """The most recent sample (None before the first)."""
        with self._mu:
            return dict(self._last) if self._last else None

    def digest(self) -> Dict[str, float]:
        """Flat floats for the heartbeat-digest channel (see the
        module docstring's key schema)."""
        account = self.account()
        if not account:
            return {}
        out = {
            # the SAMPLE timestamp: heartbeats between samples re-ship
            # an unchanged account, and the master must anchor slope
            # math to when the bytes were measured, not re-stamp them
            # at every heartbeat (which would zero the leak slope)
            "mm_ts": account["ts"],
            "mm_used_b": account["used_b"],
            "mm_peak_b": account["peak_b"],
            "mm_rss_b": account["host"]["rss_b"],
            "mm_shm_b": account["host"]["shm_b"],
        }
        # headroom is NOT shipped: the store derives it from the merged
        # used/limit pair — an independently min-merged headroom could
        # disagree with limit-used when the min limit and max used come
        # from different ranks
        if account["limit_b"] > 0:
            out["mm_limit_b"] = account["limit_b"]
        for name, value in account["subsystems"].items():
            out[DIGEST_SUB + name] = value
        return out

    def fit_report(self, plan: Dict[str, Any],
                   **kwargs: Any) -> Dict[str, Any]:
        """Instance convenience for :func:`fit_report` (module level)
        against this scope's registered plan + measured account."""
        return fit_report(plan, state_plan=self.state_plan(), **kwargs)

    def summary(self) -> Dict[str, Any]:
        plan = self.state_plan()
        return {
            "account": self.account(),
            "state_plan": plan.snapshot() if plan else None,
            "samples": self.samples_done,
        }


_SCOPE: Optional[MemScope] = None
_SCOPE_MU = threading.Lock()


def scope() -> MemScope:
    global _SCOPE
    if _SCOPE is None:
        with _SCOPE_MU:
            if _SCOPE is None:
                _SCOPE = MemScope()
    return _SCOPE


def reset_scope(stats_reader: Optional[Callable] = None) -> MemScope:
    """Replace the singleton (tests, per-scenario drill isolation)."""
    global _SCOPE
    with _SCOPE_MU:
        _SCOPE = MemScope(stats_reader=stats_reader)
        return _SCOPE


def sample() -> Optional[Dict[str, Any]]:
    """Guarded module-level sample (the trainer hook): a broken
    sampler logs and returns None, never raises."""
    if not enabled():
        return None
    try:
        from dlrover_tpu_torch.observability import trace

        with trace.span("mem.sample") as sp:
            account = scope().sample()
            sp.set_attr("used_b", account["used_b"])
            sp.set_attr("headroom_b", account["headroom_b"])
            sp.set_attr("account_ok", account["account_ok"])
        return account
    except Exception as e:  # noqa: BLE001 - sampling must not break
        # the training step that triggered it
        logger.debug("memscope sample failed: %s", e)
        return None
