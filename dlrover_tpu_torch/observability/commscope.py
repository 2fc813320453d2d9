"""Comm observatory: per-axis fabric probes and per-bucket chain times.

Port of ``dlrover_tpu/observability/commscope.py``, three pieces:

:class:`FabricModel`
    The per-axis price list: for every active mesh axis an EWMA latency
    (µs per hop) and achieved bandwidth (GB/s), built from probe samples.
    ``digest()`` flattens it into ``fxl_<axis>`` / ``fxb_<axis>`` floats
    for the rank's digest file; an agent folds several ranks' files with
    :func:`merge_digest` (max latency, min bandwidth).

:class:`MeshProbe`
    The active prober: every ``DLROVER_TPU_COMM_PROBE_EVERY`` steps the
    trainer runs one timed pair per active axis over this rank's group
    along it (``parallel/mesh.py`` ``axis_group``, or the trainer's flat
    dp group): a ring hop of ``lat_bytes`` of int32 (``DpGroup.shift``,
    latency) and an all-reduce of ``bw_bytes`` of fp32
    (``DpGroup.all_reduce``, bandwidth under ring all-reduce accounting),
    each after an untimed warm-up and each waited for on the device.
    Every rank fires them at the same step, in the same axis order, like
    any other collective.  An injected ``runner`` prices an axis with no
    group (tests).

:class:`BucketScope`
    Per-bucket attribution of the bucketed grad sync: each bucket's
    ``collectives.bucket_reduce_scatter`` chain, timed on the probe
    cadence on the trainer's device (``comm.bucket<i>`` spans carrying
    the resolved transport, the wire bytes of
    ``collectives.estimate_bucket_bytes`` and the achieved GB/s).  The
    chains run the same kernels as the step's sync, so they add launches.

:class:`CommScope` (process singleton, :func:`scope`) ties them together
and keeps the ``exposed_comm`` sub-account per (transport, axis).

Everything here is guarded by its callers: a broken probe never breaks a
training step.  The chaos point ``comm.axis_delay.<axis>`` fires inside
the probe's timed latency window and each bucket's timed window on the
sync axis (a seeded DELAY is an injected per-axis link latency), and a
probe warms the engine with ``comm.probe.init`` when it is made.
"""

import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.parallel.mesh import axis_fabric

#: digest-key prefixes (flat floats riding ``comm.HeartBeat.digest``):
#: ``fxl_<axis>`` = EWMA probe latency (µs/hop), ``fxb_<axis>`` = EWMA
#: achieved bandwidth (GB/s).  The agent merges rank files WORST-case
#: (max latency, min bandwidth) — a node is as healthy as its slowest
#: link.
DIGEST_LAT = "fxl_"
DIGEST_BW = "fxb_"



#: chaos injection point prefix: ``comm.axis_delay.<axis>`` fires
#: inside the probe's timed latency window (and each bucket
#: measurement window on the sync axis), so a seeded DELAY fault IS an
#: injected per-axis link latency.
AXIS_DELAY_POINT = "comm.axis_delay."


def _fire_axis_delay(axis: str) -> None:
    from dlrover_tpu_torch import chaos

    chaos.point(AXIS_DELAY_POINT + axis, axis=axis)


def merge_digest(dst: Dict[str, float], src: Dict[str, Any]) -> None:
    """Fold one rank file's ``fxl_*`` / ``fxb_*`` keys into a host
    digest, as the reference's agent does (``_collect_digest``): a node
    is as healthy as its slowest link, so latency merges MAX and
    bandwidth merges MIN across the host's ranks."""
    for key, value in src.items():
        if key.startswith(DIGEST_LAT):
            dst[key] = max(dst.get(key, 0.0), float(value))
        elif key.startswith(DIGEST_BW):
            value = float(value)
            dst[key] = value if key not in dst else min(dst[key], value)


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (the probes' and chains' timed
    windows end on the host only once the device is done)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class FabricModel:
    """Per-mesh-axis latency/bandwidth estimates from probe samples.

    EWMA-smoothed (``DLROVER_TPU_COMM_EWMA_ALPHA``) so one noisy probe
    does not flap the digest, while a sustained injected delay moves
    the estimate within a couple of samples.  Thread-safe."""

    def __init__(self, alpha: Optional[float] = None):
        self._alpha = float(
            alpha if alpha is not None
            else envs.get_float("DLROVER_TPU_COMM_EWMA_ALPHA")
        )
        if not (0.0 < self._alpha <= 1.0):
            self._alpha = 0.5
        self._mu = threading.Lock()
        # axis -> {world, lat_us, gbps, samples, ts}
        self._axes: Dict[str, Dict[str, float]] = {}

    def update(self, axis: str, world: int, lat_s: float,
               gbps: float) -> None:
        now = time.time()
        with self._mu:
            entry = self._axes.get(axis)
            lat_us = max(0.0, float(lat_s)) * 1e6
            gbps = max(0.0, float(gbps))
            if entry is None:
                entry = self._axes[axis] = {
                    "world": int(world), "lat_us": lat_us, "gbps": gbps,
                    "samples": 0,
                }
            else:
                a = self._alpha
                entry["lat_us"] += a * (lat_us - entry["lat_us"])
                entry["gbps"] += a * (gbps - entry["gbps"])
                entry["world"] = int(world)
            entry["samples"] += 1
            entry["ts"] = round(now, 6)

    def axes(self) -> List[str]:
        with self._mu:
            return sorted(self._axes)

    def get(self, axis: str) -> Optional[Dict[str, float]]:
        with self._mu:
            entry = self._axes.get(axis)
            return dict(entry) if entry else None

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._mu:
            return {
                axis: {
                    "world": entry["world"],
                    "lat_us": round(entry["lat_us"], 3),
                    "gbps": round(entry["gbps"], 6),
                    "samples": int(entry["samples"]),
                    "ts": entry.get("ts", 0.0),
                    # fabric tier (r18): which interconnect this axis
                    # rides — the slice axis is the DCN boundary
                    "tier": axis_fabric(axis),
                }
                for axis, entry in self._axes.items()
            }

    def digest(self) -> Dict[str, float]:
        """Flat floats for the heartbeat-digest channel."""
        out: Dict[str, float] = {}
        with self._mu:
            for axis, entry in self._axes.items():
                out[DIGEST_LAT + axis] = round(entry["lat_us"], 3)
                out[DIGEST_BW + axis] = round(entry["gbps"], 6)
        return out


# ---------------------------------------------------------------------------
# Active mesh probe.
# ---------------------------------------------------------------------------


class MeshProbe:
    """Timed micro-collectives per mesh axis.

    ``axes`` maps axis name -> world size (only sizes > 1 are probed), and
    ``groups`` each such axis to this rank's ``DpGroup`` along it
    (``parallel/mesh.py`` ``axis_group``).  The latency probe is one
    ring hop (``DpGroup.shift``) of ``lat_bytes`` of int32, the bandwidth
    probe one ``DpGroup.all_reduce`` of ``bw_bytes`` of fp32, both on the
    group's device and each waited for.  With an injected
    ``runner(axis, kind)`` (tests) no group is touched: timing, spans and
    model updates are identical either way.  ``clock`` (seconds, default
    ``time.perf_counter``) times the windows; a test may inject one that
    load cannot stretch.
    """

    def __init__(self, axes: Dict[str, int],
                 groups: Optional[Dict[str, Any]] = None,
                 runner: Optional[Callable[[str, str], Any]] = None,
                 lat_bytes: Optional[int] = None,
                 bw_bytes: Optional[int] = None,
                 reps: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.axes = {
            a: int(w) for a, w in (axes or {}).items() if int(w) > 1
        }
        self._groups = dict(groups or {})
        self._runner = runner
        self._clock = clock or time.perf_counter
        self._lat_bytes = int(
            lat_bytes if lat_bytes is not None
            else envs.get_int("DLROVER_TPU_COMM_PROBE_LAT_BYTES")
        )
        self._bw_bytes = int(
            bw_bytes if bw_bytes is not None
            else envs.get_int("DLROVER_TPU_COMM_PROBE_BW_BYTES")
        )
        self.reps = max(
            1,
            int(reps if reps is not None
                else envs.get_int("DLROVER_TPU_COMM_PROBE_REPS")),
        )
        # (axis, kind) -> (collective on its input, the group's device)
        self._fns: Dict[Any, Any] = {}
        self.probes_done = 0
        # warm the chaos engine's one-time env probe NOW: the first
        # injection-point call pays it, and it must not land inside the
        # first probe's timed latency window (a ~1ms phantom "link")
        from dlrover_tpu_torch import chaos

        chaos.point("comm.probe.init")

    @classmethod
    def for_mesh(cls, mesh, **kwargs) -> Optional["MeshProbe"]:
        """A probe over ``mesh``'s active (size > 1) axes, or None when
        every axis is trivial (nothing to probe)."""
        if mesh is None:
            return None
        from dlrover_tpu_torch.parallel.mesh import axis_group, mesh_shape

        axes = {a: s for a, s in mesh_shape(mesh).items() if s > 1}
        if not axes:
            return None
        groups = {a: axis_group(mesh, a) for a in axes}
        return cls(axes, groups=groups, **kwargs)

    @classmethod
    def for_group(cls, axis: str, group, **kwargs) -> Optional["MeshProbe"]:
        """A probe of one axis over ``group`` (the trainer's flat dp
        group), or None for a group of one rank."""
        if group is None or group.world <= 1:
            return None
        return cls({axis: group.world}, groups={axis: group}, **kwargs)

    # -- the real (collective) runner ----------------------------------------

    def _built_fn(self, axis: str, kind: str):
        key = (axis, kind)
        fn = self._fns.get(key)
        if fn is not None:
            return fn
        group = self._groups[axis]
        device = group.device
        if kind == "lat":
            elems = max(2, self._lat_bytes // 4)
            x = torch.zeros((elems,), dtype=torch.int32, device=device)

            def body():
                # one ring hop, rank i to rank i + 1: the smallest
                # message the axis can carry
                return group.shift({"x": x}, -1)
        else:
            elems = max(256, self._bw_bytes // 4)
            # the accounting must price the ACTUAL payload: the floor
            # and the //4 rounding can diverge from the configured knob
            self._bw_bytes = 4 * elems
            x = torch.ones((elems,), dtype=torch.float32, device=device)

            def body():
                # all-reduce: ring accounting moves 2(w-1)/w of the
                # payload off-replica per device
                return group.all_reduce(x)

        fn = (body, device)
        self._fns[key] = fn
        return fn

    def _run(self, axis: str, kind: str) -> None:
        """Execute one probe op (the group's collective or the injected
        runner) and wait for it."""
        if self._runner is not None:
            self._runner(axis, kind)
            return
        body, device = self._built_fn(axis, kind)
        body()
        _sync(device)

    # -- probing -------------------------------------------------------------

    def _probe_axis(self, axis: str, model: FabricModel) -> Dict[str, float]:
        from dlrover_tpu_torch.observability import metrics as obs_metrics
        from dlrover_tpu_torch.observability import trace

        world = self.axes[axis]
        with trace.span(f"comm.probe.{axis}",
                        attrs={"axis": axis, "world": world}) as sp:
            # warm-up outside the window: the first call sets up the
            # group's buffers and connections
            self._run(axis, "lat")
            t0 = self._clock()
            # the injected per-axis link latency lands INSIDE the timed
            # window — chaos prices the axis exactly like a slow link
            _fire_axis_delay(axis)
            for _ in range(self.reps):
                self._run(axis, "lat")
            lat_s = (self._clock() - t0) / self.reps
            self._run(axis, "bw")  # warm-up
            t0 = self._clock()
            for _ in range(self.reps):
                self._run(axis, "bw")
            bw_elapsed = (self._clock() - t0) / self.reps
            # ring all-reduce accounting: bytes leaving each replica
            off = 2.0 * (world - 1) / world
            moved = off * float(self._bw_bytes)
            gbps = (moved / bw_elapsed / 1e9) if bw_elapsed > 0 else 0.0
            sp.set_attr("lat_us", round(lat_s * 1e6, 3))
            sp.set_attr("gbps", round(gbps, 6))
        model.update(axis, world, lat_s, gbps)
        reg = obs_metrics.registry()
        reg.counter_inc(
            "dlrover_tpu_comm_probes_total",
            help=obs_metrics._help("dlrover_tpu_comm_probes_total"),
            axis=axis,
        )
        reg.gauge_set(
            "dlrover_tpu_comm_probe_latency_us", round(lat_s * 1e6, 3),
            help=obs_metrics._help("dlrover_tpu_comm_probe_latency_us"),
            axis=axis,
        )
        reg.gauge_set(
            "dlrover_tpu_comm_probe_bandwidth_gbps", round(gbps, 6),
            help=obs_metrics._help("dlrover_tpu_comm_probe_bandwidth_gbps"),
            axis=axis,
        )
        return {"lat_s": lat_s, "gbps": gbps}

    def probe_once(self, model: Optional[FabricModel] = None
                   ) -> Dict[str, Dict[str, float]]:
        """One probe round over every active axis; feeds ``model``
        (default: the process scope's fabric model).  Returns the raw
        per-axis samples."""
        if model is None:
            model = scope().fabric
        out: Dict[str, Dict[str, float]] = {}
        for axis in sorted(self.axes):
            out[axis] = self._probe_axis(axis, model)
        self.probes_done += 1
        return out


# ---------------------------------------------------------------------------
# Per-bucket chain measurement (the r14 overlapped sync, attributed).
# ---------------------------------------------------------------------------


class BucketScope:
    """Sampled per-bucket timing of the bucketed grad-sync chains.

    Each bucket's ``collectives.bucket_reduce_scatter`` chain (EF-free:
    pack -> encode -> exchange -> decode, through the tier the bucket
    resolves to, its kernels included) on a ``(world, width)`` fp32
    buffer of ones on the trainer's device, timed from the host with the
    device waited for.  Measurements emit ``comm.bucket<i>`` spans with
    the resolved transport tier, sync axis, wire bytes and achieved GB/s,
    and land in the per-(transport, axis) histogram.
    """

    def __init__(self, buckets, policy, group, axis: str, world: int,
                 window=None):
        from dlrover_tpu_torch.parallel import collectives

        self._buckets = buckets
        self._policy = policy
        self._group = group
        self._axis = axis
        self._world = int(world)
        self._window = window
        self._fns: Dict[int, Any] = {}
        self._bytes = {
            row["bucket"]: row
            for row in collectives.estimate_bucket_bytes(
                buckets, policy, self._world
            )
        }

    @classmethod
    def for_trainer(cls, trainer) -> Optional["BucketScope"]:
        """From a ``Trainer`` running the bucketed sync over its dp
        group, or None when the sync path is per-leaf/exact."""
        buckets = getattr(trainer, "_bucket_layout", None)
        if buckets is None or trainer.dp_group is None:
            return None
        return cls(
            buckets, trainer.grad_sync, trainer.dp_group, "dp",
            trainer._sync_world,  # noqa: SLF001 - observability introspection
            window=trainer._peer_window,  # noqa: SLF001
        )

    def transport_of(self, bucket) -> str:
        from dlrover_tpu_torch.ops.cuda import ring_reduce_scatter as ring

        return ring.resolve_transport(
            self._policy, self._world, bucket.width, self._axis
        )

    def _chain_fn(self, bucket):
        fn = self._fns.get(bucket.index)
        if fn is not None:
            return fn
        from dlrover_tpu_torch.parallel import collectives

        x = torch.ones((self._world, bucket.width), dtype=torch.float32,
                       device=self._group.device)

        def chain():
            shard, _ = collectives.bucket_reduce_scatter(
                x, self._policy, self._group, window=self._window
            )
            out = shard.sum()
            if self._window is not None:
                self._window.check()
            return out

        self._fns[bucket.index] = chain
        return chain

    def measure(self, reps: int = 3) -> List[Dict[str, Any]]:
        """Time every bucket's chain (one untimed call first, then
        ``reps`` timed ones); returns per-bucket rows."""
        import time as _time

        from dlrover_tpu_torch.observability import metrics as obs_metrics
        from dlrover_tpu_torch.observability import trace

        reps = max(1, int(reps))
        device = self._group.device
        rows: List[Dict[str, Any]] = []
        for bucket in self._buckets.buckets:
            transport = self.transport_of(bucket)
            wire = self._bytes.get(bucket.index, {})
            wire_bytes = int(
                wire.get("rs_payload_bytes", 0)
                + wire.get("rs_metadata_bytes", 0)
            )
            chain = self._chain_fn(bucket)
            chain()  # the first call outside the window
            _sync(device)
            with trace.span(
                f"comm.bucket{bucket.index}",
                attrs={
                    "axis": self._axis, "transport": transport,
                    "wire_bytes": wire_bytes,
                    "leaves": len(bucket.slices),
                    "width": bucket.width,
                },
            ) as sp:
                t0 = _time.perf_counter()
                # the injected axis latency prices every exchange
                # riding this axis, not just the probe
                _fire_axis_delay(self._axis)
                for _ in range(reps):
                    chain()
                _sync(device)
                chain_s = (_time.perf_counter() - t0) / reps
                gbps = (
                    wire_bytes / chain_s / 1e9 if chain_s > 0 else 0.0
                )
                sp.set_attr("chain_ms", round(chain_s * 1e3, 3))
                sp.set_attr("gbps", round(gbps, 6))
            obs_metrics.registry().observe(
                "dlrover_tpu_comm_bucket_exchange_seconds", chain_s,
                help=obs_metrics._help(
                    "dlrover_tpu_comm_bucket_exchange_seconds"
                ),
                transport=transport, axis=self._axis,
            )
            rows.append({
                "bucket": bucket.index,
                "axis": self._axis,
                "tier": axis_fabric(self._axis),
                "transport": transport,
                "leaves": len(bucket.slices),
                "width": bucket.width,
                "wire_bytes": wire_bytes,
                "chain_ms": round(chain_s * 1e3, 3),
                "gbps": round(gbps, 6),
            })
        return rows


# ---------------------------------------------------------------------------
# The process scope: fabric model + exposed-comm sub-account.
# ---------------------------------------------------------------------------


class CommScope:
    """Per-process comm telemetry owner (see :func:`scope`)."""

    def __init__(self):
        self.fabric = FabricModel()
        self._mu = threading.Lock()
        # (transport, axis) -> cumulative exposed seconds
        self._exposed: Dict[Any, float] = {}

    def attribute_exposed(self, axis: str, transport: str, dur_s: float,
                          end_ts: Optional[float] = None) -> None:
        """Book measured exposed (non-overlapped) sync time: charges
        the goodput ledger's ``exposed_comm`` phase as before AND keeps
        the per-(transport, axis) breakdown the ledger's one phase
        lacked.  Callers are the benches/drills that MEASURE exposure
        (the ledger's exposed_comm contract, ``goodput.py``)."""
        dur_s = float(dur_s)
        if dur_s <= 0:
            return
        with self._mu:
            key = (str(transport), str(axis))
            self._exposed[key] = self._exposed.get(key, 0.0) + dur_s
        try:
            from dlrover_tpu_torch.observability import goodput

            goodput.charge("exposed_comm", dur_s, end_ts)
        except Exception:  # noqa: BLE001 - the ledger must not break
            pass  # the measuring caller
        try:
            from dlrover_tpu_torch.observability import metrics as obs_metrics

            obs_metrics.registry().counter_inc(
                "dlrover_tpu_comm_exposed_seconds_total", dur_s,
                help=obs_metrics._help(
                    "dlrover_tpu_comm_exposed_seconds_total"
                ),
                transport=str(transport), axis=str(axis),
            )
        except Exception:  # noqa: BLE001 - instrumentation only
            pass

    def exposed_breakdown(self) -> Dict[str, Any]:
        """The ``exposed_comm`` sub-account: seconds and share per
        ``<transport>/<axis>``."""
        with self._mu:
            items = {
                f"{transport}/{axis}": seconds
                for (transport, axis), seconds in self._exposed.items()
            }
        total = sum(items.values())
        return {
            "total_s": round(total, 6),
            "by": {k: round(v, 6) for k, v in sorted(items.items())},
            "share": {
                k: round(v / total, 4) for k, v in sorted(items.items())
            } if total > 0 else {},
        }

    def summary(self) -> Dict[str, Any]:
        return {
            "fabric": self.fabric.snapshot(),
            "exposed_comm": self.exposed_breakdown(),
        }

    def digest(self) -> Dict[str, float]:
        return self.fabric.digest()


_SCOPE: Optional[CommScope] = None
_SCOPE_MU = threading.Lock()


def scope() -> CommScope:
    global _SCOPE
    if _SCOPE is None:
        with _SCOPE_MU:
            if _SCOPE is None:
                _SCOPE = CommScope()
    return _SCOPE


def reset_scope() -> CommScope:
    """Replace the singleton (tests, per-scenario drill isolation)."""
    global _SCOPE
    with _SCOPE_MU:
        _SCOPE = CommScope()
        return _SCOPE


def probe_every() -> int:
    """Steps between active probes (0 = probing off)."""
    return envs.get_int("DLROVER_TPU_COMM_PROBE_EVERY")


def digest_axes(digest: Dict[str, float]) -> List[str]:
    """Axes present in a heartbeat digest's fabric keys."""
    return sorted({
        key[len(DIGEST_LAT):]
        for key in digest
        if key.startswith(DIGEST_LAT)
    } | {
        key[len(DIGEST_BW):]
        for key in digest
        if key.startswith(DIGEST_BW)
    })
