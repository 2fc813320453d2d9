"""Communication-efficient data-parallel gradient sync, on one dp axis.

Port of ``dlrover_tpu/parallel/collectives.py``, the flat single-axis
parts.  In the JAX package these functions run inside ``shard_map`` over
the ``dp`` mesh axis; here each rank is a process and they take its
``process_group.DpGroup`` where the reference takes the axis name.

* **Quantized reduce-scatter with error feedback.** Each rank splits its
  contribution into ``world`` chunks, quantizes them blockwise (int8,
  packed int4, or int4 with an int8 refinement of the largest blocks),
  exchanges them, and decodes and sums what it received.  Its own
  quantization error is kept as a residual (``TrainState.ef_residual``)
  and added to the next step's gradient before quantizing.
* **Sharded weight update (ZeRO-1 over dp).** After the reduce-scatter
  each rank holds 1/world of the mean gradient, updates only that slice of
  the params against its slice of the optimizer state, and the params are
  all-gathered.
* **Exact reduce-scatter tiers.** An exact bucket takes the stock
  reduce-scatter or, by ``GradSyncPolicy.transport``, the ring
  (``ring``: ``world - 1`` hops with a plain add; ``ring_pallas``: each
  hop's add through a kernel; ``ring_rdma``: the whole ring as one kernel
  over peer memory, behind ``DLROVER_TPU_GRAD_RING_RDMA``), resolved by
  ``ops/cuda/ring_reduce_scatter.select_transport`` as in the reference.

Layout rule: a leaf shards along its first dimension divisible by the
world; leaves with no such dimension ride an exact all-reduce and a
replicated update.  Leaves are dicts of name -> tensor in the model's
``named_parameters()`` order, and the error-feedback state holds this
rank's residual as one leaf-shaped fp32 tensor per shardable leaf (the
reference stacks every rank's as a ``(world, *leaf)`` array sharded over
dp).

Left out so far, and refused with ``NotImplementedError``: stochastic
rounding, and the hierarchical (``slice``) two-level sync and its
striping.  The reference's simulated-DCN tolls
(``hierarchy.toll_payload`` / ``maybe_toll``) are no-ops on a flat mesh
and come with ``hierarchy.py``.
"""

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from dlrover_tpu_torch.ops.cuda import rdma_ring
from dlrover_tpu_torch.ops.cuda import ring_reduce_scatter as ring
from dlrover_tpu_torch.parallel.process_group import DpGroup

Tree = Dict[str, torch.Tensor]

GRAD_SYNC_MODES = (
    "exact", "exact_sharded",
    "int8", "int8_sharded",
    "int4", "int4_sharded",
    "blockwise", "blockwise_sharded",
)

_QUANT_PREFIXES = ("int8", "int4", "blockwise")

TRANSPORTS = (
    "auto", "all_to_all", "ring", "ring_pallas", "ring_rdma",
    "ring_pallas_q",
)

_LATER = "comes in a later slice of the port"


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} {_LATER}")


@dataclasses.dataclass(frozen=True)
class GradSyncPolicy:
    """Data-parallel gradient sync policy (``Trainer(grad_sync=...)``).

    Modes, as in the reference: ``exact`` (full-precision all-reduce,
    replicated update), ``exact_sharded`` (fp32 reduce-scatter, ZeRO-1
    sharded update, param all-gather), ``int8`` / ``int4`` (blockwise
    int8 or packed int4 quantized reduce-scatter with error feedback, then
    a full-precision grad all-gather and a replicated update),
    ``blockwise`` (int4 for every block plus an int8 refinement of the top
    ``hi_frac`` blocks per chunk by max-abs), and ``*_sharded`` (the same
    wire format with the sharded update and a param all-gather).

    ``bucket_mb`` > 0 packs the shardable leaves into size-targeted
    buckets (``parallel/bucketing.py``), one collective each; ``None``
    resolves from ``DLROVER_TPU_GRAD_BUCKET_MB``; ``0`` keeps one
    collective per leaf.  ``transport`` selects the reduce-scatter tier
    (``ops/cuda/ring_reduce_scatter.select_transport``); ``ring_pallas_q``
    runs quantized buckets through the fused-quantization ring.

    ``clip_norm``: the sharded paths clip against the global grad norm (a
    cross-rank sum); pass the optimizer without its clip stage, which
    would see one rank's shard only.

    ``rounding="stochastic"`` and ``hierarchical=True`` are refused: they
    come in a later slice."""

    mode: str = "exact"
    block_size: int = 256
    rounding: str = "nearest"  # or "stochastic" (a later slice)
    clip_norm: Optional[float] = None
    bucket_mb: Optional[float] = None  # None: DLROVER_TPU_GRAD_BUCKET_MB
    transport: str = "auto"
    hi_frac: Optional[float] = None  # None: DLROVER_TPU_GRAD_HI_FRAC
    hierarchical: Optional[bool] = None  # the flat sync only, for now

    def __post_init__(self):
        if self.mode not in GRAD_SYNC_MODES:
            raise ValueError(
                f"unknown grad_sync mode {self.mode!r}; "
                f"expected one of {GRAD_SYNC_MODES}"
            )
        if self.rounding not in ("nearest", "stochastic"):
            raise ValueError(f"unknown rounding {self.rounding!r}")
        if self.block_size < 8 or self.block_size % 2:
            raise ValueError("block_size must be >= 8 and even")
        if self.transport not in TRANSPORTS:
            raise ValueError(
                f"unknown transport {self.transport!r}; "
                f"expected one of {TRANSPORTS}"
            )
        if self.bucket_mb is not None and self.bucket_mb < 0:
            raise ValueError("bucket_mb must be >= 0")
        if self.hi_frac is not None and not (0.0 < self.hi_frac <= 1.0):
            raise ValueError("hi_frac must be in (0, 1]")
        if self.rounding == "stochastic":
            raise _later("stochastic rounding (the reference's PRNG bits "
                         "cannot be matched)")
        if self.hierarchical:
            raise _later("the hierarchical (slice) two-level grad sync")

    @property
    def active(self) -> bool:
        return self.mode != "exact"

    @property
    def quantized(self) -> bool:
        return self.mode.startswith(_QUANT_PREFIXES)

    @property
    def qformat(self) -> Optional[str]:
        """Wire codec: ``int8`` / ``int4`` / ``blockwise`` / None."""
        for prefix in _QUANT_PREFIXES:
            if self.mode.startswith(prefix):
                return prefix
        return None

    @property
    def sharded_update(self) -> bool:
        return self.mode.endswith("_sharded")

    def resolve(self) -> "GradSyncPolicy":
        """Fill the env-deferred fields (``bucket_mb``, ``transport``,
        ``hi_frac``) from the environment knobs, once, at trainer configure
        time."""
        from dlrover_tpu_torch.common import envs

        bucket = self.bucket_mb
        if bucket is None:
            bucket = envs.get_float("DLROVER_TPU_GRAD_BUCKET_MB")
        transport = self.transport
        if transport == "auto":
            transport = envs.get_str("DLROVER_TPU_GRAD_TRANSPORT")
        hi = self.hi_frac
        if hi is None:
            hi = envs.get_float("DLROVER_TPU_GRAD_HI_FRAC")
        return dataclasses.replace(self, bucket_mb=float(bucket),
                                   transport=transport, hi_frac=float(hi))

    def hi_blocks(self, nblk: int) -> int:
        """Blockwise mode: refined-block count for an ``nblk``-block chunk
        (at least one)."""
        frac = self.hi_frac if self.hi_frac is not None else 0.125
        return max(1, min(nblk, int(round(nblk * frac))))

    @classmethod
    def parse(cls, spec) -> "GradSyncPolicy":
        if spec is None:
            return cls()
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            return cls(mode=spec)
        raise TypeError(f"grad_sync must be a mode string or policy: {spec!r}")


def shard_dim_for(shape, world: int) -> Optional[int]:
    """First dimension divisible by ``world`` (the dp shard axis for this
    leaf), or None when the leaf must stay replicated."""
    if world <= 1:
        return None
    for dim, size in enumerate(shape):
        if size >= world and size % world == 0:
            return dim
    return None


class GradLayout:
    """Static per-leaf shard decisions for one params dict (tensors or
    shapes by name)."""

    def __init__(self, params, world: int):
        self.world = int(world)
        self.dims: Dict[str, Optional[int]] = {
            path: shard_dim_for(tuple(getattr(leaf, "shape", leaf)),
                                self.world)
            for path, leaf in params.items()
        }

    def sharded_paths(self) -> List[str]:
        return [p for p, d in self.dims.items() if d is not None]


# -- blockwise quantization ------------------------------------------------


def _nearest_only(rounding: str) -> None:
    if rounding != "nearest":
        raise _later(f"{rounding} rounding")


def blockwise_quantize(blocks: torch.Tensor, rounding: str = "nearest"):
    """Quantize ``blocks`` (..., block) to (int8, per-block scale):
    scale = max|block| / 127 (a multiply by fp32 1/127, as the reference
    computes it), codes clip(round(x / scale), ±127); zero blocks get
    scale 0 and codes 0."""
    _nearest_only(rounding)
    return ring.quantize_plain(blocks.float(), 127)


def blockwise_dequantize(q: torch.Tensor, scale: torch.Tensor):
    return q.float() * scale


def blockwise_quantize4(blocks: torch.Tensor, rounding: str = "nearest"):
    """Packed int4 variant: codes in [-7, 7] with scale max|block| / 7, two
    codes per int8 byte (even element in the low nibble)."""
    _nearest_only(rounding)
    q, scale = ring.quantize_plain(blocks.float(), 7)
    return ring.pack_nibbles(q), scale


def blockwise_dequantize4(packed: torch.Tensor, scale: torch.Tensor):
    """Inverse of :func:`blockwise_quantize4` (arithmetic shifts
    sign-extend the nibbles)."""
    return ring.unpack_nibbles(packed).float() * scale


def top_blocks(maxabs: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries along the last axis, largest
    first, ties to the lower index (``lax.top_k``'s order; a stable sort,
    where ``torch.topk`` promises no order among ties)."""
    order = torch.sort(maxabs, dim=-1, descending=True, stable=True).indices
    return order[..., :k]


# -- wire codecs -----------------------------------------------------------


def encode_chunks(flat: torch.Tensor, policy: GradSyncPolicy
                  ) -> Dict[str, torch.Tensor]:
    """Quantize ``flat`` of shape ``(world, nblk, block)`` into the
    policy's wire payload: a dict of tensors whose LEADING axis is the
    destination rank.  ``int8``: {q8, s8}; ``int4``: {q4, s4} (packed
    nibbles); ``blockwise``: {q4, s4, idx, q8, s8}, int4 for every block
    plus an int8 refinement of the top ``hi_blocks`` blocks per chunk by
    max-abs, which the decode puts in place of their int4 values."""
    fmt = policy.qformat
    if fmt == "int8":
        q8, s8 = blockwise_quantize(flat, policy.rounding)
        return {"q8": q8, "s8": s8}
    if fmt == "int4":
        q4, s4 = blockwise_quantize4(flat, policy.rounding)
        return {"q4": q4, "s4": s4}
    if fmt == "blockwise":
        idx = top_blocks(flat.abs().amax(dim=-1), policy.hi_blocks(
            flat.shape[1]))
        hi = torch.gather(flat, 1, idx[..., None].expand(-1, -1,
                                                        flat.shape[2]))
        q4, s4 = blockwise_quantize4(flat, policy.rounding)
        q8, s8 = blockwise_quantize(hi, policy.rounding)
        return {"q4": q4, "s4": s4, "idx": idx.to(torch.int32),
                "q8": q8, "s8": s8}
    raise ValueError(f"policy {policy.mode!r} has no wire codec")


def decode_chunks(payload: Dict[str, torch.Tensor],
                  policy: GradSyncPolicy) -> torch.Tensor:
    """Inverse of :func:`encode_chunks`: payload -> fp32
    ``(world, nblk, block)``."""
    fmt = policy.qformat
    if fmt == "int8":
        return blockwise_dequantize(payload["q8"], payload["s8"])
    if fmt == "int4":
        return blockwise_dequantize4(payload["q4"], payload["s4"])
    if fmt == "blockwise":
        deq = blockwise_dequantize4(payload["q4"], payload["s4"])
        rows = torch.arange(deq.shape[0], device=deq.device)[:, None]
        deq[rows, payload["idx"].long()] = blockwise_dequantize(
            payload["q8"], payload["s8"])
        return deq
    raise ValueError(f"policy {policy.mode!r} has no wire codec")


def codec_chunk_bytes(nblk: int, block: int,
                      policy: GradSyncPolicy) -> Dict[str, int]:
    """Wire bytes of ONE encoded chunk (``nblk`` blocks of ``block``),
    split into quantized payload and metadata (fp32 per-block scales,
    refinement indices)."""
    fmt = policy.qformat
    if fmt == "int8":
        return {"payload": nblk * block, "metadata": 4 * nblk}
    if fmt == "int4":
        return {"payload": nblk * (block // 2), "metadata": 4 * nblk}
    if fmt == "blockwise":
        k = policy.hi_blocks(nblk)
        return {
            "payload": nblk * (block // 2) + k * block,
            "metadata": 4 * nblk + 4 * k + 4 * k,  # s4 + idx + s8
        }
    raise ValueError(f"policy {policy.mode!r} has no wire codec")


def pad_blocks(flat: torch.Tensor, width: int, block: int
                ) -> Tuple[torch.Tensor, int]:
    """``(world, width)`` zero-padded to the block grid, as ``(world,
    nblk, block)``, and ``nblk``."""
    pad = (-width) % block
    padded = F.pad(flat, (0, pad)) if pad else flat
    nblk = (width + pad) // block
    return padded.reshape(flat.shape[0], nblk, block), nblk


def _quantized_exchange(flat: torch.Tensor, width: int,
                        policy: GradSyncPolicy, group: DpGroup):
    """The ``all_to_all`` tier on a ``(world, width)`` row-aligned buffer:
    pad to the block grid, encode with the policy's codec, exchange every
    payload tensor with one all-to-all each, decode and sum on the
    receiver.  Returns ``(shard_row, residual)``: this rank's ``(width,)``
    chunk of the cross-rank SUM and the full ``(world, width)``
    quantization error ``buf - dequant(q(buf))``."""
    x, _ = pad_blocks(flat, width, policy.block_size)
    world = flat.shape[0]
    payload = encode_chunks(x, policy)
    deq_own = decode_chunks(payload, policy).reshape(world, -1)
    residual = flat - deq_own[:, :width]
    recv = {k: group.all_to_all(v) for k, v in payload.items()}
    # (the reference's simulated-DCN toll here is a no-op on a flat mesh;
    # it comes with hierarchy.py)
    shard = decode_chunks(recv, policy).sum(dim=0)
    return shard.reshape(-1)[:width], residual


def _quantized_ring_exchange(flat: torch.Tensor, width: int,
                             policy: GradSyncPolicy, group: DpGroup):
    """The ``ring_pallas_q`` tier: the same ``(shard_row, residual)`` as
    :func:`_quantized_exchange`, but the encode is one fused kernel and the
    exchange is ``world - 1`` shifted hops, each decoded and accumulated by
    a second fused kernel, in place: the ``(world, width)`` fp32 decode
    buffer of the two-stage path never exists.

    Every source's contribution is encoded ONCE from its original values,
    so the residual is bit-identical to the two-stage path's; the received
    values are the same set, summed in hop order: this rank's own chunk
    first, then at hop ``d`` the chunk rank ``(i + d) mod world`` encoded
    for rank ``i``."""
    world = flat.shape[0]
    x, nblk = pad_blocks(flat, width, policy.block_size)
    fmt = policy.qformat
    base_fmt = "int4" if fmt == "blockwise" else fmt
    q, s, deq = ring.fused_quantize(x.contiguous(), base_fmt)
    refine = None
    if fmt == "blockwise":
        # the int4 base above plus an int8 refinement of the top hi_frac
        # blocks per chunk: k blocks, small enough for plain torch
        idx = top_blocks(x.abs().amax(dim=-1), policy.hi_blocks(nblk))
        hi = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))
        q8, s8 = blockwise_quantize(hi, policy.rounding)
        refine = {"idx": idx.to(torch.int32), "q8": q8, "s8": s8}
        rows = torch.arange(world, device=x.device)[:, None]
        deq[rows, idx] = blockwise_dequantize(q8, s8)
    residual = flat - deq.reshape(world, -1)[:, :width]
    me = group.rank
    acc = deq[me].clone()  # the chunk destined for me never leaves
    for d in range(1, world):
        send = (me - d) % world
        packet = {"q": q[send], "s": s[send]}
        if refine is not None:
            packet.update({k: v[send] for k, v in refine.items()})
        packet = group.shift(packet, d)
        if refine is None:
            ring.fused_dequant_add(acc, packet["q"], packet["s"], base_fmt,
                                   out=acc)
        else:
            # per-source decode as decode_chunks: the int4 base (fused
            # kernel), the refined blocks put in place, then the add
            c = ring.fused_dequant_add(torch.zeros_like(acc), packet["q"],
                                       packet["s"], base_fmt)
            c[packet["idx"].long()] = blockwise_dequantize(packet["q8"],
                                                           packet["s8"])
            acc += c
    return acc.reshape(-1)[:width], residual


def quantized_reduce_scatter(t: torch.Tensor, dim: int,
                             policy: GradSyncPolicy, group: DpGroup):
    """Quantized reduce-scatter of one leaf ``t`` along ``dim``, over the
    ``all_to_all`` exchange in the policy's codec.  Returns ``(shard,
    residual)``: this rank's chunk of the cross-rank SUM and its
    full-leaf quantization error."""
    world = group.world
    moved = torch.movedim(t, dim, 0)
    chunk_rows = moved.shape[0] // world
    rest = tuple(moved.shape[1:])
    chunk_elems = chunk_rows * math.prod(rest)
    flat = moved.reshape(world, chunk_elems)
    shard_row, residual = _quantized_exchange(flat, chunk_elems, policy,
                                              group)
    residual = torch.movedim(residual.reshape(moved.shape), 0, dim)
    shard = shard_row.reshape((chunk_rows,) + rest)
    return torch.movedim(shard, 0, dim), residual


def bucket_reduce_scatter(buf: torch.Tensor, policy: GradSyncPolicy,
                          group: DpGroup, transport: Optional[str] = None,
                          window=None):
    """Reduce-scatter ONE packed bucket buffer of shape ``(world,
    width)``.  Exact policies move the fp32 rows through the resolved
    tier: the stock reduce-scatter, the ``ring`` / ``ring_pallas`` ring,
    or the one-kernel ``ring_rdma`` ring over ``window``
    (``peer_memory.PeerWindow``, which that tier needs).  Quantized
    policies ride the codec ``all_to_all`` exchange or the
    fused-quantization ``ring_pallas_q`` ring.  ``transport`` overrides
    the policy's request for this bucket (the fallback chain still
    applies).  Returns ``((width,) shard row, (world, width)
    residual-or-None)``."""
    width = buf.shape[1]
    resolved = ring.resolve_transport(policy, group.world, width,
                                      request=transport)
    if not policy.quantized:
        if resolved == "ring_rdma":
            return rdma_ring.rdma_ring_reduce_scatter(buf, group,
                                                      window), None
        if resolved in ("ring", "ring_pallas"):
            accum = "kernel" if resolved == "ring_pallas" else "torch"
            return ring.ring_reduce_scatter(buf, group, accum), None
        return group.reduce_scatter(buf).reshape(-1), None
    if resolved == "ring_pallas_q":
        return _quantized_ring_exchange(buf, width, policy, group)
    return _quantized_exchange(buf, width, policy, group)


# -- gradient-tree sync ----------------------------------------------------


def sync_gradient_tree(grads: Tree, residuals: Optional[Tree],
                       layout: GradLayout, policy: GradSyncPolicy,
                       group: DpGroup):
    """Reduce the per-rank mean-gradient contributions, one collective per
    leaf.  Returns ``(synced, new_residuals)``: sharded leaves come back as
    their 1/world slice along their shard dim (the SUM over ranks; the
    caller already divided by the global weight), non-shardable leaves
    full from an exact all-reduce.  ``new_residuals`` holds this rank's
    quantization error per shardable leaf (None for exact modes)."""
    synced: Tree = {}
    new_resid: Tree = {}
    for path, g in grads.items():
        g = g.float()
        dim = layout.dims.get(path)
        if dim is None:
            synced[path] = group.all_reduce(g)
            continue
        if not policy.quantized:
            moved = torch.movedim(g, dim, 0)
            synced[path] = torch.movedim(group.reduce_scatter(moved), 0, dim)
            continue
        t = g
        if residuals is not None and path in residuals:
            t = g + residuals[path]
        synced[path], new_resid[path] = quantized_reduce_scatter(
            t, dim, policy, group)
    return synced, ((new_resid or None) if policy.quantized else None)


def sync_gradient_tree_bucketed(grads: Tree, residuals: Optional[Tree],
                                layout: GradLayout, buckets,
                                policy: GradSyncPolicy, group: DpGroup,
                                window=None):
    """Bucketed :func:`sync_gradient_tree`: the shardable leaves move
    through their bucket's ONE collective (``bucketing.BucketLayout``).
    Same contract as the per-leaf path, residuals still per leaf;
    ``window`` is the ``ring_rdma`` tier's peer window."""
    synced: Tree = {}
    new_resid: Tree = {}
    for path, g in grads.items():
        if layout.dims.get(path) is None:
            synced[path] = group.all_reduce(g.float())

    def contribution(path):
        t = grads[path].float()
        if policy.quantized and residuals is not None and path in residuals:
            t = t + residuals[path]
        return t

    for b in buckets.buckets:
        buf = buckets.pack(b, contribution)
        shard_row, resid_buf = bucket_reduce_scatter(buf, policy, group,
                                                     window=window)
        synced.update(buckets.unpack_shard(b, shard_row))
        if resid_buf is not None:
            new_resid.update(buckets.unpack_full(b, resid_buf))
    synced = {p: synced[p] for p in grads}
    return synced, ((new_resid or None) if policy.quantized else None)


def global_grad_norm(synced: Tree, layout: GradLayout,
                     group: DpGroup) -> torch.Tensor:
    """Exact global norm of a mixed shard/full gradient tree: the sharded
    leaves partition the full tensors, so the cross-rank sum of their
    local sums of squares is the total; replicated leaves count once."""
    device = next(iter(synced.values())).device
    local = torch.zeros((), dtype=torch.float32, device=device)
    replicated = torch.zeros((), dtype=torch.float32, device=device)
    for path, g in synced.items():
        ss = g.float().square().sum()
        if layout.dims.get(path) is None:
            replicated = replicated + ss
        else:
            local = local + ss
    return (group.all_reduce(local) + replicated).sqrt()


def shard_like(tree: Tree, layout: GradLayout, group: DpGroup) -> Tree:
    """Each shardable leaf of a REPLICATED tree cut to this rank's chunk:
    views, so an in-place update of a shard updates the full leaf."""
    out = {}
    for path, p in tree.items():
        dim = layout.dims.get(path)
        if dim is None:
            out[path] = p
        else:
            chunk = p.shape[dim] // layout.world
            out[path] = p.narrow(dim, group.rank * chunk, chunk)
    return out


def all_gather_tree(tree: Tree, layout: GradLayout, group: DpGroup) -> Tree:
    """Rebuild full leaves from shards, one all-gather per leaf."""
    out = {}
    for path, x in tree.items():
        dim = layout.dims.get(path)
        if dim is None:
            out[path] = x
            continue
        gathered = group.all_gather(torch.movedim(x, dim, 0))
        full = gathered.reshape((-1,) + tuple(gathered.shape[2:]))
        out[path] = torch.movedim(full, 0, dim)
    return out


def all_gather_tree_bucketed(tree: Tree, layout: GradLayout, buckets,
                             group: DpGroup) -> Tree:
    """Bucketed :func:`all_gather_tree`: each bucket's per-leaf shards
    packed into one ``(width,)`` row, one all-gather per bucket and leaf
    dtype (a mixed-dtype concatenate would promote)."""
    full: Tree = {}
    for b in buckets.buckets:
        groups: Dict[torch.dtype, list] = {}
        for s in b.slices:
            groups.setdefault(tree[s.path].dtype, []).append(s)
        for slices in groups.values():
            rows = [torch.movedim(tree[s.path], s.dim, 0).reshape(-1)
                    for s in slices]
            row = torch.cat(rows) if len(rows) > 1 else rows[0]
            buf = group.all_gather(row)
            off = 0
            for s in slices:
                full[s.path] = buckets.leaf_from_rows(
                    s, buf[:, off:off + s.width])
                off += s.width
    return {p: full.get(p, x) for p, x in tree.items()}


# -- host-side helpers -----------------------------------------------------


def error_feedback_init(params: Tree, layout: GradLayout) -> Tree:
    """Zero error-feedback residuals for this rank: one fp32 tensor of the
    leaf's shape per quantized (= shardable) leaf."""
    return {
        path: torch.zeros(tuple(leaf.shape), dtype=torch.float32,
                          device=leaf.device)
        for path, leaf in params.items()
        if layout.dims.get(path) is not None
    }


def estimate_sync_bytes(params, world: int, policy: GradSyncPolicy) -> Dict:
    """Estimated per-step dp bytes-on-wire per rank (ring-collective
    accounting: a reduce-scatter or all-gather moves ``(world-1)/world`` of
    its payload off-rank; an all-reduce both).  ``exact``: fp32 all-reduce
    of every element.  Quantized modes: the codec payload and metadata,
    then the fp32 all-gather.  Non-shardable leaves ride the exact
    all-reduce in every mode."""
    layout = GradLayout(params, world)
    off = (world - 1) / world if world > 1 else 0.0
    exact = quant = meta = 0.0
    for path, leaf in params.items():
        shape = tuple(getattr(leaf, "shape", leaf))
        elems = math.prod(shape) if shape else 1
        exact += 2 * off * 4 * elems
        if layout.dims.get(path) is None:
            quant += 2 * off * 4 * elems
        else:
            chunk = elems // world
            if policy.quantized:
                nblk = -(-chunk // policy.block_size)
                cb = codec_chunk_bytes(nblk, policy.block_size, policy)
            else:
                cb = {"payload": 4 * chunk, "metadata": 0}
            quant += off * world * (cb["payload"] + cb["metadata"])
            meta += off * world * cb["metadata"]
            quant += off * 4 * elems
    result = {
        "world": int(world),
        "exact_allreduce_bytes": int(exact),
        "quantized_bytes": int(quant),
        "metadata_bytes": int(meta),
    }
    if quant > 0:
        result["reduction_x"] = round(exact / quant, 2)
    return result


def estimate_bucket_bytes(buckets, policy: GradSyncPolicy,
                          world: int) -> List[Dict]:
    """Per-BUCKET bytes-on-wire accounting of the bucketed sync: padding
    is charged per bucket (a bucket pads its packed row once to the block
    grid) and quantization metadata (scales, refinement indices) is
    itemized per bucket.  The comm scope's bucket chains report their
    wire bytes from it (``observability/commscope.py``)."""
    off = (world - 1) / world if world > 1 else 0.0
    out = []
    for b in buckets.buckets:
        width = b.width
        if policy.quantized:
            block = policy.block_size
            nblk = -(-width // block)
            cb = codec_chunk_bytes(nblk, block, policy)
            rs_payload = off * world * cb["payload"]
            rs_meta = off * world * cb["metadata"]
        else:
            rs_payload = off * world * 4 * width
            rs_meta = 0.0
        out.append({
            "bucket": b.index,
            "leaves": len(b.slices),
            "width": width,
            "rs_payload_bytes": int(rs_payload),
            "rs_metadata_bytes": int(rs_meta),
            "allgather_bytes": int(off * world * 4 * width),
        })
    return out
