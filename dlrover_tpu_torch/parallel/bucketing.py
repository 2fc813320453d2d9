"""Deterministic size-targeted gradient buckets for the dp grad sync.

Port of ``dlrover_tpu/parallel/bucketing.py``.  The shardable leaves are
packed into a few flat ``(world, width)`` buffers so that each bucket goes
through ONE collective and ONE fused quantization instead of one per leaf.

Layout contract:

* Assignment is a pure function of ``(leaf order, leaf shapes, shard
  dims, bucket_bytes)``: identical on every rank with no communication.
  ``signature()`` fingerprints it with the reference's text and CRC32, so
  the same shapes give the same signature in both packages.
* Packing never splits a leaf: error-feedback residuals stay keyed per
  leaf.  A leaf larger than the target gets a bucket of its own.
* Within a bucket each leaf is packed as its ``(world, chunk)`` rows (the
  leaf moved so its shard dim leads, then cut into ``world`` chunks), so
  rank ``r``'s row of the buffer is the concatenation of each member
  leaf's ``r``-th shard, and a reduce-scatter over dim 0 hands every rank
  exactly the per-leaf shards the ZeRO-1 sharded update consumes.

Leaves are a ``dict`` of name -> tensor (or shape), in the model's
``named_parameters()`` order.
"""

import dataclasses
import math
import zlib
from typing import Any, Callable, Dict, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class BucketSlice:
    """One leaf's place inside a bucket buffer."""

    path: str
    shape: Tuple[int, ...]  # full (global) leaf shape
    dim: int  # dp shard dimension (GradLayout.dims[path])
    width: int  # per-rank chunk elements = prod(shape) // world
    offset: int  # column offset of this leaf's chunk in the bucket row


@dataclasses.dataclass(frozen=True)
class Bucket:
    index: int
    slices: Tuple[BucketSlice, ...]
    width: int  # row elements = sum of member widths

    def paths(self) -> List[str]:
        return [s.path for s in self.slices]


class BucketLayout:
    """Greedy size-targeted assignment of shardable leaves to buckets.

    ``bucket_bytes`` targets the fp32 FULL-leaf payload of a bucket
    (``4 * world * width``); leaves are taken in order and a bucket closes
    when adding the next leaf would exceed the target, or once it reaches
    the target."""

    def __init__(self, dims: Dict[str, Any], shapes: Dict[str, Tuple[int, ...]],
                 world: int, bucket_bytes: int):
        self.world = int(world)
        self.bucket_bytes = int(bucket_bytes)
        buckets: List[Bucket] = []
        cur: List[BucketSlice] = []
        cur_bytes = 0
        cur_width = 0

        def close():
            nonlocal cur, cur_bytes, cur_width
            if cur:
                buckets.append(Bucket(index=len(buckets), slices=tuple(cur),
                                      width=cur_width))
                cur, cur_bytes, cur_width = [], 0, 0

        for path, shape in shapes.items():
            dim = dims.get(path)
            if dim is None:
                continue  # non-shardable: rides the exact all-reduce
            elems = math.prod(shape) if shape else 1
            leaf_bytes = 4 * elems
            if cur and cur_bytes + leaf_bytes > self.bucket_bytes:
                close()
            cur.append(BucketSlice(path=path, shape=tuple(shape), dim=int(dim),
                                   width=elems // self.world,
                                   offset=cur_width))
            cur_bytes += leaf_bytes
            cur_width += elems // self.world
            if cur_bytes >= self.bucket_bytes:
                close()
        close()
        self.buckets: Tuple[Bucket, ...] = tuple(buckets)

    @classmethod
    def build(cls, layout, params: Dict[str, Any],
              bucket_bytes: int) -> "BucketLayout":
        """From a ``collectives.GradLayout`` and the params (tensors or
        shapes by name)."""
        shapes = {path: tuple(getattr(leaf, "shape", leaf))
                  for path, leaf in params.items()}
        return cls(layout.dims, shapes, layout.world, bucket_bytes)

    def __len__(self) -> int:
        return len(self.buckets)

    def signature(self) -> str:
        """Stable fingerprint of the full assignment: equal iff two ranks
        (or the two packages) derived the same bucket layout."""
        text = "|".join(
            f"{b.index}:{s.path}:{s.shape}:{s.dim}:{s.offset}"
            for b in self.buckets for s in b.slices
        ) + f"|world={self.world}"
        return f"{zlib.crc32(text.encode()):08x}"

    def bucket_of(self, path: str) -> int:
        for b in self.buckets:
            for s in b.slices:
                if s.path == path:
                    return b.index
        raise KeyError(path)

    # -- pack / unpack ------------------------------------------------------

    def pack(self, bucket: Bucket,
             get: Callable[[str], torch.Tensor]) -> torch.Tensor:
        """Full leaves -> one ``(world, width)`` row-aligned buffer."""
        rows = [torch.movedim(get(s.path), s.dim, 0).reshape(self.world,
                                                             s.width)
                for s in bucket.slices]
        return torch.cat(rows, dim=1) if len(rows) > 1 else rows[0]

    @staticmethod
    def _moved_shape(s: BucketSlice) -> Tuple[int, ...]:
        return (s.shape[s.dim],) + tuple(
            d for i, d in enumerate(s.shape) if i != s.dim)

    def unpack_shard(self, bucket: Bucket,
                     row: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One rank's ``(width,)`` bucket row -> per-leaf shards (the leaf
        cut to this rank's chunk along its shard dim)."""
        out = {}
        for s in bucket.slices:
            chunk_rows = s.shape[s.dim] // self.world
            piece = row[s.offset:s.offset + s.width].reshape(
                (chunk_rows,) + self._moved_shape(s)[1:])
            out[s.path] = torch.movedim(piece, 0, s.dim)
        return out

    def leaf_from_rows(self, s: BucketSlice,
                       piece: torch.Tensor) -> torch.Tensor:
        """``(world, s.width)`` rows of one leaf -> the full-shaped leaf
        (the per-slice inverse of ``pack``)."""
        return torch.movedim(piece.reshape(self._moved_shape(s)), 0, s.dim)

    def unpack_full(self, bucket: Bucket,
                    buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        """A full ``(world, width)`` buffer -> full-shaped leaves (the
        inverse of ``pack``; used for residuals and gathered params)."""
        return {
            s.path: self.leaf_from_rows(s, buf[:, s.offset:s.offset + s.width])
            for s in bucket.slices
        }
