"""The port's bucket layout (dlrover_tpu_torch/parallel/bucketing.py)
against dlrover_tpu/parallel/bucketing.py: the same buckets and the same
signature() text and CRC32 for the same shapes, and pack / unpack
bit-identical (pure data movement, tolerance zero)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.parallel import bucketing as jb  # noqa: E402
from dlrover_tpu.parallel import collectives as jcoll  # noqa: E402
from dlrover_tpu_torch.models.llama import (  # noqa: E402
    LlamaConfig,
    LlamaForCausalLM,
)
from dlrover_tpu_torch.parallel import bucketing as tb  # noqa: E402
from dlrover_tpu_torch.parallel import collectives as tcoll  # noqa: E402

SHAPES = {
    "a/kernel": (16, 4), "a/bias": (32,), "b/kernel": (64, 8),
    "b/bias": (7,), "c/kernel": (3, 12, 5), "d/scale": (),
    "e/kernel": (256, 64), "f/kernel": (5, 7), "g/kernel": (8, 8, 8),
}


def _layouts(shapes, world, bucket_bytes):
    dims = {p: jcoll.shard_dim_for(s, world) for p, s in shapes.items()}
    assert dims == {p: tcoll.shard_dim_for(s, world)
                    for p, s in shapes.items()}
    return (jb.BucketLayout(dims, shapes, world, bucket_bytes),
            tb.BucketLayout(dims, shapes, world, bucket_bytes))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("bucket_bytes", [64, 1024, 4096, 1 << 20])
def test_same_buckets_and_signature(world, bucket_bytes):
    jl, tl = _layouts(SHAPES, world, bucket_bytes)
    assert len(tl) == len(jl)
    for jbk, tbk in zip(jl.buckets, tl.buckets):
        assert tbk.width == jbk.width and tbk.index == jbk.index
        assert [dataclass_tuple(s) for s in tbk.slices] == \
            [dataclass_tuple(s) for s in jbk.slices]
    assert tl.signature() == jl.signature()
    for path in jcoll.GradLayout(
            {p: np.zeros(s) for p, s in SHAPES.items()}, world
    ).sharded_paths():
        assert tl.bucket_of(path) == jl.bucket_of(path)


def dataclass_tuple(s):
    return (s.path, tuple(s.shape), s.dim, s.width, s.offset)


def test_signature_of_the_llama_layout():
    """The tiny Llama's leaves in named_parameters() order: the port's
    GradLayout and BucketLayout.build give the reference's signature."""
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    for world in (2, 4):
        tlayout = tcoll.GradLayout(shapes, world)
        jlayout = jcoll.GradLayout(
            {n: np.zeros(s, np.float32) for n, s in shapes.items()}, world)
        assert tlayout.dims == {
            n.replace("/", "."): d for n, d in jlayout.dims.items()}
        for bucket_bytes in (4096, 64 * 1024, 4 << 20):
            tl = tb.BucketLayout.build(tlayout, shapes, bucket_bytes)
            jl = jb.BucketLayout(jlayout.dims, shapes, world, bucket_bytes)
            assert tl.signature() == jl.signature()


@pytest.mark.parametrize("world", [2, 4])
def test_pack_and_unpack_match_reference(world):
    jl, tl = _layouts(SHAPES, world, 2048)
    rng = np.random.default_rng(world)
    leaves = {p: rng.standard_normal(s).astype(np.float32)
              for p, s in SHAPES.items()}
    for jbk, tbk in zip(jl.buckets, tl.buckets):
        want = np.array(jl.pack(jbk, lambda p: jnp.asarray(leaves[p])))
        got = tl.pack(tbk, lambda p: torch.from_numpy(leaves[p]))
        assert np.array_equal(got.numpy(), want)
        for r in range(world):
            jshard = jl.unpack_shard(jbk, jnp.asarray(want[r]))
            tshard = tl.unpack_shard(tbk, torch.from_numpy(want[r]))
            assert set(tshard) == set(jshard)
            for p in jshard:
                assert np.array_equal(tshard[p].numpy(),
                                      np.asarray(jshard[p]))
        jfull = jl.unpack_full(jbk, jnp.asarray(want))
        tfull = tl.unpack_full(tbk, torch.from_numpy(want))
        for p in jfull:
            assert np.array_equal(tfull[p].numpy(), np.asarray(jfull[p]))
            assert np.array_equal(tfull[p].numpy(), leaves[p])
        for s_j, s_t in zip(jbk.slices, tbk.slices):
            piece = want[:, s_j.offset:s_j.offset + s_j.width]
            assert np.array_equal(
                tl.leaf_from_rows(s_t, torch.from_numpy(piece)).numpy(),
                np.asarray(jl.leaf_from_rows(s_j, jnp.asarray(piece))))


def test_oversized_leaf_gets_its_own_bucket():
    _, tl = _layouts(SHAPES, 4, 512)
    big = tl.bucket_of("e/kernel")
    assert tl.buckets[big].paths() == ["e/kernel"]
    with pytest.raises(KeyError):
        tl.bucket_of("b/bias")  # 7 elements: not shardable over 4
