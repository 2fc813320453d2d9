"""The port's fused quantize and dequant-accumulate
(dlrover_tpu_torch/ops/cuda/ring_reduce_scatter.py) against the Pallas
kernels of dlrover_tpu/ops/pallas/ring_reduce_scatter.py run in interpret
mode, and against the JAX package's codecs under jit: bit-identical
(np.array_equal, tolerance zero) on seeded and edge inputs.  The port's
transport selection against the reference's over a grid of arguments.

On the CPU the port's wrappers run their plain versions; the CUDA kernels
are held against the same plain versions on the card by chip_smoke.py."""

import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.ops.pallas import ring_reduce_scatter as jring  # noqa: E402
from dlrover_tpu.parallel import collectives as jcoll  # noqa: E402
from dlrover_tpu_torch.ops.cuda import ring_reduce_scatter as ring  # noqa: E402


def edge_rows(block: int, seed: int = 0) -> np.ndarray:
    """(16, block) fp32 rows: zero blocks, exact .5 ties at scale 1 for
    int8 (max 127) and int4 (max 7), values at +-max (the codes saturate
    at +-127 / +-7), negative-only rows (negative nibbles), rows of one
    nonzero value, and seeded rows over six decades of magnitude."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((16, block), np.float32)
    half = np.arange(block, dtype=np.float32) % 127 - 63 + 0.5
    rows[1] = half
    rows[1, 0] = 127.0
    rows[2] = (np.arange(block) % 14 - 7 + 0.5).astype(np.float32)
    rows[2, :2] = (7.0, -7.0)
    rows[3] = np.where(np.arange(block) % 2, 3.0, -3.0)  # all at +-max
    rows[4] = -np.abs(rng.standard_normal(block)).astype(np.float32)
    rows[5, 7] = -2.5e-3
    rows[6] = rng.choice([-1.0, 1.0], block) * 1e-6
    for r in range(7, 16):
        rows[r] = (rng.standard_normal(block)
                   * 10.0 ** rng.uniform(-4, 2)).astype(np.float32)
    return rows


def _inputs(block: int):
    x = edge_rows(block)
    rng = np.random.default_rng(block)
    seeded = (rng.standard_normal((48, block))
              * rng.uniform(1e-3, 1e2, (48, 1))).astype(np.float32)
    return np.concatenate([x, seeded]).reshape(4, 16, block)


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("block", [256, 512])
def test_fused_quantize_bit_identical_to_pallas(fmt, block):
    x = _inputs(block)
    want = jring.fused_quantize(jnp.asarray(x), fmt, interpret=True)
    got = ring.fused_quantize(torch.from_numpy(x), fmt)
    for name, w, g in zip(("codes", "scales", "dequant"), want, got):
        w = np.array(w)
        assert g.dtype == torch.from_numpy(w).dtype, name
        assert np.array_equal(g.numpy(), w), name


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_fused_quantize_bit_identical_to_jitted_codecs(fmt):
    """The two-stage codecs of the JAX package, as its trainer runs them
    (under jit), give the codes and scales of the fused kernel."""
    x = _inputs(256)
    q, s, d = ring.fused_quantize(torch.from_numpy(x), fmt)
    if fmt == "int8":
        wq, ws = jax.jit(jcoll.blockwise_quantize)(jnp.asarray(x))
        wd = jax.jit(jcoll.blockwise_dequantize)(wq, ws)
    else:
        wq, ws = jax.jit(jcoll.blockwise_quantize4)(jnp.asarray(x))
        wd = jax.jit(jcoll.blockwise_dequantize4)(wq, ws)
    for g, w in ((q, wq), (s, ws), (d, wd)):
        assert np.array_equal(g.numpy(), np.asarray(w))


def _accum_inputs(fmt: str, block: int = 256):
    rng = np.random.default_rng(7)
    nblk = 24
    acc = rng.standard_normal((nblk, block)).astype(np.float32)
    qcols = block if fmt == "int8" else block // 2
    low = -127 if fmt == "int8" else -128
    q = rng.integers(low, 128, (nblk, qcols)).astype(np.int8)
    s = rng.uniform(1e-4, 1.0, (nblk, 1)).astype(np.float32)
    s[3] = 0.0
    acc[4] = 0.0
    if fmt == "int8":
        # one fused rounding, not two: acc 1.0 plus code 59 times
        # 9099507 * 2**-53 is 1 + 2**-24 + 2**-53 exactly, just above the
        # midpoint of 1 and 1 + 2**-23; rounding the sum to fp64 first
        # would land on the midpoint and round down to 1.0
        acc[5, 0] = 1.0
        s[5] = np.float32(9099507 * 2.0 ** -53)
        q[5, 0] = 59
    return acc, q, s


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_fused_dequant_add_bit_identical_to_pallas(fmt):
    acc, q, s = _accum_inputs(fmt)
    want = np.asarray(jring.fused_dequant_add(
        jnp.asarray(acc), jnp.asarray(q), jnp.asarray(s), fmt,
        interpret=True))
    got = ring.fused_dequant_add(torch.from_numpy(acc), torch.from_numpy(q),
                                 torch.from_numpy(s), fmt)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    if fmt == "int8":
        assert want[5, 0] == np.float32(1.0) + np.float32(2.0 ** -23)


def test_fused_dequant_add_into_out():
    acc, q, s = _accum_inputs("int8")
    acc_t = torch.from_numpy(acc.copy())
    want = ring.fused_dequant_add(acc_t, torch.from_numpy(q),
                                  torch.from_numpy(s), "int8")
    out = ring.fused_dequant_add(acc_t, torch.from_numpy(q),
                                 torch.from_numpy(s), "int8", out=acc_t)
    assert out is acc_t
    assert torch.equal(acc_t, want)


def test_nibbles_round_trip():
    codes = torch.from_numpy(np.random.default_rng(3).integers(
        -7, 8, (5, 64)).astype(np.int8))
    packed = ring.pack_nibbles(codes)
    assert packed.shape == (5, 32) and packed.dtype == torch.int8
    assert torch.equal(ring.unpack_nibbles(packed), codes)
    want = jcoll.blockwise_dequantize4(jnp.asarray(packed.numpy()),
                                       jnp.ones((5, 1), jnp.float32))
    assert np.array_equal(np.asarray(want), codes.float().numpy())


def test_unknown_format_raises():
    x = torch.zeros(1, 1, 256)
    with pytest.raises(ValueError, match="format"):
        ring.fused_quantize(x, "blockwise")
    with pytest.raises(ValueError, match="format"):
        ring.fused_dequant_add(x[0], x[0].to(torch.int8), x[0, :, :1], "fp8")


def test_pallas_q_supported_matches_reference():
    for block, fmt in itertools.product(
            (8, 128, 256, 384, 512, 1024), (None, "int8", "int4",
                                             "blockwise", "exact")):
        assert ring.pallas_q_supported(block, fmt) == \
            jring.pallas_q_supported(block, fmt)


_GRID = list(itertools.product(
    ("auto", "all_to_all", "ring", "ring_pallas", "ring_rdma",
     "ring_pallas_q"),
    (False, True),  # quantized
    (1, 2, 4),  # world
    (1000, 1024, 4096),  # width
    (False, True),  # rdma_enabled
    (False, True),  # multi_axis
    (None, "int8", "int4", "blockwise"),
    ("nearest", "stochastic"),
    (128, 256, 512),  # block_size
))


def test_select_transport_truth_table_matches_reference():
    for args in _GRID:
        (transport, quantized, world, width, rdma, multi, qformat,
         rounding, block) = args
        kw = dict(multi_axis=multi, qformat=qformat, rounding=rounding,
                  block_size=block)
        want = jring.select_transport(transport, quantized, world, width,
                                      rdma, **kw)
        got = ring.select_transport(transport, quantized, world, width,
                                    rdma, **kw)
        assert got == want, args


@pytest.mark.parametrize("mode", ["exact_sharded", "int8_sharded",
                                  "int4", "blockwise_sharded"])
@pytest.mark.parametrize("transport", ["auto", "ring_pallas_q", "ring",
                                       "ring_rdma"])
def test_resolve_transport_matches_reference(mode, transport):
    from dlrover_tpu_torch.parallel.collectives import GradSyncPolicy

    jpol = jcoll.GradSyncPolicy(mode=mode, transport=transport)
    tpol = GradSyncPolicy(mode=mode, transport=transport)
    for world, width in itertools.product((1, 4), (512, 2048)):
        for axis in ("dp", ("slice", "dp")):
            assert ring.resolve_transport(tpol, world, width, axis) == \
                jring.resolve_transport(jpol, world, width, axis)


def test_rdma_ring_needs_two_peer_cards():
    """The one-kernel ring resolves only with a CUDA device per rank (at
    least two) whose neighbours reach each other's memory: ranks that
    share a card time-slice it.  Without them ring_rdma falls back to the
    ring."""
    for world in (1, 2, 4, 8):
        if torch.cuda.device_count() < max(2, world):
            assert not ring.rdma_available(world)
    if torch.cuda.device_count() < 4:
        assert ring.select_transport("ring_rdma", False, 4, 4096,
                                     True) == "ring_pallas"
        assert ring.select_transport("ring_rdma", False, 4, 1000,
                                     True) == "ring"
