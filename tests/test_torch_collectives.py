"""The port's grad-sync collectives (dlrover_tpu_torch/parallel/
collectives.py) against dlrover_tpu/parallel/collectives.py.

* GradSyncPolicy: the same validation errors, env resolution and derived
  fields; what this slice leaves out raises NotImplementedError.
* The wire codecs: encode_chunks / decode_chunks bit-identical to the JAX
  codecs under jit (tolerance zero), blockwise ties included.
* bucket_reduce_scatter over 4 gloo ranks (spawned processes, CPU) on the
  all_to_all and ring_pallas_q tiers, the exact reduce-scatter and the
  exact ring tiers (ring, ring_pallas, ring_rdma), against the JAX function
  under shard_map on 4 CPU devices.  On integer payloads whose blocks
  decode to exact integers, the shard rows and residuals are bit-exact.
  The exact ring tiers add in the reference's hop order, so their shard
  rows are bit-exact on random payloads too.  On random payloads the other
  shard rows agree within 2e-6 of the largest |value| (the ranks sum in
  another order than XLA, and XLA fuses a multiply into the add) and the
  residuals within 1e-6 of the largest |value|; on every rank the
  contribution is its dequantized codes plus its residual exactly.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from dlrover_tpu.ops.pallas import ring_reduce_scatter as jring  # noqa: E402
from dlrover_tpu.parallel import collectives as jcoll  # noqa: E402
from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh  # noqa: E402
from dlrover_tpu_torch.parallel import collectives as tcoll  # noqa: E402
from dlrover_tpu_torch.parallel import dp_workers, process_group  # noqa: E402
from torch_dp_checks import ef_violation  # noqa: E402

WORLD = 4
SPAWN_TIMEOUT_S = 120.0


# -- GradSyncPolicy ---------------------------------------------------------

BAD_POLICIES = [
    dict(mode="int2"), dict(rounding="floor"), dict(block_size=15),
    dict(block_size=4), dict(transport="nccl"), dict(bucket_mb=-1.0),
    dict(hi_frac=0.0), dict(hi_frac=1.5),
]


@pytest.mark.parametrize("kwargs", BAD_POLICIES,
                         ids=[next(iter(k)) + "=" + str(next(iter(k.values())))
                              for k in BAD_POLICIES])
def test_policy_validation_matches_reference(kwargs):
    with pytest.raises(ValueError) as want:
        jcoll.GradSyncPolicy(**kwargs)
    with pytest.raises(ValueError) as got:
        tcoll.GradSyncPolicy(**kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", tcoll.GRAD_SYNC_MODES)
def test_policy_fields_match_reference(mode):
    j, t = jcoll.GradSyncPolicy(mode=mode), tcoll.GradSyncPolicy(mode=mode)
    for field in ("active", "quantized", "qformat", "sharded_update"):
        assert getattr(t, field) == getattr(j, field), field
    for nblk in (1, 3, 8, 64, 1000):
        assert t.hi_blocks(nblk) == j.hi_blocks(nblk)
    assert tcoll.GradSyncPolicy.parse(mode) == t
    assert tcoll.GradSyncPolicy.parse(t) is t


def test_policy_resolve_reads_the_same_knobs(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_GRAD_BUCKET_MB", "2.5")
    monkeypatch.setenv("DLROVER_TPU_GRAD_TRANSPORT", "ring_pallas_q")
    monkeypatch.setenv("DLROVER_TPU_GRAD_HI_FRAC", "0.25")
    j = jcoll.GradSyncPolicy(mode="int4_sharded").resolve()
    t = tcoll.GradSyncPolicy(mode="int4_sharded").resolve()
    for field in ("bucket_mb", "transport", "hi_frac"):
        assert getattr(t, field) == getattr(j, field), field
    assert (t.bucket_mb, t.transport, t.hi_frac) == (2.5, "ring_pallas_q",
                                                     0.25)
    # explicit fields win over the knobs
    t = tcoll.GradSyncPolicy(mode="int8", bucket_mb=0.0, transport="ring",
                             hi_frac=0.5).resolve()
    assert (t.bucket_mb, t.transport, t.hi_frac) == (0.0, "ring", 0.5)


def test_policy_resolve_defaults_and_malformed_knob(monkeypatch, caplog):
    for name in ("DLROVER_TPU_GRAD_BUCKET_MB", "DLROVER_TPU_GRAD_TRANSPORT",
                 "DLROVER_TPU_GRAD_HI_FRAC"):
        monkeypatch.delenv(name, raising=False)
    t = tcoll.GradSyncPolicy(mode="int8").resolve()
    assert (t.bucket_mb, t.transport, t.hi_frac) == (4.0, "auto", 0.125)
    monkeypatch.setenv("DLROVER_TPU_GRAD_BUCKET_MB", "four")
    with caplog.at_level("WARNING"):
        assert tcoll.GradSyncPolicy(mode="int8").resolve().bucket_mb == 4.0
    assert "not a valid float" in caplog.text


def test_left_out_options_raise_not_implemented():
    with pytest.raises(NotImplementedError, match="stochastic"):
        tcoll.GradSyncPolicy(mode="int8", rounding="stochastic")
    with pytest.raises(NotImplementedError, match="hierarchical"):
        tcoll.GradSyncPolicy(mode="int8", hierarchical=True)
    tcoll.GradSyncPolicy(mode="int8", hierarchical=False)  # the flat sync
    with pytest.raises(NotImplementedError, match="later slice"):
        tcoll.blockwise_quantize(torch.zeros(2, 8), rounding="stochastic")


def test_shard_dims_and_bytes_match_reference():
    shapes = {"a": (16, 4), "b": (7,), "c": (3, 12, 5), "d": (),
              "e": (256, 64)}
    params = {n: np.zeros(s, np.float32) for n, s in shapes.items()}
    for world in (1, 2, 4):
        assert tcoll.GradLayout(shapes, world).dims == \
            jcoll.GradLayout(params, world).dims
        for mode in tcoll.GRAD_SYNC_MODES:
            assert tcoll.estimate_sync_bytes(
                shapes, world, tcoll.GradSyncPolicy(mode=mode)
            ) == jcoll.estimate_sync_bytes(
                params, world, jcoll.GradSyncPolicy(mode=mode))
    for mode in ("int8", "int4", "blockwise"):
        for nblk, block in ((1, 256), (7, 64), (100, 256)):
            assert tcoll.codec_chunk_bytes(
                nblk, block, tcoll.GradSyncPolicy(mode=mode)
            ) == jcoll.codec_chunk_bytes(
                nblk, block, jcoll.GradSyncPolicy(mode=mode))


# -- codecs -----------------------------------------------------------------


def _codec_input(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((WORLD, 16, 64))
         * rng.uniform(1e-3, 10, (WORLD, 16, 1))).astype(np.float32)
    x[0, 3] = 0.0
    # tied block maxima: top-k must keep the lower index first
    x[1, 2:6] = 0.0
    x[1, 2:6, 5] = 42.0
    x[2, :, 0] = 9.0  # every block of chunk 2 ties
    return x


@pytest.mark.parametrize("mode", ["int8", "int4", "blockwise"])
@pytest.mark.parametrize("hi_frac", [0.125, 0.3])
def test_codecs_bit_identical_to_reference(mode, hi_frac):
    x = _codec_input()
    jpol = jcoll.GradSyncPolicy(mode=mode, block_size=64, hi_frac=hi_frac)
    tpol = tcoll.GradSyncPolicy(mode=mode, block_size=64, hi_frac=hi_frac)
    want = jax.jit(lambda v: jcoll.encode_chunks(v, jpol))(jnp.asarray(x))
    got = tcoll.encode_chunks(torch.from_numpy(x), tpol)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype, k
        assert np.array_equal(got[k].numpy(), w), k
    dec_want = jax.jit(lambda p: jcoll.decode_chunks(p, jpol))(want)
    dec_got = tcoll.decode_chunks(got, tpol)
    assert np.array_equal(dec_got.numpy(), np.asarray(dec_want))


def test_top_blocks_breaks_ties_to_the_lower_index():
    maxabs = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0] * 5])
    assert tcoll.top_blocks(maxabs, 3).tolist() == [[1, 2, 4], [0, 1, 2]]


# -- reduce-scatter over 4 ranks -------------------------------------------


def _int_payload(rng, mode, width):
    """(WORLD ranks, WORLD rows, width) integer payload whose every block
    decodes exactly: int8 blocks reach +-127 (scale 1); int4 blocks reach
    +-7; blockwise chunks hold one block reaching 127 (refined, int8 scale
    1) and the rest reaching 7 (int4 scale 1)."""
    qmax = 127 if mode.startswith("int8") else 7
    v = rng.integers(-qmax, qmax + 1, size=(WORLD, WORLD, width))
    v[..., ::256] = qmax
    if mode.startswith("blockwise"):
        v[..., 256:512] = rng.integers(-127, 128, size=(WORLD, WORLD, 256))
        v[..., 300] = -127
    return v.astype(np.float32)


def _rand_payload(rng, width):
    return (rng.standard_normal((WORLD, WORLD, width))
            * rng.uniform(1e-3, 1.0, (WORLD, WORLD, 1))).astype(np.float32)


CASES = [
    # (name, mode, transport, width, payload kind)
    (f"{mode}-{transport}-{kind}", mode, transport, width, kind)
    for mode in ("int8_sharded", "int4_sharded", "blockwise_sharded")
    for transport in ("all_to_all", "ring_pallas_q")
    for kind, width in (("int", 2048), ("rand", 1000))
] + [
    (f"exact_sharded-{transport}-{kind}", "exact_sharded", transport, width,
     kind)
    for transport in ("auto", "ring", "ring_pallas", "ring_rdma")
    for kind, width in (("int", 2048), ("rand", 1000))
]
EXACT_RINGS = ("ring", "ring_pallas", "ring_rdma")


def _payloads():
    """By case name; the two transports of a mode share their payload."""
    by_mode = {}
    for name, mode, _, width, kind in CASES:
        if (mode, kind) not in by_mode:
            rng = np.random.default_rng(len(by_mode))
            by_mode[mode, kind] = (_int_payload(rng, mode, width)
                                   if kind == "int"
                                   else _rand_payload(rng, width))
    return {name: by_mode[mode, kind] for name, mode, _, _, kind in CASES}


@pytest.fixture(scope="module")
def rs_results():
    """Every case through 4 gloo ranks in ONE spawn (the port), and
    through shard_map on 4 CPU devices (the reference)."""
    payloads = _payloads()
    cases = [dict(policy=dict(mode=mode, bucket_mb=4.0), transport=transport,
                  payload=payloads[name])
             for name, mode, transport, _, _ in CASES]
    ranks = process_group.spawn(dp_workers.reduce_scatter_worker, WORLD,
                                (cases,), device="cpu",
                                timeout_s=SPAWN_TIMEOUT_S)
    mesh = build_mesh(MeshConfig(dp=WORLD), devices=jax.devices()[:WORLD])
    out = {}
    for i, (name, mode, transport, width, _) in enumerate(CASES):
        policy = jcoll.GradSyncPolicy(mode=mode, bucket_mb=4.0)

        def body(buf, policy=policy, transport=transport, width=width):
            chunk, resid = jcoll.bucket_reduce_scatter(
                buf.reshape(WORLD, width), policy, "dp", WORLD,
                transport=transport)
            if resid is None:
                resid = jnp.zeros((WORLD, width), jnp.float32)
            return chunk[None], resid[None]

        fn = jax.jit(jcoll.shard_map_unchecked(
            body, mesh=mesh, in_specs=P("dp"), out_specs=(P("dp"), P("dp"))))
        chunk, resid = fn(jnp.asarray(
            payloads[name].reshape(WORLD, WORLD * width)))
        out[name] = (np.asarray(chunk), np.asarray(resid),
                     [r[i] for r in ranks], payloads[name])
    return out


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bucket_reduce_scatter_matches_shard_map(rs_results, case):
    name, mode, transport, _, kind = case
    want_chunk, want_resid, ranks, payload = rs_results[name]
    got_chunk = np.stack([r["shard"] for r in ranks])
    scale = np.abs(payload).max()
    if transport in EXACT_RINGS:
        assert np.array_equal(got_chunk, want_chunk)
    if kind == "int":
        assert np.array_equal(got_chunk, want_chunk)
        assert np.array_equal(got_chunk, payload.sum(axis=0))
    else:
        np.testing.assert_allclose(got_chunk, want_chunk, rtol=0,
                                   atol=2e-6 * scale)
    if mode.startswith("exact"):
        assert all(r["residual"] is None for r in ranks)
        return
    got_resid = np.stack([r["residual"] for r in ranks])
    if kind == "int":
        assert np.array_equal(got_resid, want_resid)
    else:
        np.testing.assert_allclose(got_resid, want_resid, rtol=0,
                                   atol=1e-6 * scale)
    # the error-feedback invariant, exactly, on every rank
    policy = tcoll.GradSyncPolicy(mode=mode, bucket_mb=4.0)
    violations = [ef_violation(torch.from_numpy(payload[rank]),
                               torch.from_numpy(r["residual"]), policy)
                  for rank, r in enumerate(ranks)]
    assert violations == [0.0] * WORLD


def test_ring_and_all_to_all_agree_on_residuals(rs_results):
    """Every source is encoded once from its original values, so the two
    tiers keep the same error-feedback state, bit for bit."""
    for mode in ("int8_sharded", "int4_sharded", "blockwise_sharded"):
        for kind in ("int", "rand"):
            a = rs_results[f"{mode}-all_to_all-{kind}"][2]
            r = rs_results[f"{mode}-ring_pallas_q-{kind}"][2]
            for x, y in zip(a, r):
                assert np.array_equal(x["residual"], y["residual"])


def test_every_exact_tier_resolves_and_runs(rs_results):
    """Each exact ring request runs on every rank and resolves as in the
    reference: ring_pallas where the width meets the tiling rule, ring_rdma
    without cards falling back to those two.  On the CPU no kernel runs."""
    expect = {("ring", 2048): "ring", ("ring", 1000): "ring",
              ("ring_pallas", 2048): "ring_pallas",
              ("ring_pallas", 1000): "ring",
              ("ring_rdma", 2048): "ring_pallas",
              ("ring_rdma", 1000): "ring"}
    for (transport, width), want in expect.items():
        kind = "int" if width == 2048 else "rand"
        ranks = rs_results[f"exact_sharded-{transport}-{kind}"][2]
        policy = jcoll.GradSyncPolicy(mode="exact_sharded", bucket_mb=4.0,
                                      transport=transport)
        assert jring.resolve_transport(policy, WORLD, width, "dp") == want
        for r in ranks:
            assert r["transport"] == want
            assert set(r["launches"].values()) == {0}


def test_ranks_run_on_the_card_unless_asked(monkeypatch):
    """Like every entry point of the port: without a card, the default
    placement raises before any rank starts, and only device="cpu" runs
    the ranks on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        process_group.spawn(dp_workers.reduce_scatter_worker, WORLD, ([],))
    process_group.check_placement("gloo", "cpu", WORLD)


def test_nccl_refuses_two_ranks_on_one_device():
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        process_group.check_placement("nccl", "cuda",
                                      torch.cuda.device_count() + 1)
