"""The port's exact ring reduce-scatter tiers against the JAX package.

* ``ring_add`` / ``add_plain`` (the ``ring_pallas`` hop, kernel
  ``add_kernel`` of dlrover_tpu_torch/csrc/ring_reduce_scatter.cu) against
  the reference's ``_pallas_add`` in interpret mode: bit-identical.
* ``rdma_ring_plain`` (the plain version of the one-kernel ring,
  dlrover_tpu_torch/csrc/rdma_ring.cu) against the reference's jnp
  ``ring_reduce_scatter`` under ``shard_map`` on 2, 4 and 8 CPU devices:
  bit-identical on seeded random fp32 (the same hop order), and
  bit-identical to ``psum_scatter`` on integer payloads (sums below 2**24
  are exact in any order).
* ``ring_reduce_scatter`` (both adds) and ``rdma_ring_reduce_scatter`` on
  CPU tensors, over W ranks run as threads of this process: the plain
  ring's bits.
* The wrappers on CPU tensors take the plain versions and count no launch;
  on any other tensor they check their inputs and launch or raise.
  ``PeerWindow`` refuses a group on the CPU.

The ``cuda``-marked cases hold ``ring_add`` and ``rdma_ring_one_card``
against their plain versions on the card (``torch.equal``) and skip here.
The JAX side is imported by the ``ref`` fixture, so that they also run on
the card's machine, which has no JAX (README: ``-m cuda`` with
``--noconftest``).
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.ops.cuda import rdma_ring
from dlrover_tpu_torch.ops.cuda import ring_reduce_scatter as ring
from dlrover_tpu_torch.parallel.peer_memory import PeerWindow


@pytest.fixture(scope="module")
def ref():
    """The reference's ring kernels and a shard_map runner on CPU devices."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from dlrover_tpu.ops.pallas import ring_reduce_scatter as jring
    from dlrover_tpu.parallel.collectives import shard_map_unchecked
    from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh

    def run(body, x):
        world = x.shape[0]
        mesh = build_mesh(MeshConfig(dp=world), devices=jax.devices()[:world])
        fn = shard_map_unchecked(lambda t: body(t[0], world)[None],
                                 mesh=mesh, in_specs=P("dp"),
                                 out_specs=P("dp"))
        return np.asarray(jax.jit(fn)(jnp.asarray(x))).reshape(world, -1)

    def run_ring(x, accum="jnp"):
        return run(lambda t, w: jring.ring_reduce_scatter(
            t, "dp", w, accum=accum, interpret=True), x)

    def run_psum_scatter(x):
        return run(lambda t, w: jax.lax.psum_scatter(
            t, "dp", scatter_dimension=0, tiled=True).reshape(-1), x)

    return types.SimpleNamespace(jnp=jnp, jring=jring, run_ring=run_ring,
                                 run_psum_scatter=run_psum_scatter)


def _rand(shape, seed):
    """fp32 over six decades of magnitude, so that the add order shows in
    the bits."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            * 10.0 ** rng.uniform(-3, 3, shape)).astype(np.float32)


# -- the hop add -------------------------------------------------------------


@pytest.mark.parametrize("width", [1024, 4096])
def test_add_plain_bit_identical_to_pallas(ref, width):
    a, b = _rand((width,), 1), _rand((width,), 2)
    want = np.asarray(ref.jring._pallas_add(ref.jnp.asarray(a),
                                            ref.jnp.asarray(b),
                                            interpret=True))
    got = ring.add_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(ring.ring_add(torch.from_numpy(a),
                                        torch.from_numpy(b)).numpy(), want)


@pytest.mark.parametrize("width", [1, 3, 1000, 1024])
def test_ring_add_on_cpu_takes_the_plain_version(width):
    a = torch.from_numpy(_rand((width,), 3))
    b = torch.from_numpy(_rand((width,), 4))
    want = ring.add_plain(a, b)
    ring.reset_launches()
    assert torch.equal(ring.ring_add(a, b), want)
    out = ring.ring_add(a, b, out=a)  # in place, as a hop accumulates
    assert out is a and torch.equal(a, want)
    assert ring.launches["add"] == 0


def test_wrappers_never_take_the_plain_path_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel wrapper, which
    checks what the kernel takes and launches or raises."""
    a = torch.zeros(1024, device="meta")
    with pytest.raises(RuntimeError, match="nvcc|CUDA"):
        ring.ring_add(a, a)
    with pytest.raises(TypeError, match="float32"):
        ring.ring_add(a.double(), a.double())
    xs = torch.zeros(4, 4, 100, device="meta")
    with pytest.raises(ValueError, match="multiple of 128"):
        rdma_ring.rdma_ring_one_card(xs, None)
    with pytest.raises(ValueError, match="OneCardWindows"):
        rdma_ring.rdma_ring_one_card(torch.zeros(4, 4, 128, device="meta"),
                                     None)
    group = types.SimpleNamespace(rank=0, world=4)
    with pytest.raises(ValueError, match="PeerWindow"):
        rdma_ring.rdma_ring_reduce_scatter(torch.zeros(4, 256, device="meta"),
                                           group, None)


# -- the ring's arithmetic ---------------------------------------------------


@pytest.mark.parametrize("world", [2, 4, 8])
def test_rdma_ring_plain_bit_identical_to_the_jax_ring(ref, world):
    x = _rand((world, world, 256), world)
    want = ref.run_ring(x)
    got = rdma_ring.rdma_ring_plain(torch.from_numpy(x))
    assert np.array_equal(got.numpy(), want)
    if world > 2:  # the hop order shows at these magnitudes
        assert not np.array_equal(x.sum(axis=0), want)


def test_rdma_ring_plain_bit_identical_to_the_pallas_add_ring(ref):
    x = _rand((4, 4, 1024), 11)
    want = ref.run_ring(x, accum="pallas")
    assert np.array_equal(rdma_ring.rdma_ring_plain(
        torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("world", [2, 4, 8])
def test_rdma_ring_plain_equals_psum_scatter_on_integers(ref, world):
    x = np.random.default_rng(world).integers(
        -1000, 1000, (world, world, 384)).astype(np.float32)
    got = rdma_ring.rdma_ring_plain(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, ref.run_psum_scatter(x))
    assert np.array_equal(got, x.sum(axis=0))


def test_rdma_ring_one_card_on_cpu_takes_the_plain_version():
    xs = torch.from_numpy(_rand((4, 4, 512), 5))
    rdma_ring.reset_launches()
    assert torch.equal(rdma_ring.rdma_ring_one_card(xs, None),
                       rdma_ring.rdma_ring_plain(xs))
    assert rdma_ring.launches["rdma_ring"] == 0


# -- the ring over ranks -----------------------------------------------------


class _ThreadRank:
    """One of W ranks run as threads of this process, with the members of
    ``process_group.DpGroup`` that the exact ring uses."""

    def __init__(self, rank, world, board):
        self.rank, self.world = rank, world
        self.device = torch.device("cpu")
        self._board = board

    def shift(self, tensors, d):
        """Send to ``rank - d``, receive from ``rank + d``, as DpGroup."""
        box, barrier = self._board["box"], self._board["barrier"]
        box[self.rank] = {k: v.clone() for k, v in tensors.items()}
        barrier.wait()
        got = {k: v.clone() for k, v in box[(self.rank + d) % self.world]
               .items()}
        barrier.wait()
        return got


def _on_threads(fn, xs):
    """``fn(x_r, rank)`` on W threads, rank r's buffer ``xs[r]``."""
    world = xs.shape[0]
    board = {"box": [None] * world,
             "barrier": threading.Barrier(world, timeout=30)}
    out = [None] * world
    errors = []

    def body(r):
        try:
            out[r] = fn(xs[r], _ThreadRank(r, world, board))
        except BaseException as e:  # reported by the caller
            errors.append(e)
            board["barrier"].abort()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return torch.stack(out)


ENTRY_POINTS = {
    "ring": lambda x, g: ring.ring_reduce_scatter(x, g, accum="torch"),
    "ring_pallas": lambda x, g: ring.ring_reduce_scatter(x, g,
                                                         accum="kernel"),
    "ring_rdma": lambda x, g: rdma_ring.rdma_ring_reduce_scatter(x, g, None),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
@pytest.mark.parametrize("world,width", [(3, 1000), (4, 2048)])
def test_ring_over_ranks_gives_the_plain_bits(entry, world, width):
    xs = torch.from_numpy(_rand((world, world, width), world + width))
    got = _on_threads(ENTRY_POINTS[entry], xs)
    assert torch.equal(got, rdma_ring.rdma_ring_plain(xs))


def test_world_of_one_returns_the_row():
    x = torch.arange(8.0).reshape(1, 8)
    group = types.SimpleNamespace(rank=0, world=1)
    assert torch.equal(ring.ring_reduce_scatter(x, group, "kernel"),
                       torch.arange(8.0))


def test_peer_window_refuses_a_cpu_group():
    group = types.SimpleNamespace(rank=0, world=4,
                                  device=torch.device("cpu"))
    with pytest.raises(ValueError, match="device memory"):
        PeerWindow(group, 4096)


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 3, 1000, 1024, 4097])
def test_ring_add_matches_plain_on_card(cuda_device, width):
    g = torch.Generator(device=cuda_device).manual_seed(width)
    a = torch.randn(width, generator=g, device=cuda_device)
    b = torch.randn(width, generator=g, device=cuda_device) * 1e3
    want = ring.add_plain(a, b)
    assert torch.equal(ring.ring_add(a, b), want)
    ring.ring_add(a, b, out=a)
    assert torch.equal(a, want)


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4, 8])
def test_rdma_ring_one_card_matches_plain_on_card(cuda_device, world):
    g = torch.Generator(device=cuda_device).manual_seed(world)
    with rdma_ring.OneCardWindows(cuda_device, world, 4096) as windows:
        for width in (128, 4096):
            xs = torch.randn(world, world, width, generator=g,
                             device=cuda_device)
            want = rdma_ring.rdma_ring_plain(xs)
            for _ in range(3):  # generations and slots reused across calls
                assert torch.equal(rdma_ring.rdma_ring_one_card(xs, windows),
                                   want)
        windows.check()


@pytest.mark.cuda
def test_rdma_ring_raises_when_peers_never_arrive(cuda_device):
    """Skipping generations leaves every entry barrier short of its count:
    each bounded wait runs out and check() raises instead of hanging.  A
    second call queued on the broken windows leaves at once, so both take
    one timeout; fresh windows give the right sum again."""
    xs = torch.randn(2, 2, 128, device=cuda_device)
    with rdma_ring.OneCardWindows(cuda_device, 2, 128,
                                  timeout_s=1.0) as windows:
        rdma_ring.rdma_ring_one_card(xs, windows)
        windows.check()
        windows.generation += 5
        t0 = time.perf_counter()
        rdma_ring.rdma_ring_one_card(xs, windows)
        rdma_ring.rdma_ring_one_card(xs, windows)
        with pytest.raises(RuntimeError, match="entry barrier"):
            windows.check()
        assert time.perf_counter() - t0 < 1.75
        with pytest.raises(RuntimeError, match="unusable"):
            rdma_ring.rdma_ring_one_card(xs, windows)
    with rdma_ring.OneCardWindows(cuda_device, 2, 128) as windows:
        assert torch.equal(rdma_ring.rdma_ring_one_card(xs, windows),
                           rdma_ring.rdma_ring_plain(xs))
        windows.check()
