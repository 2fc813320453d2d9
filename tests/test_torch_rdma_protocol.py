"""The one-kernel ring's chunk and credit protocol, held on the CPU.

``dlrover_tpu_torch/csrc/rdma_ring.cu`` passes every row in chunks through
a ring of slots per CTA in the right neighbour's window, under credits.  A
card runs only a few interleavings of its CTAs, so this file holds the
protocol here:

* the host's plan (``rdma_ring.chunk_plan``, ``rdma_ring.RingCounters``,
  which both kinds of windows are): every rank and CTA gets the same chunk
  steps and the same base across calls of mixed widths on one window, the
  chunks of a row are each owned once, and the packets the kernel's steps
  send are the packets the host counts;
* a Python model of the kernel's counters, slots and wait targets (the
  same formulas as ``rdma_ring_kernel``: the hops of a step, the entry
  barrier's ``2 * generation``, arrivals ``taken + n_in``, credits
  ``sent + n_out - S``, slot ``packet % S``, 32-bit wrap-safe compares),
  every rank and CTA an actor (a step: its waits, each hop's loads, each
  hop's stores, the two adds that raise the neighbours' counters), run
  under interleavings that hypothesis draws (a seed and a speed per actor;
  ranks may run calls ahead of their neighbours, as with a card per rank),
  for W = 2, 3, 4, 8, with the least slots the kernel takes and with the
  port's:
  it never deadlocks, never writes a slot whose packet was not drained,
  reads every packet it expects, adds each element's rows in hop order,
  and gives ``rdma_ring_plain``'s bits;
* with one slot fewer than the kernel asks for, the model deadlocks: the
  check has teeth.
"""

import random

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dlrover_tpu_torch.ops.cuda import rdma_ring

MASK = 0xFFFFFFFF
PLAN_WIDTHS = (128, 4096, 1_000_064, 16_384_000, 4096, 128, 1_000_064)
# a chunk, a ragged row of two, whole chunks, and 17 chunks (ragged): the
# wavefront's steady state, every hop live, needs more chunks per CTA than
# W - 2
MODEL_WIDTHS = (128, 2176, 8192, 16 * rdma_ring.CHUNK_ELEMS + 128)


def _reached(counter: int, target: int) -> bool:
    """The kernel's wrap-safe ``(int)(counter - target) >= 0``."""
    return ((counter - target) & MASK) < 2 ** 31


def _step_hops(s, n, world):
    """The kernel's hops of step ``s``: hop t of chunk s - t for t in
    [lo, hi]; hops up to W - 2 send, hops from 1 take."""
    lo = max(0, s - n + 1)
    hi = min(world - 1, s)
    in_lo = max(lo, 1)
    n_out = max(0, min(hi, world - 2) - lo + 1)
    n_in = max(0, hi - in_lo + 1)
    return lo, hi, in_lo, n_out, n_in


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            * 10.0 ** rng.uniform(-3, 3, shape)).astype(np.float32)


# -- the host's plan ---------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("ctas", [1, 33, 66, 264])
def test_every_rank_and_cta_gets_the_same_plan(world, ctas):
    ranks = [rdma_ring.RingCounters(world, ctas) for _ in range(world)]
    plans = [[r.next_call(w) for w in PLAN_WIDTHS] for r in ranks]
    assert all(p == plans[0] for p in plans)
    base = 0
    for g, (width, (gen, got_base, chunks)) in enumerate(
            zip(PLAN_WIDTHS, plans[0]), 1):
        assert gen == g and got_base == base
        total = -(-width // rdma_ring.CHUNK_ELEMS)
        # CTA c owns chunks c, c + ctas, ...: each chunk once, and every
        # CTA runs the same steps, the last of them maybe past the row
        owned = [j * ctas + c for c in range(ctas) for j in range(chunks)]
        assert len(set(owned)) == len(owned)
        assert set(range(total)) <= set(owned)
        assert chunks == -(-total // ctas) >= 1
        steps = [_step_hops(s, chunks, world)
                 for s in range(chunks + world - 1)]
        assert sum(h[3] for h in steps) == chunks * (world - 1)
        assert sum(h[4] for h in steps) == chunks * (world - 1)
        base += chunks * (world - 1)
    assert ranks[0].packets == base


def test_window_size_does_not_grow_with_the_width():
    """The slots a window holds depend on the world alone: the plan of any
    width runs through ``slots_for(world)`` slots of one chunk per CTA."""
    for world in (2, 3, 4, 8):
        counters = rdma_ring.RingCounters(world, 66)
        assert counters.slots == rdma_ring.slots_for(world)
        assert counters.slots >= 2 * (world - 1)
        for width in PLAN_WIDTHS:
            counters.next_call(width)
            assert counters.slots == rdma_ring.slots_for(world)


@pytest.mark.parametrize("world", [2, 3, 4, 8, 16])
@pytest.mark.parametrize("one_card", [True, False])
def test_the_slots_on_a_card_stay_inside_their_budget(world, one_card):
    """However many ranks, the slots of every rank on a card fit the
    budget that keeps them in L2, with the CTAs the card holds at two a
    multiprocessor of an H100 (132) as the most."""
    ranks = world if one_card else 1
    resident = 2 * 132 // ranks
    ctas = rdma_ring.ctas_for(resident, world, ranks)
    assert 1 <= ctas <= resident
    assert (ranks * ctas * rdma_ring.slots_for(world) * rdma_ring.CHUNK_ELEMS
            * 4 <= rdma_ring.SLOT_BYTES_PER_CARD)
    if one_card and world <= 4:
        assert ctas == resident  # the timed shape is not cut


# -- the model ---------------------------------------------------------------


class Deadlock(AssertionError):
    pass


class _Model:
    """W ranks of ``ctas`` CTAs on windows that ``RingCounters`` plans;
    ``calls`` is a list of (W, W, width) buffers run one after another."""

    def __init__(self, world, ctas, slots, calls, start_packets=0):
        self.world, self.ctas, self.slots = world, ctas, slots
        counters = rdma_ring.RingCounters(world, ctas)
        counters.packets = start_packets
        self.calls = [(xs, counters.next_call(xs.shape[-1])) for xs in calls]
        # flags[rank][cta]: barrier, arrived, credits, as if start_packets
        # had gone through every counter already
        start = start_packets & MASK
        self.flags = [[{"barrier": 0, "arrived": start, "credits": start}
                       for _ in range(ctas)] for _ in range(world)]
        self.slot = [[[None] * slots for _ in range(ctas)]
                     for _ in range(world)]
        self.out = [np.full(xs.shape[1:], np.nan, np.float32)
                    for xs, _ in self.calls]
        self.traces = [{} for _ in self.calls]

    def actor(self, r, c):
        W, S, C = self.world, self.slots, self.ctas
        left, right = (r - 1) % W, (r + 1) % W
        mine = self.flags[r][c]
        for i, (xs, (gen, base, n)) in enumerate(self.calls):
            width = xs.shape[-1]
            # entry barrier
            self.flags[left][c]["barrier"] += 1
            yield None
            self.flags[right][c]["barrier"] += 1
            yield lambda g=gen: mine["barrier"] >= 2 * g
            sent = taken = base & MASK
            out_slot = in_slot = base % S
            for s in range(n + W - 1):
                lo, hi, in_lo, n_out, n_in = _step_hops(s, n, W)
                if n_in:
                    yield lambda t=(taken + n_in) & MASK: _reached(
                        mine["arrived"], t)
                if n_out:
                    yield lambda t=(sent + n_out - S) & MASK: _reached(
                        mine["credits"], t)
                loaded = []
                for t in range(lo, hi + 1):  # the loads
                    k = (s - t) * C + c
                    cols = slice(min(width, k * rdma_ring.CHUNK_ELEMS),
                                 min(width, (k + 1) * rdma_ring.CHUNK_ELEMS))
                    row = (r - t - 1) % W
                    value, trace = xs[r, row, cols].copy(), [(r, row)]
                    if t > 0:
                        box = self.slot[r][c]
                        q = (in_slot + t - in_lo) % S
                        assert box[q] is not None, (
                            f"rank {r} CTA {c} step {s}: slot {q} read "
                            "before its packet arrived")
                        tag, data, before = box[q]
                        assert tag == (i, k, t - 1), (
                            f"rank {r} CTA {c} step {s}: slot {q} holds "
                            f"{tag}, expected {(i, k, t - 1)}")
                        box[q] = None  # drained
                        value, trace = data + value, before + trace
                    loaded.append((t, k, cols, value, trace))
                    yield None
                for t, k, cols, value, trace in loaded:  # the stores
                    if t < W - 1:
                        box = self.slot[right][c]
                        q = (out_slot + t - lo) % S
                        assert box[q] is None, (
                            f"rank {r} CTA {c} step {s}: overwrote slot {q} "
                            f"of rank {right} holding undrained {box[q][0]}")
                        box[q] = ((i, k, t), value, trace)
                    else:
                        self.out[i][r, cols] = value
                        if cols.stop > cols.start:
                            self.traces[i][(r, k)] = trace
                    yield None
                if n_out:
                    f = self.flags[right][c]
                    f["arrived"] = (f["arrived"] + n_out) & MASK
                    yield None
                if n_in:
                    f = self.flags[left][c]
                    f["credits"] = (f["credits"] + n_in) & MASK
                    yield None
                sent, taken = (sent + n_out) & MASK, (taken + n_in) & MASK
                out_slot = (out_slot + n_out) % S
                in_slot = (in_slot + n_in) % S

    def run(self, rng, speeds):
        live = [[self.actor(r, c), None]
                for r in range(self.world) for c in range(self.ctas)]
        weight = list(speeds)
        while live:
            ready = [j for j, (_, wait) in enumerate(live)
                     if wait is None or wait()]
            if not ready:
                raise Deadlock(f"{len(live)} actors wait and none can go on")
            j = rng.choices(ready, weights=[weight[j] for j in ready])[0]
            try:
                live[j][1] = next(live[j][0])
            except StopIteration:
                del live[j]
                del weight[j]


def _check(model):
    W = model.world
    for i, (xs, _) in enumerate(model.calls):
        want = rdma_ring.rdma_ring_plain(torch.from_numpy(xs)).numpy()
        assert np.array_equal(model.out[i], want), f"call {i} differs"
        # every element's rows in hop order: ranks r - W + 1, ..., r each
        # add their row r
        for (r, k), trace in model.traces[i].items():
            assert trace == [((r - W + 1 + h) % W, r) for h in range(W)], (
                f"call {i} rank {r} chunk {k}: adds {trace}")


@pytest.mark.parametrize("slot_steps", [2, rdma_ring.SLOT_STEPS])
@pytest.mark.parametrize("world", [2, 3, 4, 8])
@settings(max_examples=12, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_protocol_model_under_random_interleavings(world, slot_steps, data):
    ctas = data.draw(st.integers(1, 2), label="ctas")
    widths = data.draw(st.lists(st.sampled_from(MODEL_WIDTHS), min_size=2,
                                max_size=3), label="widths")
    # counters that wrap past 2**32 during the run, or start at zero
    start = data.draw(st.sampled_from([0, 2 ** 32 - 7]), label="start")
    speeds = data.draw(st.lists(st.sampled_from([1, 4, 32]),
                                min_size=world * ctas,
                                max_size=world * ctas), label="speeds")
    seed = data.draw(st.integers(0, 2 ** 32 - 1), label="seed")
    calls = [_rand((world, world, w), seed + k) for k, w in enumerate(widths)]
    model = _Model(world, ctas, slot_steps * (world - 1), calls, start)
    model.run(random.Random(seed), speeds)
    _check(model)


@pytest.mark.parametrize("world", [2, 3, 4, 8])
def test_protocol_model_at_the_ports_slots(world):
    """The slots the port allocates (``slots_for``), one CTA far slower
    than the others."""
    calls = [_rand((world, world, w), w) for w in MODEL_WIDTHS]
    model = _Model(world, 2, rdma_ring.slots_for(world), calls)
    model.run(random.Random(world), [1] + [32] * (2 * world - 1))
    _check(model)


@pytest.mark.parametrize("world", [2, 3, 4, 8])
def test_a_slot_fewer_deadlocks(world):
    # enough chunks for the steady state, where a step sends W - 1 packets
    chunks = world + 2
    calls = [_rand((world, world, chunks * rdma_ring.CHUNK_ELEMS), 3)]
    for seed in range(3):
        model = _Model(world, 1, 2 * (world - 1) - 1, calls)
        with pytest.raises(Deadlock):
            model.run(random.Random(seed), [1] * world)
