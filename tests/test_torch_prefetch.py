"""The port's DevicePrefetcher (trainer/elastic/prefetch.py) on the CPU.

The six cases of ``tests/test_prefetch.py`` on ``device="cpu"``: order
and staging, the depth bound, a worker exception re-raised at its
position, ``close()`` mid-epoch, prefetched batches training the tiny
Llama, and ``next`` after exhaustion.  Tiny-Llama losses through the
prefetcher must equal the direct feed's bitwise, and the JAX ``Trainer``'s
fed by the reference's ``DevicePrefetcher`` within the fp32 tolerance of
``tests/test_torch_train.py``.  A wait that leaves the device idle is
charged to the goodput ledger's ``input_blocked`` claim, which the
trainer's compute claim does not take; a CUDA prefetcher with no card
raises.  The streamed path (pinned host tensors, a side stream, an event)
runs in the ``cuda``-marked case."""

import time

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.observability import goodput
from dlrover_tpu_torch.trainer.elastic.prefetch import DevicePrefetcher

STEPS = 3
B, S = 8, 16
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=100)
# fp32 on both sides, summation order apart (tests/test_torch_train.py
# measured 2e-7 relative on the loss)
LOSS_RTOL = 1e-5


def _batches(n, rows=8):
    for i in range(n):
        yield {
            "input_ids": np.full((rows, 4), i, np.int32),
            "labels": np.full((rows, 4), i, np.int32),
        }


def test_order_and_staging_preserved():
    with DevicePrefetcher(_batches(5), depth=2, device="cpu") as pf:
        seen = list(pf)
    assert len(seen) == 5
    for i, batch in enumerate(seen):
        assert isinstance(batch["input_ids"], torch.Tensor)
        assert batch["input_ids"].device == torch.device("cpu")
        assert batch["input_ids"].dtype == torch.int32
        assert int(batch["input_ids"][0, 0]) == i


def test_depth_bounds_staging():
    """No more than depth batches are staged ahead of the consumer."""
    produced = []

    def tracked():
        for i in range(10):
            produced.append(i)
            yield {"x": np.full((4, 2), i, np.int32)}

    pf = DevicePrefetcher(tracked(), depth=2, device="cpu")
    try:
        time.sleep(0.8)  # the worker runs ahead only as far as the queue
        # queue depth 2 + one in flight = at most ~4 produced
        assert len(produced) <= 4
        assert int(next(pf)["x"][0, 0]) == 0
    finally:
        pf.close()


def test_worker_exception_reaches_consumer():
    def boom():
        yield {"x": np.zeros((4, 2), np.int32)}
        raise RuntimeError("host data pipeline broke")

    pf = DevicePrefetcher(boom(), depth=2, device="cpu")
    assert next(pf) is not None
    with pytest.raises(RuntimeError, match="pipeline broke"):
        next(pf)


def test_close_mid_epoch_releases_worker():
    """close() mid-stream (an elastic restart) must not deadlock against
    a full queue, nor pull another source item."""
    produced = []

    def tracked():
        for i in range(100):
            produced.append(i)
            yield {"x": np.full((4, 2), i, np.int32)}

    pf = DevicePrefetcher(tracked(), depth=2, device="cpu")
    next(pf)
    time.sleep(0.3)
    pulled = len(produced)
    pf.close()
    assert not pf._thread.is_alive()
    assert len(produced) == pulled
    with pytest.raises(StopIteration):
        next(pf)


def _tiny_batches(vocab, n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, size=(B, S + 1))
        out.append({"input_ids": np.asarray(ids[:, :-1], np.int32),
                    "labels": np.asarray(ids[:, 1:], np.int32)})
    return out


def _port_losses(init, batches, prefetch):
    from dlrover_tpu_torch.models.convert import flax_llama_to_state_dict
    from dlrover_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from dlrover_tpu_torch.trainer import optim
    from dlrover_tpu_torch.trainer.train import Trainer

    cfg = LlamaConfig.tiny(dtype=torch.float32)
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(flax_llama_to_state_dict(init, cfg))
    trainer = Trainer(model, optim.create_optimizer(**OPT), device="cpu")
    state = trainer.create_state()
    feed = (DevicePrefetcher(iter(batches), depth=2, device="cpu")
            if prefetch else batches)
    losses = []
    for batch in feed:
        state, metrics = trainer.train_step(state, batch)
        losses.append(metrics["loss"].item())
    assert state.step == len(batches)
    return losses


def _jax_losses(batches):
    """The JAX Trainer fed by the reference's DevicePrefetcher on a
    one-device mesh; returns (initial params, losses)."""
    jax = pytest.importorskip("jax")
    import flax.linen as nn
    import jax.numpy as jnp

    from dlrover_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from dlrover_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu.trainer import optim as joptim
    from dlrover_tpu.trainer.elastic.prefetch import (
        DevicePrefetcher as JaxPrefetcher,
    )
    from dlrover_tpu.trainer.train import Trainer as JaxTrainer

    mesh = build_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    trainer = JaxTrainer(JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32)),
                         joptim.create_optimizer(**OPT), mesh)
    state, init, losses = None, None, []
    with JaxPrefetcher(iter(batches), mesh, depth=2) as pf:
        for batch in pf:
            if state is None:
                state = trainer.create_state(jax.random.PRNGKey(0),
                                             batch["input_ids"])
                init = jax.tree.map(np.asarray,
                                    nn.meta.unbox(state.params))
            state, metrics = trainer.train_step(state, batch)
            losses.append(float(metrics["loss"]))
    return init, losses


def test_prefetched_batches_train_like_the_direct_feed_and_the_jax_trainer():
    from dlrover_tpu_torch.models.llama import LlamaConfig

    batches = _tiny_batches(LlamaConfig.tiny().vocab_size)
    init, jax_losses = _jax_losses(batches)
    prefetched = _port_losses(init, batches, prefetch=True)
    direct = _port_losses(init, batches, prefetch=False)
    assert prefetched == direct
    assert all(np.isfinite(prefetched))
    np.testing.assert_allclose(prefetched, jax_losses, rtol=LOSS_RTOL)


def test_next_after_exhaustion_raises_not_hangs():
    """Iterator protocol: resuming iteration after normal exhaustion must
    raise StopIteration immediately, never block."""
    pf = DevicePrefetcher(_batches(2), depth=2, device="cpu")
    assert len(list(pf)) == 2
    for _ in range(3):
        with pytest.raises(StopIteration):
            next(pf)
    pf.close()


def test_idle_wait_is_charged_above_the_step_claim(monkeypatch):
    """A consumer that waits on an empty queue is starved: the wait past
    the floor books ``input_starved`` even where the trainer's
    inter-dispatch compute claim covers the same slots; a wait under the
    floor books nothing."""
    monkeypatch.setenv("DLROVER_TPU_GOODPUT_RES_S", "0.05")
    ledger = goodput.reset_ledger()
    try:
        def slow():
            yield {"x": np.zeros((2, 2), np.int32)}
            time.sleep(0.4)
            yield {"x": np.ones((2, 2), np.int32)}

        t0 = time.time()
        with DevicePrefetcher(slow(), depth=2, device="cpu") as pf:
            batches = list(pf)
        assert len(batches) == 2
        assert pf.idle_wait_s >= 0.35
        # the trainer's step claim over the whole window
        goodput.on_step(1, time.time() - t0)
        phases = ledger.summary()["phases"]
        assert phases["input_starved"] >= 0.35
        assert phases["compute"] < time.time() - t0 - 0.3

        ledger = goodput.reset_ledger()
        monkeypatch.setenv("DLROVER_TPU_DATA_STARVED_MIN_S", "10")
        with DevicePrefetcher(slow(), depth=2, device="cpu") as pf:
            list(pf)
        assert pf.idle_wait_s >= 0.35
        assert ledger.summary()["phases"]["input_starved"] == 0
    finally:
        goodput.reset_ledger()


def test_no_card_raises_without_a_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePrefetcher(_batches(1))


@pytest.mark.cuda
def test_streamed_staging_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the side stream and pinned "
                    "copies exist only on the card")
    device = torch.device("cuda", torch.cuda.current_device())
    batches = [{"x": np.full((256, 1024), i, np.int32)} for i in range(6)]
    with DevicePrefetcher(iter(batches), depth=2, device="cuda") as pf:
        assert pf.device == device
        seen = []
        for batch in pf:
            x = batch["x"]
            assert x.device == device and x.dtype == torch.int32
            # the main stream reads the staged block after the event
            seen.append(int((x * 2).sum().item()))
            del batch, x
    assert seen == [2 * i * 256 * 1024 for i in range(6)]
