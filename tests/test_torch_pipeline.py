"""The port's pipeline over pp (dlrover_tpu_torch/parallel/pipeline.py,
models/pipeline_llama.py) against the JAX package's on the CPU.

* ``pipeline_apply`` on the tanh chain of tests/test_pipeline.py's
  ``test_generic_pipeline_matches_sequential`` (12 layers of 8 x 8 in 4
  stages, dp=2 x pp=4, 4 microbatches): the output against JAX's
  pipelined output, and the gradients of sum(y * dy) w.r.t. the weights
  and the input against ``jax.grad`` of the pipelined function, each
  within 1e-6 (the test's own tolerance); 8 gloo ranks.
* ``PipelinedLlama`` on dp=2 x pp=2 (4 gloo ranks), the tiny Llama in
  fp32 with 4 layers and no remat from the JAX model's init, B=8, S=16,
  run as tests/test_pipeline.py runs the JAX one: the logits with 2
  microbatches within 2e-4 absolute and 2e-5 relative of JAX's pipelined
  logits (``test_forward_matches_single_stage``'s tolerance), the
  gradients with 4 within 5e-5 absolute and 1e-4 relative
  (``test_grad_parity_vs_single_stage``'s), and 5 steps of adamw at 1e-2
  with 2: each loss within 1e-5 relative (that test's loss tolerance) and
  falling (``test_train_step_loss_decreases_dp_pp``).
* ``stage_params``' refusal, ``microbatch_efficiency``, and a mesh
  ``PipelinedLlama`` refuses.

The JAX side takes the 8 virtual CPU devices of tests/conftest.py while
the port's spawns (one per world size) run in the background; every
exchange of a rank has the spawn's timeout, so a hang fails the test.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.models.llama import LlamaConfig as JaxLlamaConfig  # noqa: E402
from dlrover_tpu.models.pipeline_llama import (  # noqa: E402
    PipelinedLlama as JaxPipelinedLlama,
)
from dlrover_tpu.parallel.mesh import MeshConfig as JaxMeshConfig  # noqa: E402
from dlrover_tpu.parallel.mesh import build_mesh as jax_build_mesh  # noqa: E402
from dlrover_tpu.parallel.pipeline import (  # noqa: E402
    pipeline_apply as jax_pipeline_apply,
)
from dlrover_tpu.parallel.pipeline import (  # noqa: E402
    stage_params as jax_stage_params,
)
from dlrover_tpu.trainer.train import (  # noqa: E402
    cross_entropy_loss as jax_cross_entropy,
)
from dlrover_tpu_torch.models.convert import flax_llama_to_state_dict  # noqa: E402
from dlrover_tpu_torch.models.llama import LlamaConfig  # noqa: E402
from dlrover_tpu_torch.parallel import mesh_workers, process_group  # noqa: E402
from dlrover_tpu_torch.parallel.pipeline import (  # noqa: E402
    microbatch_efficiency,
    stage_params,
)
from torch_pipeline_checks import chain_worker  # noqa: E402

SPAWN_TIMEOUT_S = 240.0
B, S, STEPS, LR = 8, 16, 5, 1e-2
MODEL = dict(num_layers=4, dtype=torch.float32, remat=False)


def _jax_cfg():
    return JaxLlamaConfig.tiny(num_layers=4, dtype=jnp.float32,
                               param_dtype=jnp.float32, remat=False,
                               scan_layers=True)


def _batch():
    ids = np.random.default_rng(0).integers(0, 256, size=(B, S + 1))
    return {"input_ids": ids[:, :-1].astype(np.int32),
            "labels": ids[:, 1:].astype(np.int32)}


def _chain():
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (12, 8, 8))
                   ) * np.float32(0.3)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, 8)))
    dy = np.random.default_rng(2).normal(size=(8, 8)).astype(np.float32)
    return w.astype(np.float32), x, dy


def _jax_chain(w, x, dy):
    mesh = jax_build_mesh(JaxMeshConfig(dp=2, pp=4),
                          devices=jax.devices()[:8])

    def stage(sp, h):
        def body(h, wi):
            return jnp.tanh(h @ wi), None

        h, _ = jax.lax.scan(body, h, sp)
        return h

    piped = jax_pipeline_apply(stage, mesh, num_microbatches=4)

    def f(w, x):
        return piped(jax_stage_params(w, 4), x)

    with mesh:
        y = jax.jit(f)(w, x)
        dw, dx = jax.jit(jax.grad(lambda w, x: jnp.sum(f(w, x) * dy),
                                  argnums=(0, 1)))(w, x)
    return np.asarray(y), np.asarray(dw), np.asarray(dx)


def _jax_llama(variables):
    cfg = _jax_cfg()
    mesh = jax_build_mesh(JaxMeshConfig(dp=2, pp=2),
                          devices=jax.devices()[:4])
    batch = _batch()
    ids, labels = batch["input_ids"], batch["labels"]
    out = {}
    m2 = JaxPipelinedLlama(cfg, mesh, num_microbatches=2)
    m4 = JaxPipelinedLlama(cfg, mesh, num_microbatches=4)
    with mesh:
        out["logits"] = np.asarray(jax.jit(m2.apply)(variables, ids))
        out["grads"] = jax.jit(jax.grad(lambda v: jax_cross_entropy(
            m4.apply(v, ids), labels, None)))(variables)["params"]
        opt = optax.adamw(LR)

        @jax.jit
        def step(v, s):
            def loss_fn(v):
                return jax_cross_entropy(m2.apply(v, ids), labels, None)

            loss, grads = jax.value_and_grad(loss_fn)(v)
            updates, s = opt.update(grads["params"], s, v["params"])
            return ({"params": optax.apply_updates(v["params"], updates)},
                    s, loss)

        v, s, losses = variables, opt.init(variables["params"]), []
        for _ in range(STEPS):
            v, s, loss = step(v, s)
            losses.append(float(loss))
    out["loss"] = np.array(losses)
    return out


@pytest.fixture(scope="module")
def runs():
    """The port's ranks (8 for the chain, 4 for the Llama) in the
    background while JAX runs the same here."""
    w, x, dy = _chain()
    cfg = _jax_cfg()
    variables = jax.jit(lambda rng: JaxPipelinedLlama(
        cfg, jax_build_mesh(JaxMeshConfig(dp=2, pp=2),
                            devices=jax.devices()[:4])).init(
        rng, _batch()["input_ids"]))(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, nn.meta.unbox(variables["params"]))
    state = {k: v.numpy() for k, v in flax_llama_to_state_dict(
        params, LlamaConfig.tiny(**MODEL)).items()}
    llama = dict(preset="tiny", model=MODEL, state_dict=state, runs=[
        dict(name="m2", axes=dict(dp=2, pp=2), num_microbatches=2,
             steps=STEPS, batch=_batch(), adamw_lr=LR, return_logits=True),
        dict(name="m4", axes=dict(dp=2, pp=2), num_microbatches=4, steps=1,
             batch=_batch(), adamw_lr=LR, return_grads=True)])
    with ThreadPoolExecutor(2) as pool:
        chain = pool.submit(
            process_group.spawn, chain_worker, 8,
            (dict(axes=dict(dp=2, pp=4), num_microbatches=4, w=w, x=x,
                  dy=dy),), device="cpu", timeout_s=SPAWN_TIMEOUT_S)
        piped = pool.submit(
            process_group.spawn, mesh_workers.pipeline_worker, 4, (llama,),
            device="cpu", timeout_s=SPAWN_TIMEOUT_S)
        jax_runs = {"chain": _jax_chain(w, x, dy),
                    "llama": _jax_llama({"params": params})}
        port = {"chain": chain.result(), "llama": piped.result()}
    return dict(jax=jax_runs, port=port, params=params)


def test_generic_pipeline_matches_jax(runs):
    y, dw, dx = runs["jax"]["chain"]
    got_dw = np.zeros_like(dw)
    got_dx = np.zeros_like(dx)
    for rec in runs["port"]["chain"]:
        lo, hi = rec["rows"]
        # every pp rank holds its dp rows' output
        np.testing.assert_allclose(rec["y"], y[lo:hi], atol=1e-6)
        got_dw += rec["dw"]  # each rank's stage, its rows
        got_dx[lo:hi] += rec["dx"]  # stage 0 only
        if rec["pp"] > 0:
            assert not rec["dx"].any()
    np.testing.assert_allclose(got_dw, dw, atol=1e-6)
    np.testing.assert_allclose(got_dx, dx, atol=1e-6)


def test_pipelined_llama_logits_match_jax(runs):
    want = runs["jax"]["llama"]["logits"]
    for rank in runs["port"]["llama"]:
        rec = rank["runs"]["m2"]
        rows = slice(rec["dp_rank"] * B // 2, (rec["dp_rank"] + 1) * B // 2)
        np.testing.assert_allclose(rec["logits"], want[rows], atol=2e-4,
                                   rtol=2e-5)


def test_pipelined_llama_grads_match_jax(runs):
    want = {k: v.numpy() for k, v in flax_llama_to_state_dict(
        jax.tree.map(np.asarray, nn.meta.unbox(runs["jax"]["llama"]["grads"])),
        LlamaConfig.tiny(**MODEL)).items()}
    for rank in runs["port"]["llama"]:
        got = rank["runs"]["m4"]["grads"]  # whole on every rank
        assert set(got) == set(want)
        for n in got:
            np.testing.assert_allclose(got[n], want[n], atol=5e-5, rtol=1e-4,
                                       err_msg=n)


def test_pipelined_llama_trains_as_jax(runs):
    want = runs["jax"]["llama"]["loss"]
    for rank in runs["port"]["llama"]:
        got = rank["runs"]["m2"]["loss"]
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert got[-1] < got[0]


def test_pipelined_llama_refusals(runs):
    for rec in runs["port"]["chain"]:
        got = rec["refusals"]
        assert "4 pipeline stages" in got["3 layers over pp=4"]
        assert "composes with dp only" in got["tp=2 x pp=4"]


def test_stage_params_validates_divisibility():
    with pytest.raises(ValueError, match="not divisible"):
        stage_params(torch.zeros(5, 2), 2)
    with pytest.raises(ValueError, match="not divisible"):
        stage_params([object()] * 3, 2)
    staged = stage_params(torch.arange(12.0).reshape(6, 2), 3)
    assert staged.shape == (3, 2, 2)
    assert stage_params(list(range(4)), 2) == [[0, 1], [2, 3]]


def test_microbatch_efficiency():
    assert microbatch_efficiency(1, 1) == 1.0
    assert microbatch_efficiency(4, 4) == pytest.approx(4 / 7)
    assert microbatch_efficiency(32, 4) > 0.9
