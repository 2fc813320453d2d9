"""The port's optimizer recipe (dlrover_tpu_torch/trainer/optim.py) against
dlrover_tpu/trainer/optim.py's optax chain: params and Adam moments after
5 steps, the lr=0 first step included."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.trainer import optim as joptim  # noqa: E402
from dlrover_tpu_torch.trainer import optim as toptim  # noqa: E402

SHAPES = {"a": (8, 16), "b": (16,), "c": (4, 4, 3)}
STEPS = 5


def _grads(step, scale):
    rng = np.random.default_rng(100 + step)
    return {n: (scale * rng.standard_normal(s)).astype(np.float32)
            for n, s in SHAPES.items()}


def _find_moments(state):
    """(mu, nu) of the Adam transform inside an optax or port chain state."""
    for leaf in state:
        if hasattr(leaf, "mu") and hasattr(leaf, "nu"):
            return leaf.mu, leaf.nu
        if isinstance(leaf, tuple):
            found = _find_moments(leaf)
            if found:
                return found
    return None


def _run(moment_dtype, grads_dtype, grad_scale):
    rng = np.random.default_rng(0)
    params0 = {n: rng.standard_normal(s).astype(np.float32)
               for n, s in SHAPES.items()}
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)
    jopt = joptim.create_optimizer(
        moment_dtype=None if moment_dtype is None else jnp.bfloat16, **kw)
    topt = toptim.create_optimizer(
        moment_dtype=None if moment_dtype is None else torch.bfloat16, **kw)
    jdt = jnp.float32 if grads_dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if grads_dtype == "float32" else torch.bfloat16

    # jitted, as the JAX Trainer runs it: XLA fuses the bf16 moment math
    # into fp32 expressions, which eager optax would round op by op
    jupdate = jax.jit(jopt.update)
    jp = {n: jnp.asarray(p) for n, p in params0.items()}
    tp = {n: torch.from_numpy(p.copy()) for n, p in params0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    history = []
    for step in range(STEPS):
        g = _grads(step, grad_scale)
        jg = {n: jnp.asarray(x, jdt) for n, x in g.items()}
        tg = {n: torch.from_numpy(x).to(tdt) for n, x in g.items()}
        ju, js = jupdate(jg, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update(tg, ts, tp)
        toptim.apply_updates(tp, tu)
        history.append(({n: np.asarray(x) for n, x in jp.items()},
                        {n: x.numpy().copy() for n, x in tp.items()}))
    return params0, history, _find_moments(js), _find_moments(ts)


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("grads_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0])  # clip off / clip on
def test_five_steps_match_optax(moment_dtype, grads_dtype, grad_scale):
    params0, history, (jmu, jnu), (tmu, tnu) = _run(
        moment_dtype, grads_dtype, grad_scale)
    # step 0 runs at lr = 0 (warmup from init_value 0): params unchanged
    for n, p in params0.items():
        np.testing.assert_array_equal(history[0][0][n], p)
        np.testing.assert_array_equal(history[0][1][n], p)
    # fp32 math on both sides: 1e-6 absolute on O(1) params (each update
    # is <= lr = 1e-2).  bf16 grads into bf16 moments: XLA may contract
    # b1*m + (1-b1)*g into an FMA, which flips the last bit of a stored
    # bf16 moment now and then (measured: 2.6e-5 on the params after 5
    # steps, no such flip on fp32 moments)
    tol = 1e-6
    if grads_dtype != "float32" and moment_dtype is not None:
        tol = 5e-5
    for jp, tp in history:
        for n in params0:
            np.testing.assert_allclose(tp[n], jp[n], rtol=0, atol=tol)
    mtol = dict(rtol=1e-5, atol=1e-7)
    if moment_dtype is not None:
        # bf16 storage: one bf16 ulp of the largest moment (2**-8), as a
        # relative bound on every element
        mtol = dict(rtol=2 ** -7, atol=1e-6)
    for n in params0:
        assert str(tmu[n].dtype).split(".")[-1] == str(jmu[n].dtype)
        assert str(tnu[n].dtype).split(".")[-1] == str(jnu[n].dtype)
        np.testing.assert_allclose(tmu[n].float().numpy(),
                                   np.asarray(jmu[n], np.float32), **mtol)
        np.testing.assert_allclose(tnu[n].float().numpy(),
                                   np.asarray(jnu[n], np.float32), **mtol)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 500, 10_000, 20_000])
def test_schedule_matches_optax(step):
    j = joptim.cosine_schedule(3e-4, 10, 10_000)
    t = toptim.cosine_schedule(3e-4, 10, 10_000)
    np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6, atol=0)
    assert t(0) == 0.0


def test_global_norm_is_fp32():
    g = {"a": torch.full((1000,), 0.1, dtype=torch.bfloat16)}
    norm = toptim.global_norm(g)
    assert norm.dtype == torch.float32
    np.testing.assert_allclose(norm.item(), np.sqrt(1000) * 0.10009765625,
                               rtol=1e-6)
