"""The port's MoE Llama (dlrover_tpu_torch/models/moe.py) against the JAX
package's (dlrover_tpu/models/moe.py), on one process.

Weights come from the JAX module's init, converted by
``flax_moe_to_state_dict``; inputs are seeded numpy.  Checks:
``expert_capacity`` over a grid; ``MoEMLP`` in fp32 through the dispatch
and the dense oracle against JAX, with the routing (the top-k expert
indices) equal; dispatch against dense at capacity_factor = E / top_k
(nothing drops) within 2e-5, as tests/test_moe.py:53 holds JAX's; the
zero rows of dropped tokens; the aux loss and ``moe_loss_fn``; a top-k
with ties, which ``lax.top_k`` breaks towards the lower index; the tiny
model's logits in bf16; the converter's names and layout; the MoE
leaves' logical axes against the reference's; and ``MoEMLP`` over cp = 2
and 4 gloo ranks against JAX's on the whole sequence, at a capacity that
drops half the choices (``keep`` and every slot exactly).

Tolerances: fp32 outputs within 1e-5 absolute (the same products summed
in another order), the aux loss and the losses within 1e-6 relative; the
bf16 model's logits within 5e-2 absolute on O(1) logits (bf16 rounds the
activations at other points: the einsums' outputs, SwiGLU), as
tests/test_torch_llama.py bounds the dense model's bf16 drift.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.models import moe as jmoe  # noqa: E402
from dlrover_tpu.parallel.sharding import (  # noqa: E402
    spec_for_logical_axes as jax_spec,
)
from dlrover_tpu_torch.models import moe  # noqa: E402
from dlrover_tpu_torch.models.convert import (  # noqa: E402
    flax_moe_to_state_dict,
)
from dlrover_tpu_torch.parallel import sharding  # noqa: E402

D_TINY = 64


def _jax_cfg(**kw):
    return jmoe.MoELlamaConfig.tiny_moe(**kw)


def _cfg(**kw):
    return moe.MoELlamaConfig.tiny_moe(**kw)


def _x(B=2, S=16, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, S, D_TINY)).astype(np.float32)


def _mlp_pair(**kw):
    """The JAX MoEMLP's init (fp32) and the port's MoEMLP loaded with it."""
    fp32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)
    jcfg = _jax_cfg(**fp32, **kw)
    x = _x()
    params = nn.meta.unbox(jax.jit(jmoe.MoEMLP(jcfg).init)(
        jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    params = jax.tree.map(np.asarray, params)
    mlp = moe.MoEMLP(_cfg(dtype=torch.float32, **kw), device="cpu")
    mlp.load_state_dict({
        "router.weight": torch.from_numpy(
            params["router"]["kernel"].T.copy()),
        **{n: torch.from_numpy(np.array(params[n]))
           for n in ("gate_proj", "up_proj", "down_proj")}})
    return jcfg, params, mlp


def _jax_routing(params, x, top_k):
    logits = jnp.asarray(x) @ jnp.asarray(params["router"]["kernel"])
    probs = jax.nn.softmax(logits, axis=-1)
    return np.array(probs), np.asarray(jax.lax.top_k(probs, top_k)[1])


@pytest.mark.parametrize("seq_len", [1, 7, 16, 64, 2048])
@pytest.mark.parametrize("experts,top_k", [(4, 1), (4, 2), (8, 2), (16, 4)])
@pytest.mark.parametrize("factor", [0.25, 1.0, 1.25, 2.0])
def test_expert_capacity_matches_the_reference(seq_len, experts, top_k,
                                               factor):
    assert moe.expert_capacity(seq_len, experts, top_k, factor) == \
        jmoe.expert_capacity(seq_len, experts, top_k, factor)


@pytest.mark.parametrize("router_impl", ["dispatch", "dense"])
def test_moe_mlp_matches_jax_in_fp32(router_impl):
    jcfg, params, mlp = _mlp_pair(router_impl=router_impl)
    x = _x()
    want = np.asarray(jax.jit(jmoe.MoEMLP(jcfg).apply)(
        {"params": params}, jnp.asarray(x)))
    got = mlp(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the routing: the same experts for every token, in the same order
    probs, top_idx = _jax_routing(params, x, jcfg.top_k)
    _, idx = moe.top_k_lower_index(torch.from_numpy(probs), jcfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), top_idx)


def test_dispatch_matches_dense_when_nothing_drops():
    """capacity_factor = E / top_k = 2: every token is served, so the
    capacity dispatch equals the dense mixture (tests/test_moe.py:53)."""
    _, _, disp = _mlp_pair(router_impl="dispatch", capacity_factor=2.0)
    dense = moe.MoEMLP(_cfg(dtype=torch.float32, router_impl="dense"),
                       device="cpu")
    dense.load_state_dict(disp.state_dict())
    x = torch.from_numpy(_x(seed=3))
    np.testing.assert_allclose(disp(x).detach().numpy(),
                               dense(x).detach().numpy(), atol=2e-5)


def test_dropped_tokens_ride_the_residual():
    """A capacity below the tokens: the output is finite, a dropped
    token's MoE output is exactly zero, and the zero rows are those of
    JAX's module on the same weights (tests/test_moe.py:114)."""
    kw = dict(num_experts=4, top_k=1, capacity_factor=0.25)
    jcfg, params, mlp = _mlp_pair(**kw)
    S = 64
    C = moe.expert_capacity(S, 4, 1, 0.25)
    assert 4 * C < S  # drops are guaranteed
    x = _x(S=S, seed=4)
    got = mlp(torch.from_numpy(x)).detach().numpy()
    want = np.asarray(jax.jit(jmoe.MoEMLP(jcfg).apply)(
        {"params": params}, jnp.asarray(x)))
    assert np.isfinite(got).all()
    zero = np.all(got == 0.0, axis=-1)
    assert zero.sum() >= got.shape[0] * (S - 4 * C)
    np.testing.assert_array_equal(zero, np.all(want == 0.0, axis=-1))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_aux_loss_matches_the_sown_one():
    jcfg, params, mlp = _mlp_pair()
    x = _x(seed=5)
    _, state = jmoe.MoEMLP(jcfg).apply({"params": params}, jnp.asarray(x),
                                       mutable=["intermediates"])
    (want,) = state["intermediates"]["aux_loss"]
    mlp(torch.from_numpy(x))
    np.testing.assert_allclose(mlp.aux_loss.item(), float(want), rtol=1e-6)
    assert mlp.aux_loss.item() >= 1.0 - 1e-6  # 1 at uniform routing


def test_top_k_breaks_ties_towards_the_lower_index():
    """Rows with exact ties (uniform rows, repeated maxima, ties below the
    top): the same indices as ``lax.top_k``, and the MoE layer routes a
    zero input (all logits equal) to experts 0 and 1."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4],
                      [0.4, 0.2, 0.2, 0.2],
                      [0.2, 0.2, 0.3, 0.3],
                      [0.0, 0.5, 0.5, 0.0]], np.float32)
    for k in (1, 2, 3):
        vals, idx = moe.top_k_lower_index(torch.from_numpy(probs), k)
        want_vals, want_idx = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))
    _, params, mlp = _mlp_pair()
    x = np.zeros((1, 4, D_TINY), np.float32)
    probs, top_idx = _jax_routing(params, x, 2)
    _, idx = moe.top_k_lower_index(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(top_idx, [[[0, 1]] * 4])
    np.testing.assert_array_equal(idx.numpy(), top_idx)


CP_SIZES = (2, 4)
# B=2, S=64, E=4, top-2, capacity_factor 0.5: C = 16 slots an expert for
# 64 choices an expert on average, so most second choices drop, and which
# ones the cross-rank offsets decide
CP_CONFIG = dict(capacity_factor=0.5)


def _jax_slots(params, x, cfg):
    """The reference's ``keep`` and slots on the whole sequence: its
    dispatch's priority lines (dlrover_tpu/models/moe.py ``_dispatch``) on
    JAX's routing."""
    B, S, _ = x.shape
    E, k = cfg.num_experts, cfg.top_k
    C = jmoe.expert_capacity(S, E, k, cfg.capacity_factor)
    _, top_idx = _jax_routing(params, x, k)
    mask = jax.nn.one_hot(top_idx, E, dtype=jnp.float32)
    mask_prio = mask.transpose(0, 2, 1, 3).reshape(B, k * S, E)
    pos = jnp.cumsum(mask_prio, axis=1) * mask_prio - 1.0
    pos = pos.reshape(B, k, S, E).transpose(0, 2, 1, 3)
    keep = mask * (pos >= 0.0) * (pos < C)
    return np.asarray(keep), np.asarray(pos)


@pytest.fixture(scope="module")
def moe_cp():
    """``MoEMLP`` on cp = 2 and 4 gloo ranks (one spawn of 4, in the
    background) and JAX's ``MoEMLP`` on the whole sequence, from the same
    weights, input and output cotangent."""
    from concurrent.futures import ThreadPoolExecutor

    from dlrover_tpu_torch.parallel import process_group
    from torch_cp_ep_checks import moe_cp_worker

    jcfg, params, mlp = _mlp_pair(**CP_CONFIG)
    x, dout = _x(S=64, seed=7), _x(S=64, seed=8)
    spec = dict(config=CP_CONFIG, cps=CP_SIZES, x=x, dout=dout,
                state_dict={k: v.numpy() for k, v in
                            mlp.state_dict().items()})
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(process_group.spawn, moe_cp_worker, 4, (spec,),
                            device="cpu", timeout_s=120.0)
        module = jmoe.MoEMLP(jcfg)

        def loss(p, x_):
            out, state = module.apply({"params": p}, x_,
                                      mutable=["intermediates"])
            return jnp.sum(out * dout), (out, state)

        (_, (out, state)), (g_params, g_x) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
        keep, pos = _jax_slots(params, x, jcfg)
        want = dict(keep=keep, pos=pos, out=np.asarray(out),
                    dx=np.asarray(g_x),
                    aux=float(state["intermediates"]["aux_loss"][0]),
                    grads={"router.weight": np.asarray(
                        g_params["router"]["kernel"]).T, **{
                        n: np.asarray(g_params[n]) for n in (
                            "gate_proj", "up_proj", "down_proj")}})
        ranks = ranks.result()
    return ranks, want


@pytest.mark.parametrize("cp", CP_SIZES)
def test_moe_mlp_over_cp_matches_jax_on_the_whole_sequence(moe_cp, cp):
    """Each rank's ``keep`` and the slot of each of its tokens' choices
    equal the reference's on the whole sequence, exactly, at a capacity
    that drops tokens: the capacity from the global S and the k-major
    priority scan across ranks (the earlier choices of every rank, later
    ranks' too, come before a rank's next choice).  The outputs, the aux
    loss and the gradients w.r.t. x match JAX's; the weights' gradients
    summed over the cp ranks (the trainer's sum over cp) match JAX's
    whole ones.  fp32: summation order only, outputs and gradients within
    1e-5 (measured <= 1.2e-6 on gradients up to 3.3), the aux loss within
    1e-6 relative (measured 1.2e-7).  Offsets that count only the earlier
    ranks' earlier choices fail both cases."""
    ranks, want = moe_cp
    index = CP_SIZES.index(cp)
    blocks = sorted((r[index] for r in ranks[:cp]),
                    key=lambda b: b["chunk"])

    def whole(key):
        return np.concatenate([b[key] for b in blocks], axis=1)

    choices = want["keep"].size // want["keep"].shape[-1]
    assert want["keep"].sum() <= choices / 2  # half the choices drop
    np.testing.assert_array_equal(whole("keep"), want["keep"])
    np.testing.assert_array_equal(whole("pos"), want["pos"])
    np.testing.assert_allclose(whole("out"), want["out"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(whole("dx"), want["dx"], rtol=1e-5,
                               atol=1e-5)
    for b in blocks:
        np.testing.assert_allclose(b["aux"], want["aux"], rtol=1e-6)
    for n, g in want["grads"].items():
        got = sum(b["grads"][n] for b in blocks)
        np.testing.assert_allclose(got, g, rtol=1e-5, atol=1e-5,
                                   err_msg=n)


def _model_pair(dtype, **kw):
    jcfg = _jax_cfg(dtype=dtype, **kw)
    ids = np.random.default_rng(6).integers(0, 256, size=(2, 17))
    model = jmoe.MoELlamaForCausalLM(jcfg)
    params = jax.tree.map(np.asarray, nn.meta.unbox(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(ids[:, :-1]))["params"]))
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    cfg = _cfg(dtype=tdtype, **kw)
    port = moe.MoELlamaForCausalLM(cfg, device="cpu")
    port.load_state_dict(flax_moe_to_state_dict(params, cfg))
    batch = {"input_ids": ids[:, :-1].astype(np.int32),
             "labels": ids[:, 1:].astype(np.int32)}
    return model, params, port, batch


def test_moe_loss_fn_matches_jax():
    model, params, port, batch = _model_pair(jnp.float32)
    for weight in (0.0, 0.01, 1.0):
        want = float(jax.jit(jmoe.moe_loss_fn(model, aux_weight=weight))(
            params, batch))
        got = moe.moe_loss_fn(port, aux_weight=weight)(
            {k: torch.from_numpy(v) for k, v in batch.items()}).item()
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert len(port.moe_layers()) == 2


def test_tiny_model_logits_in_bf16():
    """Against JAX's model applied op by op, which rounds to bf16 after
    each op as the port does.  Under ``jit`` XLA fuses bf16 ops without
    the rounding between them: on this input JAX's jitted and op-by-op
    logits differ by 0.12 on one token (a routing choice is discrete),
    where the port is within 1.8e-2 of the op-by-op ones."""
    model, params, port, batch = _model_pair(jnp.bfloat16)
    want = np.asarray(model.apply({"params": params},
                                  jnp.asarray(batch["input_ids"])))
    with torch.no_grad():
        got = port(torch.from_numpy(batch["input_ids"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2)


def test_converter_covers_every_parameter_in_the_ports_layout():
    _, params, port, _ = _model_pair(jnp.float32)
    state = flax_moe_to_state_dict(params, port.config)
    assert set(state) == {n for n, _ in port.named_parameters()}
    for name, t in port.state_dict().items():
        assert t.shape == state[name].shape and torch.equal(t, state[name])
    layer = params["layers_1"]["moe_mlp"]
    np.testing.assert_array_equal(
        state["layers.1.moe_mlp.router.weight"].numpy(),
        layer["router"]["kernel"].T)
    np.testing.assert_array_equal(
        state["layers.1.moe_mlp.down_proj"].numpy(), layer["down_proj"])
    assert port.num_params() == sum(t.numel() for t in state.values())


def test_every_moe_leaf_maps_to_the_reference_mesh_axes():
    """Each parameter's logical axes (sharding.param_logical_axes) give the
    mesh axes the reference's annotations give; the model splits over tp
    and ep along the dims the rules put them on."""
    cfg = _jax_cfg()
    boxed = jax.eval_shape(jmoe.MoELlamaForCausalLM(cfg).init,
                           jax.random.PRNGKey(0),
                           jnp.zeros((1, 8), jnp.int32))["params"]
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            boxed, is_leaf=lambda x: isinstance(x, nn.Partitioned))[0]:
        keys = [str(getattr(k, "key", k)) for k in path]
        keys = [k for k in keys if not k.startswith("layers_")]
        if keys[-1] in ("kernel",):
            keys = keys[:-1]
        spec = jax_spec(leaf.names)
        want[".".join(keys)] = {a for e in spec for a in (
            e if isinstance(e, tuple) else (e,)) if a}
    port = moe.MoELlamaForCausalLM(_cfg(), device="cpu")
    names = [n for n, _ in port.named_parameters()]
    logical = sharding.param_logical_axes(names)
    for n in names:
        key = ".".join(p for p in n.split(".")[2 if n.startswith(
            "layers.") else 0:] if p != "weight")
        spec = sharding.spec_for_logical_axes(logical[n])
        assert set(sharding.spec_axes(spec)) == want[key], n
    for axis, dims in (("tp", port.tp_dims()), ("ep", port.ep_dims())):
        assert dims
        for n, dim in dims.items():
            spec = sharding.spec_for_logical_axes(logical[n])
            assert sharding.spec_axes(spec)[axis] == dim, (axis, n)
    assert set(port.ep_dims()) == {n for n in names if "moe_mlp" in n}
