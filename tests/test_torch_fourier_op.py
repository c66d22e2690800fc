"""Port vs JAX: the op, the layer and AlexNet-DAU on the Fourier engine, on
the CPU.

`dau_conv2d_op` with engine 'fourier', forward and every gradient against
`jax.vjp` (the JAX side runs the fused spectral kernel in interpret mode
where fused_bwd='on'); phase-cached serving; the bf16 default-engine
AlexNet-DAU logits and one f32 Fourier SGD step at N=2, 3x67x67 (conv2 at
7x7, conv3-conv5 at 3x3), as tests/test_torch_train.py does for the Pallas
engines. Tolerances: the op in f32, rtol 1e-4 with an absolute floor of
1e-5 * max|reference| (sums over bins in another order; the mu grads carry
the learning-rate factor); bf16, 2e-2 * max|reference| (two bf16
roundings); AlexNet as in test_torch_alexnet.py / test_torch_train.py, the
bf16 logits at 5e-2 * max|logits| (bf16 roundings through four DAU layers
and three 4096-wide FCs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from dau_convnet_tpu.models import AlexNetDAU as JaxAlexNetDAU
from dau_convnet_tpu.nn import layers as jl
from dau_convnet_tpu.ops import dau_conv as jdc
from dau_convnet_tpu_torch.kernels import fused_bwd as tfb
from dau_convnet_tpu_torch.models import AlexNetDAU
from dau_convnet_tpu_torch.nn import layers as tl
from dau_convnet_tpu_torch.ops import dau_conv as tdc
from dau_convnet_tpu_torch.parallel import make_train_step
from dau_convnet_tpu_torch.utils import params_from_flax

EDGE_MU = np.array([-3.99, 3.99, -3.0, 0.0, 2.0, 3.0, -0.5, -2.25, -1.75, 1.5],
                   np.float32)
GRAD_NAMES = ("dx", "dw", "dmu1", "dmu2", "dsigma")
IMAGE, BATCH, LR = 67, 2, 1e-4


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _close(got, ref, name, rtol=1e-4, floor=1e-5):
    got = np.asarray(got.detach().float().numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, f"{name}: {got.shape} vs {ref.shape}"
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=floor * float(np.abs(ref).max()),
                               err_msg=name)


OP_CASES = {
    # name: (settings, (N, S, G, F, H, W), mu kind)
    "base": (dict(), (2, 3, 2, 5, 9, 10), "random"),
    "fused": (dict(fused_bwd="on"), (2, 8, 2, 8, 9, 9), "edges"),
    "fused_dx": (dict(fused_bwd="on", fused_dx="on"), (2, 8, 2, 8, 9, 11), "random"),
    "fused_g4": (dict(fused_bwd="on", fused_dx="on", compute_sigma_grad=False),
                 (1, 8, 4, 8, 9, 9), "random"),
    "remat_phi": (dict(remat_phi=True), (2, 3, 2, 5, 9, 10), "edges"),
    "dummy_unit": (dict(number_units_ignore=1, fused_bwd="on"), (1, 8, 2, 8, 7, 8), "edges"),
    "unit_testing": (dict(unit_testing=True, fused_bwd="on", fused_dx="on"),
                     (1, 8, 2, 8, 8, 16), "random"),
    "no_interp": (dict(use_interpolation=False), (2, 3, 2, 4, 8, 9), "edges"),
    "lr_tier": (dict(mu_learning_rate_factor=500.0, static_max_offset=2.5,
                     compute_sigma_grad=False), (1, 3, 2, 6, 9, 7), "random"),
}


def _op_inputs(shape, mu_kind, bound, seed):
    n, s, g, f, h, w = shape
    rng = np.random.default_rng(seed)
    x = rng.random((n, s, h, w)).astype(np.float32)
    wt = (rng.standard_normal((1, s, g, f)) * 0.1).astype(np.float32)
    if mu_kind == "edges":
        mu1, mu2 = np.clip(rng.choice(EDGE_MU, (2, 1, s, g, f)), -bound, bound)
    else:
        mu1, mu2 = rng.uniform(-bound, bound, (2, 1, s, g, f))
    sig = np.full((1, s, g, f), 0.5, np.float32)
    err = rng.standard_normal((n, f, h, w)).astype(np.float32)
    return [x, wt, mu1.astype(np.float32), mu2.astype(np.float32), sig], err


def _jax_op(cfg, args, err, dtype=jnp.float32):
    @jax.jit
    def run(*a):
        p = [v.astype(dtype) for v in a]
        y, vjp = jax.vjp(lambda *q: jdc.dau_conv2d_op(cfg, *q), *p[:5])
        return y, vjp(p[5])

    y, grads = run(*[jnp.asarray(a) for a in args], jnp.asarray(err))
    return np.asarray(y, np.float32), [np.asarray(g, np.float32) for g in grads]


def _port_op(cfg, args, err, dtype=torch.float32):
    ts = [_t(a, dtype).requires_grad_() for a in args]
    y = tdc.dau_conv2d_op(cfg, *ts)
    y.backward(_t(err, dtype))
    return y.detach(), [t.grad for t in ts]


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_fourier_op_matches_jax_vjp(case):
    kw, shape, mu_kind = OP_CASES[case]
    kw = dict(kw, engine="fourier")
    jcfg, tcfg = jdc.DAUConvSettings(**kw), tdc.DAUConvSettings(**kw)
    args, err = _op_inputs(shape, mu_kind, jcfg.max_offset, seed=len(case))
    if kw.get("number_units_ignore"):
        args[1][:, :, -1, :] = 0.7  # the op must mask the dummy unit itself
    y_ref, g_ref = _jax_op(jcfg, args, err)
    before = (tfb.fused_spectral_grads.launches_k1, tfb.fused_spectral_grads.launches_k2)
    y, grads = _port_op(tcfg, args, err)
    assert (tfb.fused_spectral_grads.launches_k1,
            tfb.fused_spectral_grads.launches_k2) == before  # twins on the CPU
    _close(y, y_ref, f"{case} y")
    for name, got, ref in zip(GRAD_NAMES, grads, g_ref):
        if not np.any(ref):
            assert not torch.any(got), f"{case} {name} must be zero"
            continue
        _close(got, ref, f"{case} {name}")


@pytest.mark.parametrize("fused", ["off", "on"])
def test_fourier_op_bf16_matches_jax_vjp(fused):
    kw = dict(precision="default", fused_bwd=fused, compute_sigma_grad=False)
    jcfg, tcfg = jdc.DAUConvSettings(**kw), tdc.DAUConvSettings(**kw)
    assert tcfg.engine == jcfg.engine == "fourier"
    args, err = _op_inputs((2, 8, 2, 8, 9, 10), "random", jcfg.max_offset, seed=11)
    bf = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in args + [err]]
    y_ref, g_ref = _jax_op(jcfg, bf[:5], bf[5], jnp.bfloat16)
    y, grads = _port_op(tcfg, bf[:5], bf[5], torch.bfloat16)
    assert y.dtype == torch.bfloat16
    _close(y, y_ref, "y bf16", rtol=0, floor=2e-2)
    for name, got, ref in list(zip(GRAD_NAMES, grads, g_ref))[:4]:
        assert got.dtype == torch.bfloat16, name
        _close(got, ref, f"{name} bf16", rtol=0, floor=2e-2)


def test_fused_route_follows_the_jax_gate():
    xb = torch.zeros((3, 1, 8, 9, 9))
    on = tdc.DAUConvSettings(engine="fourier", fused_bwd="on")
    assert tdc._fused_route(on, xb, 2, 153)
    # 'auto' takes the kernel only on the card (this tensor is on the CPU)
    assert not tdc._fused_route(tdc.DAUConvSettings(engine="fourier"), xb, 2, 153)
    assert not tdc._fused_route(tdc.DAUConvSettings(engine="fourier", fused_bwd="off"), xb, 4, 9)
    # no plan (M=5): the unfused gather
    assert not tdc._fused_route(on, torch.zeros((5, 1, 8, 9, 9)), 2, 153)
    assert tdc._fused_route(on, xb, 2, 153) == "phi"
    # the factored gather routes to K8 at every bin count, under 'auto' only
    # on the card (tests/test_torch_factored.py drives it through the op)
    factored = tdc.DAUConvSettings(engine="fourier", fused_bwd="on", fused_gather="factored")
    assert tdc._fused_route(factored, xb, 2, 153) == "factored"
    assert tdc._fused_route(dataclasses.replace(factored, fused_bwd="auto"), xb, 2, 153) is None


def test_precompute_phi_serves_bit_exact():
    kw = dict(engine="fourier", number_units_ignore=1)
    args, _ = _op_inputs((2, 3, 2, 5, 9, 10), "edges", 3.99, seed=12)
    x, w, mu1, mu2, sig = (_t(a) for a in args)
    tcfg = tdc.DAUConvSettings(**kw)
    phi = tdc.precompute_phi(tcfg, (9, 10), w, mu1, mu2)
    y = tdc.dau_conv2d_infer(tcfg, x, w, mu1, mu2, sig, phi=phi)
    assert torch.equal(y, tdc.dau_conv2d_op(tcfg, x, w, mu1, mu2, sig))
    jcfg = jdc.DAUConvSettings(**kw)
    jargs = [jnp.asarray(a) for a in args]
    jphi = jdc.precompute_phi(jcfg, (9, 10), *jargs[1:4])
    for got, ref in zip(phi, jphi):
        _close(got, ref, "phi", rtol=1e-5, floor=1e-6)
    _close(y, jdc.dau_conv2d_infer(jcfg, *jargs, phi=jphi), "served", rtol=1e-5, floor=1e-6)
    with pytest.raises(ValueError):
        tdc.precompute_phi(tdc.DAUConvSettings(engine="xla"), (9, 10), w, mu1, mu2)


def test_layer_phi_caching_matches_flax_and_refreshes():
    s, f, h, w = 3, 5, 9, 10
    rng = np.random.default_rng(13)
    x = rng.random((2, s, h, w)).astype(np.float32)
    kw = dict(filters=f, dau_units=(2, 1), max_kernel_size=9, engine="fourier")
    layer = jl.DAUConv2d(activation=fnn.relu, phi_caching=True, **kw)
    variables = jax.device_get(layer.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = variables["params"]
    params["mu1"] = rng.uniform(-3.99, 3.99, params["mu1"].shape).astype(np.float32)
    params["bias"] = rng.standard_normal(f).astype(np.float32)
    variables = jl.refresh_phi_cache(layer, {"params": params}, jnp.asarray(x))
    ref = np.asarray(layer.apply(variables, jnp.asarray(x)))

    port = tl.DAUConv2d(s, activation=torch.relu, phi_caching=True, device="cpu", **kw)
    assert port.phi_re is None
    with torch.no_grad():
        port(torch.from_numpy(x))  # builds the table from the initial weights
    port.load_state_dict(params_from_flax(params))  # the buffer is not in the state
    with torch.inference_mode():
        stale = port(torch.from_numpy(x))
    tl.refresh_phi_cache(port, torch.from_numpy(x))
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    _close(got, ref, "cached layer", rtol=1e-5, floor=1e-6)
    assert not torch.allclose(stale, got)
    uncached = tl.DAUConv2d(s, activation=torch.relu, device="cpu", **kw)
    uncached.load_state_dict(params_from_flax(params))
    with torch.inference_mode():
        assert torch.equal(uncached(torch.from_numpy(x)), got)
    # serving only: a forward that would need gradients raises
    with pytest.raises(RuntimeError, match="serves only"):
        port(torch.from_numpy(x))
    with torch.no_grad(), pytest.raises(ValueError, match="refresh_phi_cache"):
        port(torch.from_numpy(x[:, :, :7]))


@pytest.fixture(scope="module")
def jax_params():
    rng = np.random.default_rng(0)
    model = JaxAlexNetDAU(engine="fourier", train=False)
    x = rng.random((BATCH, 3, IMAGE, IMAGE)).astype(np.float32)
    params = jax.device_get(model.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    for name in ("dau_conv2", "dau_conv3", "dau_conv4", "dau_conv5"):
        layer = params[name]
        shape = layer["mu1"].shape
        layer["mu1"] = rng.uniform(-3.99, 3.99, shape).astype(np.float32)
        layer["mu2"] = rng.uniform(-3.99, 3.99, shape).astype(np.float32)
        layer["bias"] = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    return params, x, rng.integers(0, 1000, BATCH)


def test_bf16_default_engine_logits_match_jax(jax_params):
    params, x, _ = jax_params
    model = JaxAlexNetDAU(train=False, dtype=jnp.bfloat16)  # engine 'auto'
    # the DAU layers keep their parameters in bf16, conv1 and the FCs in f32
    bf = {k: {kk: vv.astype(jnp.bfloat16) if k.startswith("dau") else vv
              for kk, vv in v.items()} for k, v in params.items()}
    ref = np.asarray(jax.jit(lambda p, v: model.apply({"params": p}, v))(bf, jnp.asarray(x)),
                     np.float32)
    port = AlexNetDAU(dtype=torch.bfloat16, image_size=IMAGE, device="cpu")
    assert all(port.get_submodule(f"dau_conv{i}").cfg.engine == "fourier" for i in range(2, 6))
    port.load_state_dict(params_from_flax(params))
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and np.isfinite(got.float().numpy()).all()
    _close(got, ref, "bf16 logits", rtol=0, floor=5e-2)
    # phase-cached serving gives the same logits as the per-call table
    cached = AlexNetDAU(dtype=torch.bfloat16, image_size=IMAGE, device="cpu", phi_caching=True)
    cached.load_state_dict(params_from_flax(params))
    tl.refresh_phi_cache(cached, torch.from_numpy(x))
    with torch.inference_mode():
        assert torch.equal(cached(torch.from_numpy(x)), got)


def test_fourier_sgd_step_matches_jax(jax_params):
    params, x, labels = jax_params
    model = JaxAlexNetDAU(engine="fourier", fused_bwd="on", train=False)

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean()

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = optax.sgd(LR)
    new = optax.apply_updates(params, tx.update(grads, tx.init(params))[0])
    grads, new = params_from_flax(jax.device_get(grads)), params_from_flax(jax.device_get(new))

    port = AlexNetDAU(engine="fourier", fused_bwd="on", image_size=IMAGE, device="cpu")
    port.load_state_dict(params_from_flax(params))
    step = make_train_step(port, torch.optim.SGD(port.parameters(), lr=LR))
    got = step(torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-5)
    for name, p in port.named_parameters():
        ref = grads[name].numpy()
        if name.endswith(".sigma"):  # not trainable
            assert p.grad is None and not np.any(ref), name
            continue
        _close(p.grad, ref, f"grad {name}", rtol=1e-3, floor=1e-4)
        np.testing.assert_allclose(p.detach().numpy(), new[name].numpy(), rtol=1e-6,
                                   atol=1e-3 * LR * float(np.abs(ref).max()),
                                   err_msg=f"param {name}")
