"""Port vs JAX: the DAU backward, K6 (grad tables), K4 (aggregation) and the
pieces around them, on the CPU.

On the CPU each port kernel wrapper computes its plain twin; the JAX side
runs its Pallas kernels in interpret mode, as tests/test_pallas.py does.
Tolerances, f32: rtol 1e-4 with an absolute floor of 1e-5 * max|reference|
(the sums run in other orders; the mu grads carry the learning-rate factor,
so the floor scales with the tensor). bf16: 2e-2 * max|reference|, about
two bf16 roundings of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from dau_convnet_tpu.kernels import aggregate_forward_pallas, grad_tables_pallas
from dau_convnet_tpu.nn import layers as jl
from dau_convnet_tpu.ops import dau_conv as jdc
from dau_convnet_tpu.ops import gaussian as jg
from dau_convnet_tpu.ops import xla_engine as jxe
from dau_convnet_tpu.utils import math as jmath
from dau_convnet_tpu_torch.kernels import backward as tkb
from dau_convnet_tpu_torch.kernels import forward as tkf
from dau_convnet_tpu_torch.nn import layers as tl
from dau_convnet_tpu_torch.ops import dau_conv as tdc
from dau_convnet_tpu_torch.ops import gaussian as tg
from dau_convnet_tpu_torch.ops import xla_engine as txe
from dau_convnet_tpu_torch.utils import clip_nan, params_from_flax

from helpers import assert_matrix, oracle_fwd_bwd, random_case

EDGE_MU = np.array([-3.99, 3.99, -3.0, 0.0, 2.0, 3.0, -0.5, -2.25, -1.75, 1.5],
                   np.float32)
ENGINES = ["xla", "pallas", "pallas_fused"]


def _t(a, **kw):
    return torch.tensor(np.asarray(a), **kw)


def _close(got, ref, name, rtol=1e-4, floor=1e-5):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, f"{name}: {got.shape} vs {ref.shape}"
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=floor * float(np.abs(ref).max()),
                               err_msg=name)


# ---- depthwise blur, stacked filters -------------------------------------

@pytest.mark.parametrize("names", [("w", "dmu1", "dmu2"), ("w", "dmu1", "dmu2", "dsigma"),
                                   ("error",)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_depthwise_blur_stacked_matches_jax(names, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 9, 11)).astype(np.float32)
    filts = jg.gaussian_filters(jnp.float32(0.7), size=9)
    stack = jnp.stack([filts[k] for k in names])
    ref = jg.depthwise_blur(jnp.asarray(x, getattr(jnp, dtype)), stack)
    got = tg.depthwise_blur(_t(x).to(getattr(torch, dtype)), _t(stack))
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == ref.shape == (2, 3 * len(names), 9, 11)
    if dtype == "float32":
        _close(got.numpy(), ref, "blur", rtol=1e-5, floor=1e-6)
    else:
        _close(got.float().numpy(), np.asarray(ref, np.float32), "blur bf16", rtol=0, floor=2e-2)


# ---- K6 and the tap-gather ------------------------------------------------

TABLE_SHAPES = {
    # name: (M, N, S, F, H, W, ks)
    "odd": (3, 2, 3, 5, 7, 9, 9),
    "sigma": (4, 1, 2, 3, 5, 6, 5),
    "wide": (3, 2, 4, 6, 11, 8, 7),
}


@pytest.mark.parametrize("name", sorted(TABLE_SHAPES))
def test_grad_tables_match_jax_kernel(name):
    m, n, s, f, h, w, ks = TABLE_SHAPES[name]
    rng = np.random.default_rng(1)
    xb = rng.standard_normal((m, n, s, h, w)).astype(np.float32)
    err = rng.standard_normal((n, f, h, w)).astype(np.float32)
    ref = jax.jit(lambda a, b: grad_tables_pallas(a, b, ks))(jnp.asarray(xb), jnp.asarray(err))
    before = tkb.grad_tables.launches
    got = tkb.grad_tables(_t(xb), _t(err), ks)
    assert tkb.grad_tables.launches == before  # the CPU computes the twin
    assert got.dtype == torch.float32
    _close(got.numpy(), ref, name, rtol=1e-5, floor=1e-6)
    # the dense twin in torch against the JAX dense engine
    ref_xla = jxe.grad_tables(jnp.asarray(xb), jnp.asarray(err), ks)
    _close(txe.grad_tables(_t(xb), _t(err), ks).numpy(), ref_xla, name, rtol=1e-5, floor=1e-6)


def test_grad_tables_take_strided_planes_and_widen_bf16():
    # the op hands the kernel a permuted view of the stacked blur
    rng = np.random.default_rng(2)
    blur = _t(rng.standard_normal((2, 3 * 4, 6, 7)).astype(np.float32))  # (N, S*M, H, W)
    xb = blur.reshape(2, 4, 3, 6, 7).permute(2, 0, 1, 3, 4)  # (M, N, S, H, W)
    err = _t(rng.standard_normal((2, 5, 6, 7)).astype(np.float32))
    want = txe.grad_tables(xb.contiguous(), err, 5)
    torch.testing.assert_close(tkb.grad_tables(xb, err, 5), want, rtol=1e-6, atol=1e-6)
    got = tkb.grad_tables(xb.bfloat16(), err.bfloat16(), 5)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, txe.grad_tables(xb.bfloat16().float(),
                                                    err.bfloat16().float(), 5))


@pytest.mark.parametrize("bad", ["rank", "batch", "dtype", "mixed", "ks"])
def test_grad_tables_reject_bad_input(bad):
    xb, err, ks = torch.zeros((3, 2, 2, 5, 5)), torch.zeros((2, 4, 5, 5)), 5
    if bad == "rank":
        xb = xb[0]
    elif bad == "batch":
        err = err[:1]
    elif bad == "dtype":
        xb, err = xb.double(), err.double()
    elif bad == "mixed":
        err = err.bfloat16()
    else:
        ks = 4
    with pytest.raises((ValueError, TypeError)):
        tkb.grad_tables(xb, err, ks)


@pytest.mark.parametrize("interp", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tap_gather_matches_jax(interp, dtype):
    rng = np.random.default_rng(3)
    m, s, g, f, ks = 3, 4, 2, 5, 9
    table = rng.standard_normal((m, s, f, ks, ks)).astype(np.float32)
    mu1 = rng.choice(EDGE_MU, (s, g, f))
    mu2 = rng.uniform(-3.99, 3.99, (s, g, f)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jxe.tap_gather(jnp.asarray(table, jd), jnp.asarray(mu1), jnp.asarray(mu2), ks, interp)
    got = txe.tap_gather(_t(table).to(td), _t(mu1), _t(mu2), ks, interp)
    assert got.dtype == td and tuple(got.shape) == ref.shape == (m, s, g, f)
    if dtype == "float32":
        _close(got.numpy(), ref, "gather", rtol=1e-6, floor=1e-7)
    else:
        _close(got.float().numpy(), np.asarray(ref, np.float32), "gather bf16", rtol=0, floor=1e-2)


# ---- K4 -------------------------------------------------------------------

@pytest.mark.parametrize("interp", [True, False])
def test_aggregate_kernel_twin_matches_jax_kernel(interp):
    rng = np.random.default_rng(4)
    n, s, g, f, h, w, ks = 2, 5, 2, 6, 10, 11, 9
    xb = rng.random((n, s, h, w)).astype(np.float32)
    wt = (rng.standard_normal((s, g, f)) * 0.1).astype(np.float32)
    mu1 = rng.choice(EDGE_MU, (s, g, f))
    mu2 = rng.uniform(-3.99, 3.99, (s, g, f)).astype(np.float32)
    ref = jax.jit(lambda *a: aggregate_forward_pallas(*a, ks, interp))(
        jnp.asarray(xb), jnp.asarray(wt), jnp.asarray(mu1), jnp.asarray(mu2))
    before = tkf.aggregate_forward.launches
    got = tkf.aggregate_forward(_t(xb), _t(wt), _t(mu1), _t(mu2), ks, interp)
    assert tkf.aggregate_forward.launches == before
    _close(got.numpy(), ref, "K4", rtol=1e-5, floor=1e-6)
    # bf16 keeps its dtype and rounds once, after an f32 sum
    got16 = tkf.aggregate_forward(_t(xb).bfloat16(), _t(wt).bfloat16(), _t(mu1).bfloat16(),
                                  _t(mu2).bfloat16(), ks, interp)
    want16 = tkf.aggregate_forward_plain(_t(xb).bfloat16().float(), _t(wt).bfloat16(),
                                         _t(mu1).bfloat16(), _t(mu2).bfloat16(), ks, interp)
    assert got16.dtype == torch.bfloat16 and torch.equal(got16, want16.bfloat16())


# ---- the op: forward and backward against jax.vjp -------------------------

OP_CASES = {
    # name: (settings, (N, S, G, F, H, W), mu kind)
    "base": (dict(), (2, 3, 2, 5, 9, 10), "random"),
    "no_sigma_grad": (dict(compute_sigma_grad=False), (2, 3, 2, 5, 9, 10), "random"),
    "dummy_unit": (dict(number_units_ignore=1), (1, 4, 2, 3, 7, 8), "edges"),
    "unit_testing": (dict(unit_testing=True), (1, 3, 2, 4, 8, 16), "random"),
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
        mu1, mu2 = rng.uniform(-bound, bound, (2, 1, s, g, f)).astype(np.float32)
    sig = np.full((1, s, g, f), 0.5, np.float32)
    err = rng.standard_normal((n, f, h, w)).astype(np.float32)
    return [x, wt, mu1.astype(np.float32), mu2.astype(np.float32), sig], err


def _jax_op(cfg, args, err):
    @jax.jit
    def run(*a):
        y, vjp = jax.vjp(lambda *p: jdc.dau_conv2d_op(cfg, *p), *a[:5])
        return y, vjp(a[5])

    y, grads = run(*[jnp.asarray(a) for a in args], jnp.asarray(err))
    return np.asarray(y), [np.asarray(g) for g in grads]


def _port_op(cfg, args, err, dtype=torch.float32):
    ts = [_t(a).to(dtype).requires_grad_() for a in args]
    y = tdc.dau_conv2d_op(cfg, *ts)
    y.backward(_t(err).to(dtype))
    return y.detach(), [t.grad for t in ts]


GRAD_NAMES = ("dx", "dw", "dmu1", "dmu2", "dsigma")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_forward_backward_match_jax_vjp(case, engine):
    kw, shape, mu_kind = OP_CASES[case]
    kw = dict(kw, engine=engine)
    jcfg, tcfg = jdc.DAUConvSettings(**kw), tdc.DAUConvSettings(**kw)
    args, err = _op_inputs(shape, mu_kind, jcfg.max_offset, seed=len(case))
    if kw.get("number_units_ignore"):
        args[1][:, :, -1, :] = 0.7  # the op must mask the dummy unit itself
    y_ref, g_ref = _jax_op(jcfg, args, err)
    y, grads = _port_op(tcfg, args, err)
    _close(y.numpy(), y_ref, f"{case}/{engine} y")
    for name, got, ref in zip(GRAD_NAMES, grads, g_ref):
        assert got.shape == ref.shape, name
        if not np.any(ref):
            assert not torch.any(got), f"{case}/{engine} {name} must be zero"
            continue
        _close(got.numpy(), ref, f"{case}/{engine} {name}")


@pytest.mark.parametrize("engine", ["pallas", "pallas_fused"])
def test_op_bf16_matches_jax_vjp(engine):
    kw = dict(engine=engine, precision="default", compute_sigma_grad=False)
    jcfg, tcfg = jdc.DAUConvSettings(**kw), tdc.DAUConvSettings(**kw)
    args, err = _op_inputs((2, 4, 2, 6, 9, 10), "random", jcfg.max_offset, seed=11)
    args16 = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in args]
    err16 = np.asarray(jnp.asarray(err, jnp.bfloat16).astype(jnp.float32))

    @jax.jit
    def run(*a):
        p = [v.astype(jnp.bfloat16) for v in a]
        y, vjp = jax.vjp(lambda *q: jdc.dau_conv2d_op(jcfg, *q), *p[:5])
        return y, vjp(p[5])

    y_ref, g_ref = run(*[jnp.asarray(a) for a in args16], jnp.asarray(err16))
    y, grads = _port_op(tcfg, args16, err16, torch.bfloat16)
    assert y.dtype == torch.bfloat16
    _close(y.float().numpy(), np.asarray(y_ref, np.float32), "y bf16", rtol=0, floor=2e-2)
    for name, got, ref in list(zip(GRAD_NAMES, grads, g_ref))[:4]:
        assert got.dtype == torch.bfloat16, name
        _close(got.float().numpy(), np.asarray(ref, np.float32), f"{name} bf16", rtol=0,
               floor=2e-2)


@pytest.mark.parametrize("engine", ENGINES)
def test_op_matches_oracle(engine):
    rng = np.random.default_rng(3)
    x, w, mu1, mu2, sigma, err = random_case(
        rng, N=2, W=9, H=8, S=3, F=4, units=(1, 2), max_kernel_size=9, max_offset_init=3)
    cfg = tdc.DAUConvSettings(kernel_size=9, unit_testing=True, engine=engine)
    sig = np.broadcast_to(np.float32(sigma).reshape(1, 1, 1, 1), w.shape).astype(np.float32)
    y, grads = _port_op(cfg, [x, w, mu1, mu2, sig], err)
    gt_fwd, gt_bwd = oracle_fwd_bwd(x, w, mu1, mu2, sigma, err, unit_testing=True)
    assert_matrix(y.numpy(), gt_fwd, f"{engine} fwd_output")
    for name, got, want in zip(("bwd_error", "bwd_w_grad", "bwd_mu1_grad", "bwd_mu2_grad",
                                "bwd_sigma_grad"), grads, gt_bwd):
        assert_matrix(got.numpy(), want, f"{engine} {name}")


def test_op_grads_only_where_asked():
    args, err = _op_inputs((1, 3, 2, 4, 7, 8), "random", 3.99, seed=5)
    cfg = tdc.DAUConvSettings(engine="pallas")
    ts = [_t(a) for a in args]
    ts[1].requires_grad_()  # w only: no dx pass, no sigma grad
    before = tkf.aggregate_forward.launches
    tdc.dau_conv2d_op(cfg, *ts).backward(_t(err))
    assert tkf.aggregate_forward.launches == before
    assert ts[1].grad is not None and all(t.grad is None for i, t in enumerate(ts) if i != 1)


def test_op_backward_takes_a_strided_error():
    args, err = _op_inputs((1, 3, 2, 4, 7, 8), "random", 3.99, seed=6)
    cfg = tdc.DAUConvSettings(engine="pallas_fused")
    ts = [_t(a).requires_grad_() for a in args]
    y = tdc.dau_conv2d_op(cfg, *ts)
    (y[:, :, ::2, ::2] * 2.0).sum().backward()
    want = torch.zeros_like(y)
    want[:, :, ::2, ::2] = 2.0
    _, ref = _port_op(cfg, args, want.numpy())
    for got, r in zip([t.grad for t in ts], ref):
        torch.testing.assert_close(got, r, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("engine", ENGINES)
def test_nan_guard_zeroes_mu_grads_like_jax(engine):
    # an inf in the error, read only inside the image, makes every table
    # entry +-inf; the gather's zero taps turn that into NaN
    args, err = _op_inputs((1, 2, 2, 3, 12, 12), "random", 3.99, seed=7)
    err = np.zeros_like(err)
    err[0, 0, 5, 5] = np.inf
    for guard in (True, False):
        kw = dict(engine=engine, nan_guard_mu_grads=guard, compute_sigma_grad=False)
        _, g_ref = _jax_op(jdc.DAUConvSettings(**kw), args, err)
        _, grads = _port_op(tdc.DAUConvSettings(**kw), args, err)
        for name, got, ref in list(zip(GRAD_NAMES, grads, g_ref))[1:4]:
            got = got.numpy()
            np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=name)
            np.testing.assert_array_equal(np.isinf(got), np.isinf(ref), err_msg=name)
        assert np.isnan(grads[1].numpy()).any()
        if guard:
            assert not np.isnan(grads[2].numpy()).any() and not np.isnan(grads[3].numpy()).any()


def test_clip_nan_passes_inf_like_jax():
    v = np.array([np.nan, np.inf, -np.inf, 0.0, -2.5, 3.0], np.float32)
    ref = np.asarray(jmath.clip_nan(jnp.asarray(v)))
    np.testing.assert_array_equal(clip_nan(_t(v)).numpy(), ref)
    np.testing.assert_array_equal(ref, [0.0, np.inf, -np.inf, 0.0, -2.5, 3.0])


@pytest.mark.parametrize("h,w", [(8, 16), (7, 9), (32, 20), (64, 65)])
def test_edge_gradient_mask_matches_jax(h, w):
    ref = np.asarray(jdc.edge_gradient_mask(h, w))
    np.testing.assert_array_equal(tdc.edge_gradient_mask(h, w).numpy(), ref)


# ---- the layer: the clip gradient at the bound ----------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_layer_clip_tie_gradient_matches_jax(engine):
    s, f, h, w = 3, 4, 9, 10
    rng = np.random.default_rng(9)
    x = rng.random((2, s, h, w)).astype(np.float32)
    kw = dict(filters=f, dau_units=(2, 1), max_kernel_size=9, engine=engine,
              dau_sigma_trainable=True)
    layer = jl.DAUConv2d(activation=None, **kw)
    params = jax.device_get(layer.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    bound = np.float32(3.99)
    # mu exactly on the bound, past it and inside; sigma on its lower bound
    params["mu1"] = rng.choice([-bound, bound, -4.5, 1.25], (1, s, 2, f)).astype(np.float32)
    params["mu2"] = rng.choice([bound, -bound, 0.5], (1, s, 2, f)).astype(np.float32)
    params["sigma"] = np.array([0.3], np.float32)
    err = rng.standard_normal((2, f, h, w)).astype(np.float32)

    def loss(p):
        return jnp.vdot(layer.apply({"params": p}, jnp.asarray(x)), jnp.asarray(err))

    ref = jax.device_get(jax.jit(jax.grad(loss))(params))
    port = tl.DAUConv2d(s, device="cpu", **kw)
    port.load_state_dict(params_from_flax(params))
    (port(_t(x)) * _t(err)).sum().backward()
    for name in ("weights", "mu1", "mu2", "sigma", "bias"):
        _close(getattr(port, name).grad.numpy(), ref[name], f"{engine} {name}")

    # the tie takes half the op's gradient (at the clipped mu), the outside none
    cfg = port.cfg
    mus = [_t(np.clip(params[k], -bound, bound)).requires_grad_() for k in ("mu1", "mu2")]
    sig = _t(params["sigma"]).reshape(1, 1, 1, 1).expand(1, s, 2, f)
    y = tdc.dau_conv2d_op(cfg, _t(x), port.weights.detach(), *mus, sig)
    (y * _t(err)).sum().backward()
    for mu_t, name in zip(mus, ("mu1", "mu2")):
        raw = params[name]
        op_g, layer_g = mu_t.grad.numpy(), getattr(port, name).grad.numpy()
        tie = np.abs(raw) == bound
        assert tie.any()
        np.testing.assert_allclose(layer_g[tie], 0.5 * op_g[tie], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(layer_g[np.abs(raw) > bound], 0.0)
