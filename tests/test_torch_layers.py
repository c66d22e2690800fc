"""Port vs JAX: settings, the op and the DAUConv2d layer, on shared params."""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from dau_convnet_tpu.nn import layers as jl
from dau_convnet_tpu.ops import dau_conv as jdc
from dau_convnet_tpu_torch.nn import layers as tl
from dau_convnet_tpu_torch.ops import dau_conv as tdc
from dau_convnet_tpu_torch.utils import params_from_flax

from helpers import assert_matrix

SETTINGS = [
    dict(),
    dict(precision="default"),
    dict(engine="pallas_fused", static_max_offset=2.5),
    dict(kernel_size=5, component_border_bound=0.2),
    dict(blur_size=17, sigma_lower_bound=1.2, engine="xla"),
]


@pytest.mark.parametrize("kw", SETTINGS, ids=str)
def test_settings_match_jax(kw):
    ref, got = jdc.DAUConvSettings(**kw), tdc.DAUConvSettings(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    for prop in ("max_offset", "synth_kernel_size", "sigma_upper_bound"):
        assert getattr(got, prop) == getattr(ref, prop), prop


@pytest.mark.parametrize("kw", [dict(kernel_size=4), dict(engine="cuda"),
                                dict(precision="tf32"), dict(fused_bwd="x"),
                                dict(fused_dx="x"), dict(fused_gather="x"),
                                dict(sigma_lower_bound=0.9)], ids=str)
def test_settings_reject_like_jax(kw):
    with pytest.raises(ValueError):
        jdc.DAUConvSettings(**kw)
    with pytest.raises(ValueError):
        tdc.DAUConvSettings(**kw)


@pytest.mark.parametrize("units", [(1, 1), (2, 1), (1, 3), (2, 2), (3, 3)])
def test_rounded_units_match_jax(units):
    assert tl._rounded_units(units) == jl._rounded_units(units)


@pytest.mark.parametrize("units,axis", [((2, 1), 2), ((2, 1), 1), ((2, 2), 1),
                                        ((1, 3), 2), ((3, 2), 1)])
def test_grid_mean_matches_jax_exactly(units, axis):
    _, g, _ = jl._rounded_units(units)
    shape = (1, 3, g, 4)
    ref = jl.DAUGridMean(units, 3, dau_unit_axis=axis)(None, shape)
    got = tl.DAUGridMean(units, 3, dau_unit_axis=axis)(shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n_zero,axis", [(0, 2), (1, 2), (2, 3)])
def test_zero_n_last_matches_jax_exactly(n_zero, axis):
    shape = (1, 2, 3, 4)
    ref = jl.ZeroNLast(fnn.initializers.ones, n_zero, axis)(None, shape)
    got = tl.ZeroNLast(lambda shape, dtype, device, generator: torch.ones(shape, dtype=dtype),
                       n_zero, axis)(shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


LAYER_CASES = {
    # name: (engine, data_format, strides, units, static_max_offset)
    "xla": ("xla", "channels_first", 1, (2, 1), None),
    "xla-nhwc-stride2": ("xla", "channels_last", 2, (2, 1), None),
    "fused": ("pallas_fused", "channels_first", 1, (2, 1), None),
    "fused-nhwc-stride2": ("pallas_fused", "channels_last", 2, (2, 1), None),
    "fused-dummy-unit": ("pallas_fused", "channels_first", 1, (1, 1), None),
    "fused-tier": ("pallas_fused", "channels_first", 1, (2, 2), 2.5),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_dau_conv2d_matches_flax(name):
    engine, fmt, strides, units, smo = LAYER_CASES[name]
    s, f, h, w = 3, 5, 9, 10
    rng = np.random.default_rng(4)
    x = rng.random((2, s, h, w)).astype(np.float32)
    if fmt == "channels_last":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    kw = dict(filters=f, dau_units=units, max_kernel_size=9, strides=strides,
              data_format=fmt, static_max_offset=smo, engine=engine)
    layer = jl.DAUConv2d(activation=fnn.relu, **kw)
    params = jax.device_get(layer.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    g = params["mu1"].shape[2]
    # mu past the clip bound, at integers and at negative fractions
    params["mu1"] = rng.choice([-4.5, -3.99, -1.25, 0.0, 2.0, 3.5, 4.2],
                               (1, s, g, f)).astype(np.float32)
    params["mu2"] = rng.uniform(-4.5, 4.5, (1, s, g, f)).astype(np.float32)
    params["bias"] = rng.standard_normal(f).astype(np.float32)
    ref = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))

    port = tl.DAUConv2d(s, activation=torch.relu, device="cpu", **kw)
    port.load_state_dict(params_from_flax(params))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert_matrix(got, ref, name)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_dau_conv2d_params_follow_dtype_and_layout():
    layer = tl.DAUConv2d(4, 6, (2, 1), 9, dtype=torch.bfloat16, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    state = layer.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        "weights": (1, 4, 2, 6), "mu1": (1, 4, 2, 6), "mu2": (1, 4, 2, 6),
        "sigma": (1,), "bias": (6,)}
    assert all(v.dtype == torch.bfloat16 for v in state.values())
    assert layer.cfg.precision == "default" and layer.cfg.engine == "fourier"


def test_entry_points_default_to_the_card():
    # read from the signatures: nothing is built on a card here
    from dau_convnet_tpu_torch.models import AlexNetDAU
    for ctor in (tl.DAUConv2d, AlexNetDAU):
        default = inspect.signature(ctor).parameters["device"].default
        assert isinstance(default, torch.device) and default.type == "cuda", ctor


def test_infer_matches_op_and_rejects_phi():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random((1, 3, 7, 8)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((1, 3, 2, 4)) * 0.1).astype(np.float32))
    mu1, mu2 = (torch.from_numpy(rng.uniform(-3, 3, (1, 3, 2, 4)).astype(np.float32))
                for _ in range(2))
    sigma = torch.full((1,), 0.5)
    cfg = tdc.DAUConvSettings(engine="pallas_fused")
    y = tdc.dau_conv2d_infer(cfg, x, w, mu1, mu2, sigma)
    assert torch.equal(y, tdc.dau_conv2d_op(cfg, x, w, mu1, mu2, sigma))
    with pytest.raises(ValueError):
        tdc.dau_conv2d_infer(cfg, x, w, mu1, mu2, sigma, phi=(x, x))
