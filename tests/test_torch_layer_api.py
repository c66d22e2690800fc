"""Port vs JAX: the rest of the layer API.

`DAUConv1d`, the `dau_conv2d`/`dau_conv1d` wrappers, constraints,
regularizers and initializers of `DAUConv2d`, its properties,
`set_dau_variables_manually`, `project_dau_params`, the math helpers of
`utils/math.py` and AlexNet-DAU's unit budgets, each against the JAX
package on the same numpy inputs from a seed.

Tolerance: f32 rtol 1e-4 with an absolute floor of 1e-4*max|ref|, as
tests/test_torch_alexnet.py; exact where both sides compute the same
elementwise op.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from dau_convnet_tpu.models import ALEXNET_DAU_VARIANTS
from dau_convnet_tpu.models import AlexNetDAU as JaxAlexNetDAU
from dau_convnet_tpu.nn import layers as jl
from dau_convnet_tpu.utils import math as jm
from dau_convnet_tpu_torch import models as tmodels
from dau_convnet_tpu_torch.models import AlexNetDAU
from dau_convnet_tpu_torch.nn import BatchNorm
from dau_convnet_tpu_torch.nn import layers as tl
from dau_convnet_tpu_torch.utils import math as tm
from dau_convnet_tpu_torch.utils import params_from_flax


def _close(got, ref, name=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()),
                               err_msg=name)


def _input(seed=0, shape=(2, 3, 9, 10)):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _spread_mu(params, rng):
    """Offsets over the kernel (and past the clip bound) in a flax params
    dict, in place."""
    for layer in (params, *[v for v in params.values() if isinstance(v, dict)]):
        for key in ("mu1", "mu2"):
            if key in layer:
                layer[key] = rng.uniform(-4.5, 4.5, layer[key].shape).astype(np.float32)


def _flax(module_fn, x, rng):
    """Init a flax module built by `module_fn` on x, spread its offsets;
    returns (apply, params)."""
    class Net(fnn.Module):
        @fnn.compact
        def __call__(self, v):
            return module_fn()(v)

    net = Net()
    params = jax.device_get(net.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    _spread_mu(params, rng)
    return (lambda p: np.asarray(net.apply({"params": p}, jnp.asarray(x)))), params


@pytest.mark.parametrize("engine", ["xla", "fourier"])
def test_dau_conv1d_layer_matches_flax(engine):
    rng = np.random.default_rng(1)
    x = _input(1, (2, 3, 5, 16))
    kw = dict(filters=4, dau_units=(2, 1), max_kernel_size=9, engine=engine,
              dau_aggregation_forbid_positive_dim1=True)
    layer = jl.DAUConv1d(**kw)
    params = jax.device_get(layer.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    _spread_mu(params, rng)
    params["bias"] = rng.standard_normal(4).astype(np.float32)
    ref = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))

    port = tl.DAUConv1d(3, device="cpu", **kw)
    assert not port.mu2.any() and port.dau_unit_single_dim
    port.load_state_dict(params_from_flax(params))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    _close(got, ref, engine)


@pytest.mark.parametrize("engine", ["xla", "fourier"])
@pytest.mark.parametrize("normalizer", [False, True])
def test_dau_conv2d_wrapper_matches_flax(engine, normalizer):
    """Layer, optional normalizer (a BatchNorm in eval mode, with
    statistics), ReLU; no bias when a normalizer is given."""
    rng = np.random.default_rng(2)
    x = _input(2)
    stats = dict(mean=rng.standard_normal(5).astype(np.float32) * 0.1,
                 var=rng.uniform(0.5, 2.0, 5).astype(np.float32))
    kw = dict(dau_units=(2, 2), max_kernel_size=9, engine=engine, stride=2)

    def flax_norm(v):
        return fnn.BatchNorm(use_running_average=True, axis=1, name="bn")(v)

    class Net(fnn.Module):
        @fnn.compact
        def __call__(self, v):
            return jl.dau_conv2d(v, 5, normalizer_fn=flax_norm if normalizer else None,
                                 name="dau", **kw)

    net = Net()
    variables = jax.device_get(net.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    _spread_mu(variables["params"], rng)
    if normalizer:
        variables["batch_stats"]["bn"] = stats
        variables["params"]["bn"]["scale"] = rng.uniform(0.5, 2, 5).astype(np.float32)
    else:
        variables["params"]["dau"]["bias"] = rng.standard_normal(5).astype(np.float32)
    ref = np.asarray(net.apply(variables, jnp.asarray(x)))

    norm = BatchNorm(5, device="cpu").eval() if normalizer else None
    port = tl.dau_conv2d(3, 5, normalizer_fn=norm, device="cpu", **kw)
    assert (port.conv.bias is None) == normalizer
    state = {k.replace("dau.", "conv.").replace("bn.", "norm."): v
             for k, v in params_from_flax(variables).items()}
    port.load_state_dict(state)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.min() >= 0.0
    _close(got, ref, f"{engine} normalizer={normalizer}")


def test_dau_conv2d_wrapper_bias_rule():
    kw = dict(device="cpu")
    assert tl.dau_conv2d(3, 4, (2, 1), 9, **kw).conv.bias is not None
    assert tl.dau_conv2d(3, 4, (2, 1), 9, biases_initializer=None, **kw).conv.bias is None
    assert tl.dau_conv2d(3, 4, (2, 1), 9, normalizer_fn=torch.tanh, **kw).conv.bias is None
    # a callable normalizer gets normalizer_params
    block = tl.dau_conv2d(3, 4, (2, 1), 9, normalizer_fn=lambda y, scale: y * scale,
                          normalizer_params=dict(scale=0.0), activation_fn=None, **kw)
    with torch.inference_mode():
        assert not block(torch.rand(1, 3, 6, 6)).any()
    # dau_conv1d: a bias whenever no normalizer is given
    assert tl.dau_conv1d(3, 4, (2, 1), 9, **kw).conv.bias is not None
    assert tl.dau_conv1d(3, 4, (2, 1), 9, normalizer_fn=torch.tanh, **kw).conv.bias is None
    assert isinstance(tl.dau_conv1d(3, 4, (2, 1), 9, **kw).conv, tl.DAUConv1d)


@pytest.mark.parametrize("normalizer", [False, True])
@pytest.mark.parametrize("engine", ["xla", "fourier"])
def test_dau_conv1d_wrapper_matches_flax(engine, normalizer):
    """With a normalizer, JAX's dau_conv1d drops the bias and does not apply
    the normalizer; the port does the same."""
    rng = np.random.default_rng(3)
    x = _input(3, (1, 3, 4, 16))
    kw = dict(dau_units=(2, 1), max_kernel_size=9, engine=engine,
              dau_aggregation_forbid_positive_dim1=True)
    jnorm, tnorm = (lambda y: 3.0 * y - 1.0), (lambda y: 3.0 * y - 1.0)
    apply, params = _flax(lambda: (lambda v: jl.dau_conv1d(
        v, 4, **kw, **(dict(normalizer_fn=jnorm) if normalizer else {}))), x, rng)
    assert ("bias" in params["DAUConv1d_0"]) != normalizer
    if not normalizer:
        params["DAUConv1d_0"]["bias"] = rng.standard_normal(4).astype(np.float32)
    ref = apply(params)
    port = tl.dau_conv1d(3, 4, device="cpu", **kw,
                         **(dict(normalizer_fn=tnorm) if normalizer else {}))
    port.conv.load_state_dict(params_from_flax(params["DAUConv1d_0"]))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    _close(got, ref, f"{engine} normalizer={normalizer}")


def test_constraints_and_regularizers_match_flax():
    """tests/test_layers.py's constraint and regularizers, on both sides."""
    x = np.ones((1, 3, 8, 8), np.float32)
    kw = dict(filters=4, dau_units=(2, 1), max_kernel_size=9, use_bias=False)
    op = jl.DAUConv2d(weight_constraint=lambda w: w / (jnp.abs(w).max() + 1e-9),
                      weight_regularizer=lambda w: 0.5 * jnp.sum(w ** 2),
                      mu1_regularizer=lambda m: jnp.sum(jnp.abs(m)), **kw)
    params = jax.device_get(op.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    ref = np.asarray(op.apply({"params": params}, jnp.asarray(x)))
    ref_reg = float(op.regularization_loss(params))

    port = tl.DAUConv2d(3, device="cpu",
                        weight_constraint=lambda w: w / (w.abs().max() + 1e-9),
                        weight_regularizer=lambda w: 0.5 * torch.sum(w ** 2),
                        mu1_regularizer=lambda m: torch.sum(m.abs()), **kw)
    port.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    _close(got, ref, "constrained output")
    np.testing.assert_allclose(float(port.regularization_loss().detach()), ref_reg, rtol=1e-6)
    # without the constraint the output differs: the constraint was applied
    plain = tl.DAUConv2d(3, device="cpu", **kw)
    plain.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        assert not np.allclose(plain(torch.from_numpy(x)).numpy(), ref, rtol=1e-3)
    assert float(plain.regularization_loss()) == 0.0


def test_bias_constraint_is_not_applied_as_in_flax():
    """JAX's layer takes bias_constraint and never applies it; so does the
    port's: a bias of 5 clamped at 1 stays 5 in the output on both sides."""
    x = np.ones((1, 3, 6, 6), np.float32)
    kw = dict(filters=4, dau_units=(2, 1), max_kernel_size=9)
    op = jl.DAUConv2d(bias_constraint=lambda b: jnp.minimum(b, 1.0),
                      weight_initializer=fnn.initializers.zeros,
                      bias_initializer=fnn.initializers.constant(5.0), **kw)
    params = jax.device_get(op.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    ref = np.asarray(op.apply({"params": params}, jnp.asarray(x)))
    assert np.all(ref == 5.0)
    layer = tl.DAUConv2d(3, bias_initializer=tl.constant(5.0),
                         bias_constraint=lambda b: torch.clamp(b, max=1.0),
                         weight_initializer=tl.zeros, device="cpu", **kw)
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_initializer_arguments():
    layer = tl.DAUConv2d(3, 4, (1, 1), 9, weight_initializer=tl.constant(2.0),
                         mu1_initializer=tl.constant(1.5), mu2_initializer=tl.constant(-1.0),
                         sigma_initializer=tl.constant(0.7), bias_initializer=tl.constant(0.25),
                         device="cpu")
    w = layer.weights.detach()
    assert torch.equal(w[:, :, 0], torch.full_like(w[:, :, 0], 2.0))
    assert not w[:, :, 1].any()  # the dummy unit stays zero (ZeroNLast)
    assert float(layer.mu1.detach()[0, 0, 0, 0]) == 1.5
    assert float(layer.mu2.detach()[0, 0, 0, 0]) == -1.0
    assert float(layer.sigma.detach()) == pytest.approx(0.7)
    assert float(layer.bias.detach()[0]) == 0.25
    # xavier-normal has flax's scale: fan_in G*S, fan_out F*S on [1, S, G, F]
    shape = (1, 64, 4, 96)
    ref = np.asarray(fnn.initializers.xavier_normal()(jax.random.PRNGKey(0), shape))
    got = tl.xavier_normal()(shape, generator=torch.Generator().manual_seed(0)).numpy()
    want = np.sqrt(2.0 / (4 * 64 + 96 * 64))
    for v in (ref, got):
        assert abs(v.std() / want - 1) < 0.02


@pytest.mark.parametrize("units", [(1, 1), (2, 1), (2, 2), (3, 1)])
def test_properties_match_flax(units):
    ref = jl.DAUConv2d(filters=6, dau_units=units, max_kernel_size=11)
    port = tl.DAUConv2d(5, 6, units, 11, device="cpu")
    for prop in ("padding", "num_dau_units_all", "num_dau_units_ignore"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert port.dau_param_shape(5) == ref.dau_param_shape(5) == tuple(port.weights.shape)
    assert port.dau_param_shape() == port.dau_param_shape(5)


@pytest.mark.parametrize("variant", sorted(ALEXNET_DAU_VARIANTS))
def test_alexnet_unit_budgets_match_jax(variant):
    published = {"small": 368_640, "default": 737_280, "large": 1_474_560}
    port = AlexNetDAU(variant=variant, image_size=67, device="cpu")
    assert port.num_dau_units() == JaxAlexNetDAU(variant=variant).num_dau_units()
    assert port.num_dau_units() == published[variant]


def _flax_dau_params(s=3, g=2, f=4):
    layer = jl.DAUConv2d(filters=f, dau_units=(g, 1), max_kernel_size=9)
    return jax.device_get(layer.init(jax.random.PRNGKey(0), jnp.ones((1, s, 6, 6))))["params"]


@pytest.mark.parametrize("sep", ["/", "."])
def test_set_dau_variables_manually_matches_jax(sep):
    rng = np.random.default_rng(4)
    params = _flax_dau_params()
    new = {k: rng.standard_normal(params[k].shape).astype(np.float32)
           for k in ("weights", "mu1", "mu2")}
    ref = jl.set_dau_variables_manually({"block": {"dau": params}}, "block/dau", sigma=0.8,
                                        **new)

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.dau = tl.DAUConv2d(3, 4, (2, 1), 9, device="cpu")

    model = torch.nn.Module()
    model.block = Block()
    out = tl.set_dau_variables_manually(model, f"block{sep}dau", sigma=0.8, **new)
    assert out is model
    state = model.block.dau.state_dict()
    for key, val in ref["block"]["dau"].items():
        np.testing.assert_array_equal(state[key].numpy(), np.asarray(val), err_msg=key)
    # the module itself at the root path
    tl.set_dau_variables_manually(model.block.dau, "", bias=np.arange(4.0))
    assert torch.equal(model.block.dau.bias.detach(), torch.arange(4.0))


@pytest.mark.parametrize("case", ["missing-layer", "missing-param", "bad-shape"])
def test_set_dau_variables_manually_raises_like_jax(case):
    params = _flax_dau_params()
    layer = tl.DAUConv2d(3, 4, (2, 1), 9, use_bias=False, device="cpu")
    path, kw, err = {
        "missing-layer": ("nope", dict(sigma=0.5), KeyError),
        "missing-param": ("", dict(bias=np.zeros(4)), KeyError),
        "bad-shape": ("", dict(mu1=np.zeros((1, 3, 2, 5))), ValueError),
    }[case]
    jparams = dict(params)
    if case == "missing-param":
        jparams.pop("bias")
    with pytest.raises(err):
        jl.set_dau_variables_manually(jparams, path, **kw)
    with pytest.raises(err):
        tl.set_dau_variables_manually(layer, path, **kw)


def test_project_dau_params_matches_jax():
    """tests/test_layers.py's case, on a state dict and on a module."""
    params = {"dau1": {"sigma": np.asarray([0.1]), "mu1": np.asarray([[5.0, -5.0]]),
                       "mu2": np.asarray([[0.5, 2.0]]), "weights": np.asarray([9.9])},
              "fc": {"kernel": np.asarray([7.0])}}
    ref = jax.device_get(jl.project_dau_params(
        jax.tree_util.tree_map(jnp.asarray, params), kernel_size=9))
    state = {f"{a}.{b}": torch.tensor(v) for a, d in params.items() for b, v in d.items()}
    out = tl.project_dau_params(state, kernel_size=9)
    assert out is state
    for key, val in state.items():
        a, b = key.split(".")
        np.testing.assert_allclose(val.numpy(), np.asarray(ref[a][b]), rtol=1e-6, err_msg=key)
    layer = tl.DAUConv2d(3, 4, (2, 1), 9, dau_sigma_trainable=True, device="cpu")
    with torch.no_grad():
        layer.sigma.fill_(2.5)
        layer.mu1.fill_(-7.0)
    assert tl.project_dau_params(layer, kernel_size=9) is layer
    assert float(layer.sigma.detach()) == pytest.approx(1.6)
    assert torch.all(layer.mu1 == torch.tensor(-(4 - 0.01)))


VALIDATE = {
    "good": {},
    "nan": dict(mu1=np.full((1, 2, 2, 3), np.nan)),
    "past-bound": dict(mu2=np.full((1, 2, 2, 3), 7.0)),
    "low-sigma": dict(sigma=np.array([0.05])),
}


@pytest.mark.parametrize("case", sorted(VALIDATE))
def test_validate_dau_params_matches_jax(case):
    args = dict(w=np.ones((1, 2, 2, 3)), mu1=np.ones((1, 2, 2, 3)),
                mu2=-np.ones((1, 2, 2, 3)), sigma=np.array([0.5]))
    args.update(VALIDATE[case])
    try:
        jm.validate_dau_params(**args, kernel_size=9)
        ref = None
    except ValueError as e:
        ref = str(e).split(" ")[0]
    torch_args = {k: torch.tensor(v) for k, v in args.items()}
    if ref is None:
        tm.validate_dau_params(**torch_args, kernel_size=9)
    else:
        with pytest.raises(ValueError):
            tm.validate_dau_params(**torch_args, kernel_size=9)
    assert (ref is None) == (case == "good")


MATH = {
    "clip_lower": (lambda m, x: m.clip_lower(x, 0.25)),
    "clip_upper": (lambda m, x: m.clip_upper(x, -0.1)),
    "clip_eps": (lambda m, x: m.clip_eps(x, 0.5)),
    "clip_nan": (lambda m, x: m.clip_nan(x)),
    "pad2d": (lambda m, x: m.pad2d(x, 2, value=1.5)),
    "amax": (lambda m, x: m.amax(x)),
    "segmented_sum": (lambda m, x: m.segmented_sum(x, 7)),
    "im2col": (lambda m, x: m.im2col(x[0], 3, 2, pad=1, stride=2)),
}


@pytest.mark.parametrize("name", sorted(MATH))
def test_math_helpers_match_jax(name):
    x = np.random.default_rng(5).standard_normal((2, 3, 7, 6)).astype(np.float32)
    x[0, 0, 0, :3] = [np.nan, np.inf, -np.inf]
    if name in ("amax", "segmented_sum", "im2col"):
        x = np.nan_to_num(x, nan=0.0, posinf=3.0, neginf=-3.0)
    ref = np.asarray(MATH[name](jm, jnp.asarray(x)))
    got = MATH[name](tm, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ctor", ["DAUConv1d", "DAUCifarNet", "ConvCifarNet", "DAUResNet",
                                  "DAUBasicBlock", "BatchNorm"])
def test_new_entry_points_default_to_the_card(ctor):
    # read from the signatures: nothing is built on a card here
    cls = BatchNorm if ctor == "BatchNorm" else getattr(tl, ctor, None) or getattr(tmodels, ctor)
    params = inspect.signature(cls).parameters
    if "device" in params:
        default = params["device"].default
    else:  # DAUConv1d forwards to DAUConv2d
        default = inspect.signature(tl.DAUConv2d).parameters["device"].default
    assert isinstance(default, torch.device) and default.type == "cuda", ctor
