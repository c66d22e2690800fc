"""DAU layer API as `torch.nn.Module`s.

Counterpart of `dau_convnet_tpu/nn/layers.py`: `DAUConv2d` keeps the JAX
layer's parameter names and layouts (weights/mu1/mu2 [1, S, G, F], sigma
(1,), bias (F,)), its unit rounding to groups of 2, its mu and sigma clips,
its stride by output slicing and its NCHW/NHWC handling, so parameters load
one to one (`utils.checkpoint.params_from_flax`). The input channel count
is a constructor argument, since PyTorch creates parameters eagerly.

`DAUConv1d`, the `dau_conv2d`/`dau_conv1d` factories (layer, optional
normalizer, activation), `set_dau_variables_manually` and
`project_dau_params` complete the JAX layer API. Initializers take
`(shape, dtype, device, generator)`; constraints and regularizers are
callables on a parameter tensor, as in JAX.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch
from torch import nn

from ..ops.dau_conv import DAUConvSettings, dau_conv2d_infer, dau_conv2d_op, precompute_phi
from ..ops.gaussian import blur_kernel_size
from ..parallel import _collectives
from ..parallel.mesh import axis_size
from ..utils import tracing

__all__ = ["DAU_UNITS_GROUP", "DAUGridMean", "ZeroNLast", "DAUConv2d", "DAUConv1d",
           "dau_conv2d", "dau_conv1d", "set_dau_variables_manually", "project_dau_params",
           "refresh_phi_cache", "DAUConvBlock", "normal", "zeros", "constant",
           "xavier_normal"]

# the engine aggregates units in groups of 2; odd unit counts get one dummy
# unit with zero weight
DAU_UNITS_GROUP = 2


def DAUGridMean(dau_units, max_value, dau_unit_axis=2):
    """Initializer spreading DAU means on a regular grid in [-max, +max].

    For the shape [1, S, G, F] with G = prod(dau_units) (+ dummy pad),
    positions vary along unit axis `dau_unit_axis` of the separated
    [S, units0, units1, F] view (2 => mu1, 1 => mu2) and broadcast along the
    other axes. Deterministic: the generator is ignored.
    """
    u0, u1 = dau_units

    def init(shape, dtype=torch.float32, device=None, generator=None):
        del generator
        if len(shape) != 4:
            raise ValueError("DAUGridMean requires rank-4 shape [1, S, units, F]")
        _, s, g, f = shape
        if g != u0 * u1:
            # dummy-padded unit count: spread over the flat G axis instead
            vals = (np.arange(g) * (2 * max_value + 1) / float(g)
                    + (-0.5 + (2 * max_value + 1) / float(2 * g)) - max_value)
            out = np.broadcast_to(vals[None, None, :, None], (1, s, g, f))
            return torch.tensor(np.ascontiguousarray(out), dtype=dtype, device=device)
        n = (u0, u1)[dau_unit_axis - 1]
        vals = (np.arange(n) * (2 * max_value + 1) / float(n)
                + (-0.5 + (2 * max_value + 1) / float(2 * n)) - max_value)
        grid = np.zeros((1, s, u0, u1, f))
        if dau_unit_axis == 2:
            grid += vals[None, None, None, :, None]
        elif dau_unit_axis == 1:
            grid += vals[None, None, :, None, None]
        else:
            raise ValueError("dau_unit_axis must be 1 (mu2) or 2 (mu1)")
        return torch.tensor(grid.reshape(1, s, g, f), dtype=dtype, device=device)

    return init


def ZeroNLast(base_init, last_num_to_zero, axis):
    """Wrap an initializer, zeroing the last N entries along `axis`."""

    def init(shape, dtype=torch.float32, device=None, generator=None):
        vals = base_init(shape, dtype, device, generator)
        if last_num_to_zero == 0:
            return vals
        keep = torch.arange(shape[axis], device=vals.device) < shape[axis] - last_num_to_zero
        bshape = [1] * len(shape)
        bshape[axis] = shape[axis]
        return vals * keep.reshape(bshape).to(dtype)

    return init


def normal(stddev: float = 0.01):
    """Initializer: normal draws of standard deviation `stddev` (flax's
    `initializers.normal`)."""
    def init(shape, dtype=torch.float32, device=None, generator=None):
        gen_device = generator.device if generator is not None else device
        vals = torch.randn(shape, generator=generator, device=gen_device) * stddev
        return vals.to(device=device, dtype=dtype)
    return init


def constant(value: float):
    """Initializer: every entry `value`."""
    def init(shape, dtype=torch.float32, device=None, generator=None):
        return torch.full(tuple(shape), value, dtype=dtype, device=device)
    return init


zeros = constant(0.0)


def xavier_normal():
    """Initializer: flax's `initializers.xavier_normal` (variance scaling
    1.0, fan_avg, normal), fans taken as flax takes them: the last axis is
    the output, the one before it the input, the rest the receptive field
    ((1, S, G, F) weights: fan_in G*S, fan_out F*S)."""
    def init(shape, dtype=torch.float32, device=None, generator=None):
        receptive = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
        fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
        return normal(math.sqrt(2.0 / (fan_in + fan_out)))(shape, dtype, device, generator)
    return init


def _rounded_units(dau_units: tp.Tuple[int, int]):
    """Round the unit count up to a multiple of DAU_UNITS_GROUP, growing the
    smaller grid axis. Returns (dau_units, num_all, num_ignore)."""
    units = tuple(int(u) for u in dau_units)
    num_all = int(np.prod(units))
    num_ignore = 0
    if num_all % DAU_UNITS_GROUP != 0:
        new_num = int(math.ceil(num_all / DAU_UNITS_GROUP) * DAU_UNITS_GROUP)
        num_ignore = new_num - num_all
        if units[0] < units[1]:
            units = (units[0] + num_ignore, units[1])
        else:
            units = (units[0], units[1] + num_ignore)
        num_all = new_num
    return units, num_all, num_ignore


def refresh_phi_cache(model: nn.Module, sample_input) -> nn.Module:
    """Rebuild every `phi_caching` layer's cached phase table from the
    CURRENT parameters (serving: call once after loading or updating
    weights). Runs one forward of `model` on `sample_input` without
    gradients; the input must have the serving spatial shape and dtype, for
    which the tables are built. Returns the model."""
    for layer in model.modules():
        if isinstance(layer, DAUConv2d):
            layer.clear_phi_cache()
    with torch.no_grad():
        model(sample_input)
    return model


def _clip(v, lo: float, hi: float):
    """`jnp.clip` with its gradient: 1 inside, 1/2 at a value exactly on a
    bound, 0 outside (`torch.clamp` passes all of it at the bound). The
    bounds are rounded to v's dtype, as JAX rounds its weakly typed ones,
    and filled on v's device (no host copy, so no stream sync)."""
    return torch.minimum(torch.maximum(v, v.new_full((), lo)), v.new_full((), hi))


class DAUConv2d(nn.Module):
    """Displaced Aggregation Unit 2D convolution layer.

    Input is NCHW for data_format='channels_first', NHWC for
    'channels_last'. Parameters are created in `dtype` on `device` (the CUDA
    card unless the caller names another device) by the *_initializer
    arguments, each called as init(shape, dtype, device, generator). The
    defaults: weights normal with stddev 0.1 (the dummy units' zeroed),
    mu1/mu2 on the DAUGridMean grid (mu2 at zero for a 1D layer), sigma at
    `dau_sigma_init`, bias at zero. The weight, mu1, mu2 and sigma
    *_constraint callables map a parameter's value before every use in the
    forward; `bias_constraint` is taken and not applied, as in JAX's layer.
    The *_regularizer callables are summed by `regularization_loss()`.

    fused_bwd, fused_dx, fused_gather and remat_phi steer the fourier
    engine's backward (see `DAUConvSettings`). phi_caching (SERVING ONLY):
    the fourier engine's phase table is kept in a non-persistent buffer,
    built without gradients from the current parameters at the first
    forward, for that input's spatial shape and dtype, and every forward
    serves through `dau_conv2d_infer(phi=...)`; after loading new weights
    call `refresh_phi_cache`. A caching layer asked for gradients raises:
    run it under `torch.no_grad()` or `torch.inference_mode()`.

    `mesh` (set by `parallel.init_sharded`, None otherwise) is the device
    mesh the layer is sharded over. Where its parameters hold an F-slice,
    the layer is column-parallel: the op computes this rank's output
    channels (`dau_conv2d_op(..., mesh=)`), the slices are all-gathered
    over the model axis, and sigma, replicated, enters through
    `copy_to_model`.

    `trace_name` (set by `parallel.make_train_step` to the layer's name in
    its model, None otherwise) names the layer in its `dau.forward` and
    `dau.backward` spans (`utils.tracing`).
    """

    mesh = None
    trace_name = None

    def __init__(self, in_channels: int, filters: int,
                 dau_units: tp.Tuple[int, int], max_kernel_size: int, *,
                 strides: int = 1,
                 data_format: str = "channels_first",
                 activation: tp.Optional[tp.Callable] = None,
                 use_bias: bool = True,
                 weight_initializer: tp.Callable = normal(0.1),
                 mu1_initializer: tp.Optional[tp.Callable] = None,
                 mu2_initializer: tp.Optional[tp.Callable] = None,
                 sigma_initializer: tp.Optional[tp.Callable] = None,
                 bias_initializer: tp.Callable = zeros,
                 weight_constraint: tp.Optional[tp.Callable] = None,
                 mu1_constraint: tp.Optional[tp.Callable] = None,
                 mu2_constraint: tp.Optional[tp.Callable] = None,
                 sigma_constraint: tp.Optional[tp.Callable] = None,
                 bias_constraint: tp.Optional[tp.Callable] = None,
                 weight_regularizer: tp.Optional[tp.Callable] = None,
                 mu1_regularizer: tp.Optional[tp.Callable] = None,
                 mu2_regularizer: tp.Optional[tp.Callable] = None,
                 sigma_regularizer: tp.Optional[tp.Callable] = None,
                 bias_regularizer: tp.Optional[tp.Callable] = None,
                 mu_learning_rate_factor: float = 500.0,
                 dau_unit_border_bound: float = 0.01,
                 dau_unit_single_dim: bool = False,
                 dau_aggregation_forbid_positive_dim1: bool = False,
                 dau_sigma_trainable: bool = False,
                 dau_mu_interpolation: bool = True,
                 dau_sigma_init: float = 0.5,
                 dau_sigma_max: tp.Optional[float] = None,
                 unit_testing: bool = False,
                 static_max_offset: tp.Optional[float] = None,
                 engine: str = "auto",
                 fused_bwd: str = "auto",
                 fused_dx: str = "auto",
                 fused_gather: str = "phi",
                 remat_phi: bool = False,
                 phi_caching: bool = False,
                 precision: tp.Optional[str] = None,
                 dtype: torch.dtype = torch.float32,
                 device=torch.device("cuda"),
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.filters = filters
        self.max_kernel_size = max_kernel_size
        self.strides = strides
        self.channels_last = data_format in ("channels_last", "NHWC")
        self.activation = activation
        self.dau_sigma_trainable = dau_sigma_trainable
        self.dau_unit_single_dim = dau_unit_single_dim
        self.static_max_offset = static_max_offset
        self.dau_unit_border_bound = dau_unit_border_bound
        self.dau_sigma_init = dau_sigma_init
        self.dau_sigma_max = dau_sigma_max
        self.phi_caching = phi_caching
        self.register_buffer("phi_re", None, persistent=False)
        self.register_buffer("phi_im", None, persistent=False)
        self._phi_key = None
        # bias_constraint is kept and, as in JAX's layer, never applied
        self.constraints = dict(weights=weight_constraint, mu1=mu1_constraint,
                                mu2=mu2_constraint, sigma=sigma_constraint)
        self.bias_constraint = bias_constraint
        self.regularizers = dict(weights=weight_regularizer, mu1=mu1_regularizer,
                                 mu2=mu2_regularizer, sigma=sigma_regularizer,
                                 bias=bias_regularizer)

        units, num_all, num_ignore = _rounded_units(tuple(dau_units))
        self._unit_info = (units, num_all, num_ignore)
        self.in_channels = in_channels
        pshape = self.dau_param_shape()
        max_val = math.floor(max_kernel_size / 2.0) - 1
        w_init = ZeroNLast(weight_initializer, num_ignore, axis=2)
        mu1_init = mu1_initializer or DAUGridMean(units, max_val, dau_unit_axis=2)
        mu2_init = mu2_initializer or (zeros if dau_unit_single_dim
                                       else DAUGridMean(units, max_val, dau_unit_axis=1))
        sigma_init = sigma_initializer or constant(dau_sigma_init)
        mk = dict(dtype=dtype, device=device, generator=generator)
        self.weights = nn.Parameter(w_init(pshape, **mk))
        self.mu1 = nn.Parameter(mu1_init(pshape, **mk))
        self.mu2 = nn.Parameter(mu2_init(pshape, **mk))
        self.sigma = nn.Parameter(sigma_init((1,), **mk))
        self.bias = nn.Parameter(bias_initializer((filters,), **mk)) if use_bias else None

        if precision is None:
            precision = "highest" if dtype == torch.float32 else "default"
        self.cfg = DAUConvSettings(
            kernel_size=max_kernel_size,
            use_interpolation=dau_mu_interpolation,
            number_units_ignore=num_ignore,
            single_dim_kernel=dau_unit_single_dim,
            forbid_positive_dim1=dau_aggregation_forbid_positive_dim1,
            mu_learning_rate_factor=mu_learning_rate_factor,
            component_border_bound=dau_unit_border_bound,
            unit_testing=unit_testing,
            blur_size=blur_kernel_size(self._sigma_cap()),
            compute_sigma_grad=dau_sigma_trainable,
            static_max_offset=static_max_offset,
            engine=engine,
            precision=precision,
            fused_bwd=fused_bwd,
            fused_dx=fused_dx,
            fused_gather=fused_gather,
            remat_phi=remat_phi,
        )

    def _sigma_cap(self) -> float:
        """Largest sigma this layer's static blur filter must support."""
        if not self.dau_sigma_trainable:
            return self.dau_sigma_init
        cap = 1.6 if self.dau_sigma_max is None else self.dau_sigma_max
        return max(self.dau_sigma_init, cap)

    @property
    def padding(self) -> int:
        return int(math.floor(self.max_kernel_size / 2.0))

    @property
    def num_dau_units_all(self) -> int:
        return self._unit_info[1]

    @property
    def num_dau_units_ignore(self) -> int:
        return self._unit_info[2]

    def dau_param_shape(self, in_channels: tp.Optional[int] = None):
        """[1, S, G, F] of weights/mu1/mu2; S is the layer's own input
        channel count unless another is given (JAX's signature)."""
        s = self.in_channels if in_channels is None else in_channels
        return (1, s, self.num_dau_units_all, self.filters)

    def regularization_loss(self) -> torch.Tensor:
        """Sum of the configured per-parameter regularizers over this layer's
        own parameters (the raw values, as JAX's over its param dict). Add
        it to the training loss."""
        total = self.weights.new_zeros((), dtype=torch.float32)
        for name, reg in self.regularizers.items():
            value = getattr(self, name)
            if reg is not None and value is not None:
                total = total + reg(value)
        return total

    def _constrained(self, name: str):
        value = getattr(self, name)
        fn = self.constraints[name]
        return value if fn is None else fn(value)

    def clear_phi_cache(self) -> None:
        """Drop the cached phase table; the next forward rebuilds it."""
        self.phi_re = self.phi_im = None
        self._phi_key = None

    def _cached_phi(self, x, w, mu1, mu2):
        """The cached phase table for x's spatial shape and dtype, built from
        the current (clipped) parameters at the first call."""
        if torch.is_grad_enabled() and (x.requires_grad or any(
                p.requires_grad for p in self.parameters())):
            raise RuntimeError(
                "DAUConv2d(phi_caching=True) serves only: its cached-phi forward has no "
                "gradients; run it under torch.no_grad() or torch.inference_mode()")
        key = (tuple(x.shape[-2:]), x.dtype, x.device)
        if self._phi_key is None:
            with torch.no_grad():
                self.phi_re, self.phi_im = precompute_phi(
                    self.cfg, key[0], w.to(x.dtype), mu1, mu2)
            self._phi_key = key
        elif self._phi_key != key:
            raise ValueError(f"the phase table was built for {self._phi_key}, the input is "
                             f"{key}; call refresh_phi_cache with a serving-shaped input")
        return self.phi_re, self.phi_im

    def forward(self, inputs):
        if inputs.dim() != 4:
            raise ValueError(f"DAUConv2d expects rank-4 input, got {tuple(inputs.shape)}")
        x = inputs.permute(0, 3, 1, 2) if self.channels_last else inputs
        with tracing.span("dau.forward") as sp:
            if sp:
                n, s, h, w = x.shape
                sp.set(layer=self.trace_name, N=n, S=s, H=h, W=w, F=self.weights.shape[-1])
            return self._forward(x)

    def _forward(self, x):
        w, mu1, mu2, sigma = (self._constrained(k) for k in ("weights", "mu1", "mu2", "sigma"))
        bias = self.bias
        if not self.dau_sigma_trainable:
            sigma = sigma.detach()
        else:
            sigma = _clip(sigma, DAUConvSettings.sigma_lower_bound, self._sigma_cap())
        if self.dau_unit_single_dim:
            # 1D DAU: mu2 pinned at zero
            mu2 = torch.zeros_like(mu2)

        # layer-level clip keeping units inside the kernel; a
        # static_max_offset promise tightens it
        bound = math.floor(self.max_kernel_size / 2.0) - self.dau_unit_border_bound
        if self.static_max_offset is not None:
            bound = min(bound, self.static_max_offset)
        mu1 = _clip(mu1, -bound, bound)
        mu2 = _clip(mu2, -bound, bound)

        mesh, model_group = self._mesh_route()
        if model_group is not None:
            # the replicated sigma's gradient sums over every unit: this
            # rank's units give a partial sum, closed over the model axis
            sigma = _collectives.copy_to_model(sigma, model_group)
        sigma_tiled = sigma.reshape(1, 1, 1, 1).expand(w.shape)
        if self.phi_caching and self.cfg.engine == "fourier":
            out = dau_conv2d_infer(self.cfg, x, w, mu1, mu2, sigma_tiled,
                                   phi=self._cached_phi(x, w, mu1, mu2))
        else:
            out = dau_conv2d_op(self.cfg, x, w, mu1, mu2, sigma_tiled, mesh=mesh)

        if self.strides > 1:
            # stride emulated by output slicing, same compute as stride 1
            out = out[:, :, ::self.strides, ::self.strides]
        if bias is not None:
            out = out + bias.reshape(1, -1, 1, 1)
        if self.activation is not None:
            out = self.activation(out)
        if model_group is not None:
            out = _collectives.gather_from_model(out, model_group, dim=1)
        return out.permute(0, 2, 3, 1) if self.channels_last else out

    def _mesh_route(self):
        """(mesh for the op, process group of the model axis) under
        `self.mesh`: the model group where this layer holds an F-slice, None
        where it runs whole (no mesh, or F not split: then under a model
        axis it runs replicated on every model rank, outside the op's mesh
        route)."""
        mesh = self.mesh
        if mesh is None:
            return None, None
        model_axis = self.cfg.model_axis
        if self.weights.shape[-1] != self.filters:
            return mesh, mesh.get_group(model_axis)
        return (mesh if axis_size(mesh, model_axis) == 1 else None), None


class DAUConv1d(DAUConv2d):
    """1D DAU convolution: units displace only along x, mu2 pinned at zero
    (`dau_unit_single_dim=True`)."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("dau_unit_single_dim", True)
        super().__init__(*args, **kwargs)


class DAUConvBlock(nn.Module):
    """What `dau_conv2d` and `dau_conv1d` return: the DAU layer (`conv`),
    then the normalizer, called as normalizer_fn(y, **normalizer_params)
    (a module is registered as `norm`, so its parameters and statistics
    belong to the block), then the activation."""

    def __init__(self, conv: DAUConv2d, normalizer_fn=None, normalizer_params=None,
                 activation_fn=None):
        super().__init__()
        self.conv = conv
        self.norm = normalizer_fn
        self.normalizer_params = dict(normalizer_params or {})
        self.activation_fn = activation_fn

    def forward(self, x):
        y = self.conv(x)
        if self.norm is not None:
            y = self.norm(y, **self.normalizer_params)
        if self.activation_fn is not None:
            y = self.activation_fn(y)
        return y


def dau_conv2d(in_channels: int, filters: int, dau_units, max_kernel_size: int, *,
               stride: int = 1, mu_learning_rate_factor: float = 500,
               data_format: str = "channels_first",
               activation_fn: tp.Optional[tp.Callable] = torch.relu,
               normalizer_fn: tp.Optional[tp.Callable] = None, normalizer_params=None,
               weights_initializer: tp.Callable = normal(0.1),
               weights_regularizer=None, weights_constraint=None,
               mu1_initializer=None, mu1_regularizer=None, mu1_constraint=None,
               mu2_initializer=None, mu2_regularizer=None, mu2_constraint=None,
               sigma_initializer=None, sigma_regularizer=None, sigma_constraint=None,
               biases_initializer: tp.Optional[tp.Callable] = zeros,
               biases_regularizer=None, biases_constraint=None,
               dau_unit_border_bound: float = 0.01, dau_sigma_trainable: bool = False,
               dau_mu_interpolation: bool = True, **layer_kwargs) -> DAUConvBlock:
    """The contrib-style wrapper as a module: a `DAUConv2d`, an optional
    normalizer (a module or any callable) and the activation (ReLU by
    default). As in JAX, the layer has no bias when a normalizer is given
    or `biases_initializer` is None. `layer_kwargs` go to `DAUConv2d`
    (engine, dtype, device, generator, ...)."""
    conv = DAUConv2d(
        in_channels, filters, dau_units, max_kernel_size, strides=stride,
        data_format=data_format,
        use_bias=normalizer_fn is None and biases_initializer is not None,
        weight_initializer=weights_initializer, weight_regularizer=weights_regularizer,
        weight_constraint=weights_constraint,
        mu1_initializer=mu1_initializer, mu1_regularizer=mu1_regularizer,
        mu1_constraint=mu1_constraint,
        mu2_initializer=mu2_initializer, mu2_regularizer=mu2_regularizer,
        mu2_constraint=mu2_constraint,
        sigma_initializer=sigma_initializer, sigma_regularizer=sigma_regularizer,
        sigma_constraint=sigma_constraint,
        bias_initializer=biases_initializer or zeros, bias_regularizer=biases_regularizer,
        bias_constraint=biases_constraint,
        mu_learning_rate_factor=mu_learning_rate_factor,
        dau_unit_border_bound=dau_unit_border_bound,
        dau_sigma_trainable=dau_sigma_trainable, dau_mu_interpolation=dau_mu_interpolation,
        **layer_kwargs)
    return DAUConvBlock(conv, normalizer_fn, normalizer_params, activation_fn)


def dau_conv1d(in_channels: int, filters: int, dau_units, max_kernel_size: int, *,
               dau_aggregation_forbid_positive_dim1: bool = False,
               normalizer_fn: tp.Optional[tp.Callable] = None,
               activation_fn: tp.Optional[tp.Callable] = torch.relu,
               **kwargs) -> DAUConvBlock:
    """1D variant of `dau_conv2d`, with JAX's rules for this wrapper:
    `kwargs` go to `DAUConv1d` under its own argument names; the layer has
    a bias whenever no normalizer is given, and a given normalizer only
    decides that: it is not applied."""
    conv = DAUConv1d(
        in_channels, filters, dau_units, max_kernel_size, use_bias=normalizer_fn is None,
        dau_aggregation_forbid_positive_dim1=dau_aggregation_forbid_positive_dim1, **kwargs)
    return DAUConvBlock(conv, activation_fn=activation_fn)


def set_dau_variables_manually(module: nn.Module, layer_path: str = "", *, weights=None,
                               mu1=None, mu2=None, sigma=None, bias=None) -> nn.Module:
    """Install DAU parameter values into `module` in place and return it.

    PyTorch's idiom for the JAX function, which returns a new variables
    pytree: here the named layer's parameters are overwritten under
    `torch.no_grad()`. `layer_path` names the layer below `module` by
    attribute, '/'- or '.'-separated (``"stage0_block0/dau1"``); ``""`` is
    `module` itself. Values (arrays or tensors) are cast to the parameter's
    dtype and device; shapes must match exactly, except that `sigma` also
    takes a bare scalar. Raises KeyError for a missing layer or parameter
    and ValueError for a shape mismatch, as JAX does.
    """
    node = module
    for part in (p for p in layer_path.replace(".", "/").split("/") if p):
        children = dict(node.named_children())
        if part not in children:
            raise KeyError(f"layer path {layer_path!r} not found (missing {part!r}); "
                           f"available: {sorted(children)}")
        node = children[part]
    params = dict(node.named_parameters(recurse=False))
    updates = {"weights": weights, "mu1": mu1, "mu2": mu2, "sigma": sigma, "bias": bias}
    with torch.no_grad():
        for name, value in updates.items():
            if value is None:
                continue
            if name not in params:
                raise KeyError(f"layer {layer_path!r} has no parameter {name!r} "
                               f"(has {sorted(params)})")
            old = params[name]
            new = torch.as_tensor(np.asarray(value) if not torch.is_tensor(value) else value)
            new = new.to(dtype=old.dtype, device=old.device)
            if name == "sigma" and new.dim() == 0:
                new = new.reshape(old.shape)
            if new.shape != old.shape:
                raise ValueError(f"{layer_path}/{name}: shape {tuple(new.shape)} != expected "
                                 f"{tuple(old.shape)} (DAU params are [1, S, G, F]; sigma "
                                 "is (1,))")
            old.copy_(new)
    return module


def project_dau_params(params, *, kernel_size: int, component_border_bound: float = 0.01,
                       sigma_lower_bound: float = 0.3, sigma_upper_bound: float = 1.6):
    """Clip DAU parameters into their valid ranges in place, under
    `torch.no_grad()`, and return what was given: a module (its named
    parameters) or a mapping of names to tensors (a state dict). Tensors
    named 'sigma' go into [sigma_lower_bound, sigma_upper_bound], 'mu1' and
    'mu2' into +-(kernel_size//2 - component_border_bound); all else is
    left alone. PyTorch's idiom for the JAX function, which returns a new
    pytree; run it on the model after each optimizer step (with a trainable
    sigma in particular)."""
    bound = kernel_size // 2 - component_border_bound
    items = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    with torch.no_grad():
        for name, value in items:
            leaf = name.replace("/", ".").split(".")[-1]
            if leaf == "sigma":
                value.clamp_(sigma_lower_bound, sigma_upper_bound)
            elif leaf in ("mu1", "mu2"):
                value.clamp_(-bound, bound)
    return params

