"""DAU layer API as `torch.nn.Module`s.

Counterpart of `dau_convnet_tpu/nn/layers.py`: `DAUConv2d` keeps the JAX
layer's parameter names and layouts (weights/mu1/mu2 [1, S, G, F], sigma
(1,), bias (F,)), its unit rounding to groups of 2, its mu and sigma clips,
its stride by output slicing and its NCHW/NHWC handling, so parameters load
one to one (`utils.checkpoint.params_from_flax`). The input channel count
is a constructor argument, since PyTorch creates parameters eagerly.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch
from torch import nn

from ..ops.dau_conv import DAUConvSettings, dau_conv2d_infer, dau_conv2d_op, precompute_phi
from ..ops.gaussian import blur_kernel_size

__all__ = ["DAU_UNITS_GROUP", "DAUGridMean", "ZeroNLast", "DAUConv2d", "refresh_phi_cache"]

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


def _normal_init(stddev: float):
    def init(shape, dtype=torch.float32, device=None, generator=None):
        gen_device = generator.device if generator is not None else device
        vals = torch.randn(shape, generator=generator, device=gen_device) * stddev
        return vals.to(device=device, dtype=dtype)
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
    card unless the caller names another device); weights are drawn from
    `generator` (normal, stddev 0.1), mu1/mu2 start on the DAUGridMean grid,
    sigma at `dau_sigma_init`, bias at zero.

    fused_bwd, fused_dx, fused_gather and remat_phi steer the fourier
    engine's backward (see `DAUConvSettings`). phi_caching (SERVING ONLY):
    the fourier engine's phase table is kept in a non-persistent buffer,
    built without gradients from the current parameters at the first
    forward, for that input's spatial shape and dtype, and every forward
    serves through `dau_conv2d_infer(phi=...)`; after loading new weights
    call `refresh_phi_cache`. A caching layer asked for gradients raises:
    run it under `torch.no_grad()` or `torch.inference_mode()`.
    """

    def __init__(self, in_channels: int, filters: int,
                 dau_units: tp.Tuple[int, int], max_kernel_size: int, *,
                 strides: int = 1,
                 data_format: str = "channels_first",
                 activation: tp.Optional[tp.Callable] = None,
                 use_bias: bool = True,
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

        units, num_all, num_ignore = _rounded_units(tuple(dau_units))
        pshape = (1, in_channels, num_all, filters)
        max_val = math.floor(max_kernel_size / 2.0) - 1
        w_init = ZeroNLast(_normal_init(0.1), num_ignore, axis=2)
        mu1_init = DAUGridMean(units, max_val, dau_unit_axis=2)
        mu2_init = DAUGridMean(units, max_val, dau_unit_axis=1)
        mk = dict(dtype=dtype, device=device, generator=generator)
        self.weights = nn.Parameter(w_init(pshape, **mk))
        self.mu1 = nn.Parameter(mu1_init(pshape, **mk))
        self.mu2 = nn.Parameter(torch.zeros(pshape, dtype=dtype, device=device)
                                if dau_unit_single_dim else mu2_init(pshape, **mk))
        self.sigma = nn.Parameter(torch.full((1,), dau_sigma_init, dtype=dtype, device=device))
        self.bias = (nn.Parameter(torch.zeros((filters,), dtype=dtype, device=device))
                     if use_bias else None)

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

    def clear_phi_cache(self) -> None:
        """Drop the cached phase table; the next forward rebuilds it."""
        self.phi_re = self.phi_im = None
        self._phi_key = None

    def _cached_phi(self, x, mu1, mu2):
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
                    self.cfg, key[0], self.weights.to(x.dtype), mu1, mu2)
            self._phi_key = key
        elif self._phi_key != key:
            raise ValueError(f"the phase table was built for {self._phi_key}, the input is "
                             f"{key}; call refresh_phi_cache with a serving-shaped input")
        return self.phi_re, self.phi_im

    def forward(self, inputs):
        if inputs.dim() != 4:
            raise ValueError(f"DAUConv2d expects rank-4 input, got {tuple(inputs.shape)}")
        x = inputs.permute(0, 3, 1, 2) if self.channels_last else inputs

        sigma = self.sigma
        if not self.dau_sigma_trainable:
            sigma = sigma.detach()
        else:
            sigma = _clip(sigma, DAUConvSettings.sigma_lower_bound, self._sigma_cap())
        mu1, mu2 = self.mu1, self.mu2
        if self.dau_unit_single_dim:
            mu2 = torch.zeros_like(mu2)

        # layer-level clip keeping units inside the kernel; a
        # static_max_offset promise tightens it
        bound = math.floor(self.max_kernel_size / 2.0) - self.dau_unit_border_bound
        if self.static_max_offset is not None:
            bound = min(bound, self.static_max_offset)
        mu1 = _clip(mu1, -bound, bound)
        mu2 = _clip(mu2, -bound, bound)

        sigma_tiled = sigma.reshape(1, 1, 1, 1).expand(self.weights.shape)
        if self.phi_caching and self.cfg.engine == "fourier":
            out = dau_conv2d_infer(self.cfg, x, self.weights, mu1, mu2, sigma_tiled,
                                   phi=self._cached_phi(x, mu1, mu2))
        else:
            out = dau_conv2d_op(self.cfg, x, self.weights, mu1, mu2, sigma_tiled)

        if self.strides > 1:
            # stride emulated by output slicing, same compute as stride 1
            out = out[:, :, ::self.strides, ::self.strides]
        if self.bias is not None:
            out = out + self.bias.reshape(1, self.filters, 1, 1)
        if self.activation is not None:
            out = self.activation(out)
        return out.permute(0, 2, 3, 1) if self.channels_last else out
