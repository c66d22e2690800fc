"""The DAU convolution primitive, `dau_conv2d_op`, in PyTorch.

Counterpart of `dau_convnet_tpu/ops/dau_conv.py`: the same settings, the
same parameter preparation (dummy-unit mask, sigma clip, filter build), the
same forward chain and the same analytic backward (`_bwd_rule`), for the
engines ported so far: 'xla' (depthwise blur + dense aggregation),
'pallas' (depthwise blur + the aggregation kernel K4) and 'pallas_fused'
(the fused blur + aggregation kernel K5); both Pallas engines take their
unit gradients from the grad-table kernel K6. 'fourier' (also what 'auto'
picks at precision='default') raises NotImplementedError until its ROADMAP
step lands; it never falls back to another engine.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import torch

from ..utils.math import clip_nan
from . import xla_engine
from ._edge import disabled_edges
from .gaussian import depthwise_blur, gaussian_filters

__all__ = ["DAUConvSettings", "dau_conv2d_op", "dau_conv2d_infer", "edge_gradient_mask"]

_FOURIER_TODO = "ROADMAP.md 'Still to port', step 1 (Fourier forward)"


@dataclasses.dataclass(frozen=True)
class DAUConvSettings:
    """Static configuration of a DAU convolution; the fields, defaults and
    validation of the JAX `DAUConvSettings`. Fields that steer the Fourier
    engine or the sharded backward are kept so a configuration carries over
    as it is; they take effect when those paths are ported."""

    kernel_size: int = 9
    use_interpolation: bool = True
    number_units_ignore: int = 0
    single_dim_kernel: bool = False
    forbid_positive_dim1: bool = False
    mu_learning_rate_factor: float = 1.0
    nan_guard_mu_grads: bool = True
    unit_normalization: bool = True
    square_unit_normalization: bool = False
    component_border_bound: float = 0.01
    sigma_lower_bound: float = 0.3
    unit_testing: bool = False
    blur_size: int = 9
    compute_sigma_grad: bool = True
    # 'auto' resolves at construction: 'fourier' for precision='default',
    # 'xla' for precision='highest'
    engine: str = "auto"
    precision: str = "highest"
    static_max_offset: tp.Optional[float] = None
    fused_bwd: str = "auto"
    data_axis: str = "data"
    model_axis: str = "model"
    fused_dx: str = "auto"
    fused_gather: str = "phi"
    remat_phi: bool = False
    merge_iteration_step: int = 0
    merge_threshold: float = 1.0
    mean_iteration_step: int = 0
    sigma_iteration_step: int = 0

    def __post_init__(self):
        if self.kernel_size % 2 != 1 or self.kernel_size < 1:
            raise ValueError(f"kernel_size must be odd and >= 1, got {self.kernel_size}")
        if self.engine not in ("auto", "xla", "fourier", "pallas", "pallas_fused"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.precision not in ("highest", "default"):
            raise ValueError(f"unknown precision {self.precision!r}")
        if self.fused_bwd not in ("auto", "on", "off"):
            raise ValueError(f"unknown fused_bwd {self.fused_bwd!r}")
        if self.fused_dx not in ("auto", "on", "off"):
            raise ValueError(f"unknown fused_dx {self.fused_dx!r}")
        if self.fused_gather not in ("auto", "factored", "phi"):
            raise ValueError(f"unknown fused_gather {self.fused_gather!r}")
        if self.engine == "auto":
            object.__setattr__(
                self, "engine",
                "fourier" if self.precision == "default" else "xla")
        if self.sigma_lower_bound > self.sigma_upper_bound:
            raise ValueError(
                f"sigma_lower_bound {self.sigma_lower_bound} exceeds the "
                f"largest sigma the static blur_size={self.blur_size} filter "
                f"supports ({self.sigma_upper_bound}); increase blur_size")

    @property
    def max_offset(self) -> float:
        """Largest representable |mu| (the layer clips to this)."""
        bound = self.kernel_size // 2 - self.component_border_bound
        if self.static_max_offset is not None:
            bound = min(bound, self.static_max_offset)
        return bound

    @property
    def synth_kernel_size(self) -> int:
        """Size of the synthesized aggregation kernel: bilinear taps reach
        floor(max_offset) + 1 in each direction."""
        return 2 * (int(math.floor(self.max_offset)) + 1) + 1

    @property
    def sigma_upper_bound(self) -> float:
        """Largest sigma the static blur filter supports without truncation
        (inverse of the sizing rule 2*ceil(5*sigma)+1 <= blur_size)."""
        return (self.blur_size - 1) / 10.0


def edge_gradient_mask(h: int, w: int, dtype=torch.float32, device=None):
    """Static (h, w) mask zeroing the last row/col per the reference GPU's
    tile rule; applied to the error only under `unit_testing`."""
    zero_row, zero_col = disabled_edges(h, w)
    mask = torch.ones((h, w), dtype=dtype, device=device)
    if zero_col:
        mask[:, w - 1] = 0.0
    if zero_row:
        mask[h - 1, :] = 0.0
    return mask


def _unit_mask(s: int, g: int, f: int, num_ignore: int, dtype, device=None):
    """(S, G, F) mask that zeroes the trailing `num_ignore` dummy units."""
    if num_ignore == 0:
        return None
    gmask = (torch.arange(g, device=device) < g - num_ignore).to(dtype)
    return gmask[None, :, None].expand(s, g, f)


def _squeeze_params(w, mu1, mu2):
    """Accept the [1, S, G, F] or the bare [S, G, F] parameter layout."""
    if w.dim() == 4:
        if w.shape[0] != 1:
            raise ValueError(f"expected leading param dim 1, got {tuple(w.shape)}")
        return w[0], mu1[0], mu2[0], True
    return w, mu1, mu2, False


def _sigma_scalar(cfg: DAUConvSettings, sigma):
    """The layer-shared sigma (first element of the tiled tensor), clipped
    into [sigma_lower_bound, sigma_upper_bound]."""
    value = sigma.reshape(-1)[0]
    return torch.clamp(value, cfg.sigma_lower_bound, cfg.sigma_upper_bound)


def _filters(cfg: DAUConvSettings, sigma_value):
    return gaussian_filters(
        sigma_value,
        size=cfg.blur_size,
        single_dim_kernel=cfg.single_dim_kernel,
        forbid_positive_dim1=cfg.forbid_positive_dim1,
        unit_normalization=cfg.unit_normalization,
        square_unit_normalization=cfg.square_unit_normalization,
        dtype=torch.promote_types(sigma_value.dtype, torch.float32),
    )


def _blur_and_aggregate(cfg: DAUConvSettings, x, sigma_value, w, mu1, mu2,
                        blur_name: str = "w"):
    """Blur + offset-and-sum, dispatched on the engine. 'pallas_fused' runs
    both inside one kernel (K5); 'pallas' blurs with a torch depthwise conv
    and aggregates in K4; 'xla' runs both as dense torch ops."""
    if cfg.engine == "fourier":
        raise NotImplementedError(f"engine='fourier' is not ported yet: {_FOURIER_TODO}")
    filt = _filters(cfg, sigma_value)[blur_name]
    ks, interp = cfg.synth_kernel_size, cfg.use_interpolation
    if cfg.engine == "pallas_fused":
        from ..kernels.forward import dau_forward_fused
        return dau_forward_fused(x.contiguous(), w, mu1, mu2, filt, ks, interp)
    x_blur = depthwise_blur(x, filt)
    if cfg.engine == "pallas":
        from ..kernels.forward import aggregate_forward
        return aggregate_forward(x_blur.contiguous(), w, mu1, mu2, ks, interp)
    return xla_engine.aggregate_forward(x_blur, w, mu1, mu2, ks, interp)


def _forward_impl(cfg: DAUConvSettings, x, w, mu1, mu2, sigma):
    w3, mu13, mu23, _ = _squeeze_params(w, mu1, mu2)
    mask = _unit_mask(*w3.shape, cfg.number_units_ignore, w3.dtype, w3.device)
    if mask is not None:
        w3 = w3 * mask
    return _blur_and_aggregate(cfg, x, _sigma_scalar(cfg, sigma),
                               w3, mu13, mu23)


def dau_conv2d_infer(cfg: DAUConvSettings, x, w, mu1, mu2, sigma, phi=None):
    """Forward-only DAU convolution for serving: the same forward as
    `dau_conv2d_op`, without autograd. `phi` is the Fourier engine's cached
    phase table and needs engine='fourier'."""
    if phi is not None and cfg.engine != "fourier":
        raise ValueError(
            f"phi is a fourier-engine table; engine is {cfg.engine!r}")
    return _forward_impl(cfg, x, w, mu1, mu2, sigma)


def _reduce_to_shape(g, shape):
    """Sum-reduce a full gradient back to a broadcast-origin shape."""
    shape = tuple(shape)
    if tuple(g.shape) == shape:
        return g
    ndiff = g.dim() - len(shape)
    if ndiff > 0:
        g = torch.sum(g, dim=tuple(range(ndiff)))
    axes = tuple(i for i, (gd, sd) in enumerate(zip(g.shape, shape)) if sd != gd)
    if axes:
        g = torch.sum(g, dim=axes, keepdim=True)
    return g.reshape(shape)


def _param_grads(cfg: DAUConvSettings, x, gy, filts, mu13, mu23):
    """(M, S, G, F) unit gradients: blur x with the filters w, dmu1, dmu2
    (and dsigma), build the position table (K6 on the Pallas engines, a
    torch correlation on 'xla') and tap-gather it per unit."""
    if cfg.unit_testing:
        gy = gy * edge_gradient_mask(*gy.shape[-2:], dtype=gy.dtype, device=gy.device)
    names = ["w", "dmu1", "dmu2"] + (["dsigma"] if cfg.compute_sigma_grad else [])
    n, s_ch, h, w_sp = x.shape
    fstack = torch.stack([filts[k] for k in names])  # (M, kb, kb)
    xb = depthwise_blur(x, fstack)  # (N, S*M, H, W)
    xb = xb.reshape(n, s_ch, len(names), h, w_sp).permute(2, 0, 1, 3, 4)  # (M, N, S, H, W)
    ks = cfg.synth_kernel_size
    if cfg.engine in ("pallas", "pallas_fused"):
        from ..kernels.backward import grad_tables
        table = grad_tables(xb, gy, ks).to(xb.dtype)
    else:
        table = xla_engine.grad_tables(xb, gy, ks)
    return xla_engine.tap_gather(table, mu13, mu23, ks, cfg.use_interpolation)


def _bwd_rule(cfg: DAUConvSettings, x, w, mu1, mu2, sigma, gy, needs):
    """The analytic backward of `dau_conv2d_op`: (dx, dw, dmu1, dmu2,
    dsigma), None where `needs` (the input-grad flags of x, w, mu1, mu2,
    sigma) says no gradient is wanted."""
    if cfg.engine == "fourier":
        raise NotImplementedError(f"engine='fourier' is not ported yet: {_FOURIER_TODO}")
    gy = gy.contiguous()
    w3, mu13, mu23, had_lead = _squeeze_params(w, mu1, mu2)
    mask = _unit_mask(*w3.shape, cfg.number_units_ignore, w3.dtype, w3.device)
    w3m = w3 * mask if mask is not None else w3
    sigma_value = _sigma_scalar(cfg, sigma)

    # input gradient: the forward engine on the error, with S<->F
    # transposed params, negated offsets and the mirrored blur filter
    dx = None
    if needs[0]:
        dx = _blur_and_aggregate(
            cfg, gy, sigma_value, w3m.permute(2, 1, 0),
            -mu13.permute(2, 1, 0), -mu23.permute(2, 1, 0),
            blur_name="error").to(x.dtype)
    if not any(needs[1:]):
        return dx, None, None, None, None

    grads = _param_grads(cfg, x, gy, _filters(cfg, sigma_value), mu13, mu23)
    lr = grads.new_full((), cfg.mu_learning_rate_factor)
    dw = grads[0]
    dmu1 = grads[1] * w3m * lr
    dmu2 = grads[2] * w3m * lr
    if cfg.nan_guard_mu_grads:
        # NaN -> 0 on the mu grads only
        dmu1 = clip_nan(dmu1)
        dmu2 = clip_nan(dmu2)
    dsigma_full = grads[3] * w3m if cfg.compute_sigma_grad else torch.zeros_like(w3)
    if mask is not None:
        # dummy units get no gradient; their mu/sigma grads are already
        # zero through the masked w
        dw = dw * mask
    if had_lead:
        dw, dmu1, dmu2, dsigma_full = (a[None] for a in (dw, dmu1, dmu2, dsigma_full))
    dsigma = _reduce_to_shape(dsigma_full, sigma.shape)
    out = (dw.to(w.dtype), dmu1.to(mu1.dtype), dmu2.to(mu2.dtype), dsigma.to(sigma.dtype))
    return (dx, *(g if need else None for g, need in zip(out, needs[1:])))


class _DAUConv2dFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, x, w, mu1, mu2, sigma):
        ctx.cfg = cfg
        ctx.save_for_backward(x, w, mu1, mu2, sigma)
        return _forward_impl(cfg, x, w, mu1, mu2, sigma)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        return (None, *_bwd_rule(ctx.cfg, *ctx.saved_tensors, grad_out,
                                 ctx.needs_input_grad[1:]))


def dau_conv2d_op(cfg: DAUConvSettings, x, w, mu1, mu2, sigma):
    """Displaced Aggregation Unit convolution.

    x: (N, S, H, W), NCHW. w, mu1, mu2: (1, S, G, F) or (S, G, F). sigma:
    the layer-shared Gaussian width, any shape (its first element is used).
    Returns (N, F, H, W).
    """
    return _DAUConv2dFunction.apply(cfg, x, w, mu1, mu2, sigma)
