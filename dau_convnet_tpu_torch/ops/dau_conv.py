"""The DAU convolution primitive, `dau_conv2d_op`, in PyTorch.

Counterpart of `dau_convnet_tpu/ops/dau_conv.py`: the same settings, the
same parameter preparation (dummy-unit mask, sigma clip, filter build) and
the same forward chain. The engines ported so far are 'xla' (depthwise blur
+ dense aggregation) and 'pallas_fused' (the fused CUDA kernel). 'fourier'
(also what 'auto' picks at precision='default') and 'pallas' raise
NotImplementedError until their ROADMAP steps land; they never fall back to
another engine. The backward (training) is not ported yet either.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import torch

from . import xla_engine
from .gaussian import depthwise_blur, gaussian_filters

__all__ = ["DAUConvSettings", "dau_conv2d_op", "dau_conv2d_infer"]

_TODO = {
    "fourier": "ROADMAP.md 'Still to port', step 1 (Fourier forward)",
    "pallas": "ROADMAP.md 'Still to port', step 3 (K4 and K6)",
    "backward": "ROADMAP.md 'Still to port', step 2 (the training step)",
}


@dataclasses.dataclass(frozen=True)
class DAUConvSettings:
    """Static configuration of a DAU convolution; the fields, defaults and
    validation of the JAX `DAUConvSettings`. Fields that steer the Fourier
    engine or the backward are kept so a configuration carries over as it
    is; they take effect when those paths are ported."""

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
    both inside one kernel; 'xla' runs them as two dense torch ops."""
    if cfg.engine in ("fourier", "pallas"):
        raise NotImplementedError(
            f"engine={cfg.engine!r} is not ported yet: {_TODO[cfg.engine]}")
    filt = _filters(cfg, sigma_value)[blur_name]
    if cfg.engine == "pallas_fused":
        from ..kernels.forward import dau_forward_fused
        return dau_forward_fused(x.contiguous(), w, mu1, mu2, filt,
                                 cfg.synth_kernel_size, cfg.use_interpolation)
    x_blur = depthwise_blur(x, filt)
    return xla_engine.aggregate_forward(x_blur, w, mu1, mu2,
                                        cfg.synth_kernel_size,
                                        cfg.use_interpolation)


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


class _DAUConv2dFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, x, w, mu1, mu2, sigma):
        return _forward_impl(cfg, x, w, mu1, mu2, sigma)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            f"the DAU backward is not ported yet: {_TODO['backward']}")


def dau_conv2d_op(cfg: DAUConvSettings, x, w, mu1, mu2, sigma):
    """Displaced Aggregation Unit convolution.

    x: (N, S, H, W), NCHW. w, mu1, mu2: (1, S, G, F) or (S, G, F). sigma:
    the layer-shared Gaussian width, any shape (its first element is used).
    Returns (N, F, H, W).
    """
    return _DAUConv2dFunction.apply(cfg, x, w, mu1, mu2, sigma)
