"""The DAU convolution primitive, `dau_conv2d_op`, in PyTorch.

Counterpart of `dau_convnet_tpu/ops/dau_conv.py`: the same settings, the
same parameter preparation (dummy-unit mask, sigma clip, filter build), the
same forward chain and the same analytic backward (`_bwd_rule`) for every
engine: 'xla' (depthwise blur + dense aggregation), 'pallas' (depthwise blur
+ the aggregation kernel K4), 'pallas_fused' (the fused blur + aggregation
kernel K5), whose unit gradients come from the grad-table kernel K6, and
'fourier' (separable blur + per-bin spectral contractions, what 'auto'
picks at precision='default'), whose unit gradients come from the fused
spectral kernel where the gate allows it (K1, or K8 under
fused_gather='factored'; either also emits dx under fused_dx='on'), else
from the unfused spectral gather.

Under a device mesh (`dau_conv2d_op(..., mesh=)`) the op runs per shard,
the counterpart of the mesh route of JAX's `_fused_grads_call`: x holds
this rank's rows, the parameters this rank's F-slice, and the backward
closes dx over the model axis.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import typing as tp

import torch

from ..parallel import _collectives
from ..parallel.mesh import axis_size
from ..utils import tracing
from ..utils.math import clip_nan
from . import fourier_engine, xla_engine
from ._edge import disabled_edges
from .gaussian import (depthwise_blur, gaussian_factor_filters, gaussian_filters,
                       rank1_blur, rank1_blur_stack)

__all__ = ["DAUConvSettings", "dau_conv2d_op", "dau_conv2d_infer", "precompute_phi",
           "edge_gradient_mask"]

_log = logging.getLogger(__name__)

# Calibration point of fused_gather='auto': the factored gather (K8) at or
# above this many frequency bins, the phi gather (K1) below. None, as in the
# JAX package: 'auto' resolves to phi at every bin count, and 'factored' is
# an explicit opt-in. Its value on the H100 is not measured (ROADMAP.md).
FACTORED_MIN_BINS = None


@dataclasses.dataclass(frozen=True)
class DAUConvSettings:
    """Static configuration of a DAU convolution; the fields, defaults and
    validation of the JAX `DAUConvSettings`. `data_axis`/`model_axis` name
    the mesh axes of `dau_conv2d_op(..., mesh=)`."""

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


def _factor_filters(cfg: DAUConvSettings, sigma_value):
    """Separable 1D factorization of the blur filters."""
    return gaussian_factor_filters(
        sigma_value,
        size=cfg.blur_size,
        single_dim_kernel=cfg.single_dim_kernel,
        forbid_positive_dim1=cfg.forbid_positive_dim1,
        unit_normalization=cfg.unit_normalization,
        square_unit_normalization=cfg.square_unit_normalization,
        dtype=torch.promote_types(sigma_value.dtype, torch.float32),
    )


def _build_phi(cfg: DAUConvSettings, spatial, w3m, mu13, mu23):
    """Bin-major spectral phase table shared by the fourier forward and dx
    passes, from the integer cos/sin tables."""
    h, wd = spatial
    p1, p2, rb = fourier_engine.plan_bins(h, wd, cfg.synth_kernel_size)
    return fourier_engine.build_phi(w3m, mu13, mu23, p1, p2, rb, cfg.use_interpolation,
                                    phase_span=cfg.synth_kernel_size // 2 + 1)


def _blur(cfg: DAUConvSettings, x, sigma_value, name: str):
    """Engine-dispatched blur: the separable banded-matmul form for
    'fourier' (same zero-pad semantics), the depthwise conv otherwise."""
    if cfg.engine == "fourier":
        vecs, terms = _factor_filters(cfg, sigma_value)
        return rank1_blur(x, vecs, terms[name])
    return depthwise_blur(x, _filters(cfg, sigma_value)[name], precision=cfg.precision)


def _aggregate(cfg: DAUConvSettings, x_blur, w, mu1, mu2, phi=None):
    ks, interp = cfg.synth_kernel_size, cfg.use_interpolation
    if cfg.engine in ("pallas", "pallas_fused"):
        from ..kernels.forward import aggregate_forward
        return aggregate_forward(x_blur.contiguous(), w, mu1, mu2, ks, interp)
    if cfg.engine == "fourier":
        return fourier_engine.fourier_forward(x_blur, w, mu1, mu2, ks, interp, phi=phi)
    return xla_engine.aggregate_forward(x_blur, w, mu1, mu2, ks, interp,
                                        precision=cfg.precision)


def _blur_and_aggregate(cfg: DAUConvSettings, x, sigma_value, w, mu1, mu2,
                        phi=None, blur_name: str = "w"):
    """Blur + offset-and-sum, dispatched on the engine. 'pallas_fused' runs
    both inside one kernel (K5); 'pallas' blurs with a torch depthwise conv
    and aggregates in K4; 'fourier' blurs with banded matmuls and
    aggregates per frequency bin; 'xla' runs both as dense torch ops."""
    if cfg.engine == "pallas_fused":
        from ..kernels.forward import dau_forward_fused
        filt = _filters(cfg, sigma_value)[blur_name]
        return dau_forward_fused(x.contiguous(), w, mu1, mu2, filt, cfg.synth_kernel_size,
                                 cfg.use_interpolation)
    return _aggregate(cfg, _blur(cfg, x, sigma_value, blur_name), w, mu1, mu2, phi=phi)


def _masked_units(cfg: DAUConvSettings, w, mu1, mu2):
    """(w3 with the dummy units zeroed, mu13, mu23, had_lead, mask)."""
    w3, mu13, mu23, had_lead = _squeeze_params(w, mu1, mu2)
    mask = _unit_mask(*w3.shape, cfg.number_units_ignore, w3.dtype, w3.device)
    return (w3 * mask if mask is not None else w3), mu13, mu23, had_lead, mask


def _forward_impl(cfg: DAUConvSettings, x, w, mu1, mu2, sigma, phi=None):
    w3, mu13, mu23, _, _ = _masked_units(cfg, w, mu1, mu2)
    if phi is None and cfg.engine == "fourier":
        phi = _build_phi(cfg, x.shape[-2:], w3.to(x.dtype), mu13, mu23)
    return _blur_and_aggregate(cfg, x, _sigma_scalar(cfg, sigma), w3, mu13, mu23, phi=phi)


def precompute_phi(cfg: DAUConvSettings, spatial, w, mu1, mu2, dtype=None):
    """Prebuild the fourier engine's phase table for frozen parameters, for
    `dau_conv2d_infer(..., phi=...)`. spatial: (H, W) of the inputs to
    serve; w, mu1, mu2: (1, S, G, F) or (S, G, F); dtype: the table's dtype
    (the serving input's), default w's. Returns (phire, phiim)."""
    if cfg.engine != "fourier":
        raise ValueError(f"precompute_phi requires engine='fourier', got {cfg.engine!r}")
    w3, mu13, mu23, _, _ = _masked_units(cfg, w, mu1, mu2)
    return _build_phi(cfg, tuple(spatial), w3.to(w3.dtype if dtype is None else dtype),
                      mu13, mu23)


def dau_conv2d_infer(cfg: DAUConvSettings, x, w, mu1, mu2, sigma, phi=None):
    """Forward-only DAU convolution for serving: the same forward as
    `dau_conv2d_op`, without autograd. `phi` is a table from
    `precompute_phi`, built for x's spatial shape and dtype (engine
    'fourier' only)."""
    if phi is not None and cfg.engine != "fourier":
        raise ValueError(
            f"phi is a fourier-engine table; engine is {cfg.engine!r}")
    return _forward_impl(cfg, x, w, mu1, mu2, sigma, phi=phi)


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


def _resolve_gather(cfg: DAUConvSettings, bins: int) -> str:
    """The fused backward's gather form for fused_gather and the bin count."""
    if cfg.fused_gather != "auto":
        return cfg.fused_gather
    if FACTORED_MIN_BINS is not None and bins >= FACTORED_MIN_BINS:
        return "factored"
    return "phi"


def _fused_route(cfg: DAUConvSettings, xb, g: int, bins: int) -> tp.Optional[str]:
    """The fused kernel's gather ('phi': K1/K2, 'factored': K8), or None for
    the unfused spectral gather. The JAX gate: forced by fused_bwd='on', or
    under 'auto' on a CUDA tensor where the factored gather is asked for, or
    for the phi gather at B <= 256 bins or G >= 4; either way only where the
    kernel has a plan (decided before the call, as JAX's FusedPlanError)."""
    from ..kernels.fused_bwd import factored_plan, spectral_plan
    gather = _resolve_gather(cfg, bins)
    if cfg.fused_bwd == "off":
        return None
    if cfg.fused_bwd == "auto" and not (
            xb.is_cuda and (gather != "phi" or bins <= 256 or g >= 4)):
        return None
    m, _, _, h, w_sp = xb.shape
    p1, _, rb = fourier_engine.plan_bins(h, w_sp, cfg.synth_kernel_size)
    nj = 2 * (cfg.synth_kernel_size // 2 + 1) + 2
    plan = factored_plan if gather == "factored" else spectral_plan
    return gather if plan(m=m, g=g, nj=nj, p1b=p1, rbb=rb) is not None else None


def _launch_counts() -> tp.Dict[str, int]:
    """The launch counters of the unit gradients' kernels, by kernel (the
    package's list: `kernels.LAUNCH_COUNTERS`)."""
    from ..kernels import launch_counts
    return launch_counts(("k1", "k2", "k8", "k8_dx", "k6"))


def _fourier_unit_grads(cfg: DAUConvSettings, xb, gy, gy_p, sigma_value, w3m, mu13, mu23,
                        gather: tp.Optional[str], with_dx: bool):
    """The fourier engine's (unit gradients, dx or None) by `gather` (None:
    the unfused spectral gather)."""
    ks = cfg.synth_kernel_size
    if gather is None:
        return fourier_engine.fourier_unit_grads(
            xb, gy_p, mu13, mu23, ks, cfg.use_interpolation, precision=cfg.precision), None
    if not with_dx:
        return fourier_engine.fourier_unit_grads_fused2(
            xb, gy_p, mu13, mu23, ks, cfg.use_interpolation, gather=gather), None
    # dx from the same kernel call as the unit gradients (K2, or K8 with dx)
    gy_blur = _blur(cfg, gy, sigma_value, "error")
    return fourier_engine.fourier_unit_grads_fused2(
        xb, gy_p, mu13, mu23, ks, cfg.use_interpolation, err_blur=gy_blur,
        w_units=w3m.to(xb.dtype), gather=gather)


def _param_grads(cfg: DAUConvSettings, x, gy, sigma_value, w3m, mu13, mu23, dx_fused: bool):
    """(M, S, G, F) unit gradients, and dx when the fused kernel emitted it
    (else None). Blur x with the filters w, dmu1, dmu2 (and dsigma); the
    Pallas engines read the gradients out of K6's position table, 'xla' out
    of the dense table, 'fourier' out of the cross-spectra (K1/K2 or the
    unfused spectral gather).

    Spans: `dau.blur_stack`, then `dau.unit_grads` with the route taken
    ('phi', 'factored', 'unfused' or 'tables'), whether dx came with it,
    the frequency bins, the shapes it was decided on (N, S, H, W, F) and
    each launch counter's delta."""
    gy_p = gy
    if cfg.unit_testing:
        gy_p = gy * edge_gradient_mask(*gy.shape[-2:], dtype=gy.dtype, device=gy.device)
    names = ["w", "dmu1", "dmu2"] + (["dsigma"] if cfg.compute_sigma_grad else [])
    n, s_ch, h, w_sp = x.shape
    ks = cfg.synth_kernel_size
    if cfg.engine == "fourier":
        vecs, fterms = _factor_filters(cfg, sigma_value)
        with tracing.span("dau.blur_stack"):
            xb = rank1_blur_stack(x, vecs, fterms, names)  # (M, N, S, H, W)
        with tracing.span("dau.unit_grads") as sp:
            before = _launch_counts() if sp else None
            p1, _, rb = fourier_engine.plan_bins(h, w_sp, ks)
            gather = _fused_route(cfg, xb, w3m.shape[1], p1 * rb)
            with_dx = gather is not None and dx_fused and cfg.fused_dx == "on"
            grads, dx = _fourier_unit_grads(cfg, xb, gy, gy_p, sigma_value, w3m, mu13, mu23,
                                            gather, with_dx)
            if sp:
                sp.set(route=gather or "unfused", dx_fused=with_dx, bins=p1 * rb, N=n, S=s_ch,
                       H=h, W=w_sp, F=w3m.shape[2],
                       **{k: v - before[k] for k, v in _launch_counts().items()})
        return grads, (None if dx is None else dx.to(x.dtype))
    with tracing.span("dau.blur_stack"):
        fstack = torch.stack([_filters(cfg, sigma_value)[k] for k in names])  # (M, kb, kb)
        xb = depthwise_blur(x, fstack, precision=cfg.precision)  # (N, S*M, H, W)
        xb = xb.reshape(n, s_ch, len(names), h, w_sp).permute(2, 0, 1, 3, 4)  # (M, N, S, H, W)
    with tracing.span("dau.unit_grads") as sp:
        before = _launch_counts() if sp else None
        if cfg.engine in ("pallas", "pallas_fused"):
            from ..kernels.backward import grad_tables
            table = grad_tables(xb, gy_p, ks).to(xb.dtype)
        else:
            table = xla_engine.grad_tables(xb, gy_p, ks, precision=cfg.precision)
        grads = xla_engine.tap_gather(table, mu13, mu23, ks, cfg.use_interpolation)
        if sp:
            sp.set(route="tables", dx_fused=False, bins=0, N=n, S=s_ch, H=h, W=w_sp,
                   F=w3m.shape[2], **{k: v - before[k] for k, v in _launch_counts().items()})
    return grads, None


def _bwd_rule(cfg: DAUConvSettings, x, w, mu1, mu2, sigma, gy, needs, phi=None):
    """The analytic backward of `dau_conv2d_op`: (dx, dw, dmu1, dmu2,
    dsigma), None where `needs` (the input-grad flags of x, w, mu1, mu2,
    sigma) says no gradient is wanted. `phi` is the forward's phase table
    (engine 'fourier'; rebuilt here when None)."""
    gy = gy.contiguous()
    w3m, mu13, mu23, had_lead, mask = _masked_units(cfg, w, mu1, mu2)
    sigma_value = _sigma_scalar(cfg, sigma)
    if cfg.engine == "fourier" and phi is None:
        with tracing.span("dau.phi"):
            phi = _build_phi(cfg, x.shape[-2:], w3m.to(x.dtype), mu13, mu23)
    # the fourier engine takes dx from the forward's Phi conjugated (with
    # interpolation only: the floor tap of interp-off does not mirror)
    fourier_dx = cfg.engine == "fourier" and cfg.use_interpolation

    dx = grads = None
    if any(needs[1:]):
        grads, dx = _param_grads(cfg, x, gy, sigma_value, w3m, mu13, mu23,
                                 dx_fused=needs[0] and fourier_dx)
    if needs[0] and dx is None:
        with tracing.span("dau.input_grad"):
            if fourier_dx:
                dx = fourier_engine.fourier_input_grad(
                    _blur(cfg, gy, sigma_value, "error"), phi, cfg.synth_kernel_size)
            else:
                # the forward engine on the error, with S<->F transposed
                # params, negated offsets and the mirrored blur filter
                dx = _blur_and_aggregate(
                    cfg, gy, sigma_value, w3m.permute(2, 1, 0),
                    -mu13.permute(2, 1, 0), -mu23.permute(2, 1, 0), blur_name="error")
            dx = dx.to(x.dtype)
    if grads is None:
        return dx, None, None, None, None

    lr = grads.new_full((), cfg.mu_learning_rate_factor)
    dw = grads[0]
    dmu1 = grads[1] * w3m * lr
    dmu2 = grads[2] * w3m * lr
    if cfg.nan_guard_mu_grads:
        # NaN -> 0 on the mu grads only
        dmu1 = clip_nan(dmu1)
        dmu2 = clip_nan(dmu2)
    w3 = w[0] if had_lead else w
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
        phi = None
        if cfg.engine == "fourier":
            # one phase table for the forward and the backward's dx
            # (remat_phi: rebuilt in the backward instead of kept)
            w3, mu13, mu23, _, _ = _masked_units(cfg, w, mu1, mu2)
            with tracing.span("dau.phi"):
                phi = _build_phi(cfg, x.shape[-2:], w3.to(x.dtype), mu13, mu23)
        ctx.cfg = cfg
        ctx.phi = None if cfg.remat_phi else phi
        ctx.layer = tracing.enclosing("layer")  # the layer's name, for its backward's span
        ctx.save_for_backward(x, w, mu1, mu2, sigma)
        return _forward_impl(cfg, x, w, mu1, mu2, sigma, phi=phi)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        with tracing.span("dau.backward") as sp:
            if sp:
                sp.set(layer=ctx.layer)
            grads = _bwd_rule(ctx.cfg, *ctx.saved_tensors, grad_out, ctx.needs_input_grad[1:],
                              phi=ctx.phi)
        ctx.phi = None
        return (None, *grads)


def dau_conv2d_op(cfg: DAUConvSettings, x, w, mu1, mu2, sigma, mesh=None):
    """Displaced Aggregation Unit convolution.

    x: (N, S, H, W), NCHW. w, mu1, mu2: (1, S, G, F) or (S, G, F). sigma:
    the layer-shared Gaussian width, any shape (its first element is used).
    Returns (N, F, H, W).

    mesh: a `DeviceMesh` (`parallel.make_mesh`) the call is sharded over,
    JAX's ambient mesh. x holds this rank's rows along `cfg.data_axis`, w,
    mu1, mu2 and sigma this rank's F-slice along `cfg.model_axis`, and the
    output is this rank's (rows, F-slice). Per shard the op runs as on one
    device, its backward route decided on the shard's own N and F. x enters
    through `copy_to_model`, so the partial dx of this F-slice is summed
    over the model axis: JAX's psum that closes dx. The unit gradients stay
    F-sharded, with no collective; they are partial sums over this rank's
    rows, and JAX's in-op psum over the data axis is the train step's
    all-reduce of the gradients here. A sigma replicated over the model
    axis must come through `copy_to_model` before it is tiled to the
    F-slice (as `DAUConv2d` does), so that its gradient, a sum over every
    unit, is summed over the axis too.
    """
    if mesh is not None:
        da, ma = (a if axis_size(mesh, a) > 1 else None
                  for a in (cfg.data_axis, cfg.model_axis))
        _log.info("sharded axes: data=%s model=%s", da, ma)
        if ma is not None:
            x = _collectives.copy_to_model(x, mesh.get_group(ma))
    return _DAUConv2dFunction.apply(cfg, x, w, mu1, mu2, sigma)
