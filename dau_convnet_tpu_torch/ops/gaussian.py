"""Gaussian blur filters and the depthwise blur, in PyTorch.

Counterpart of `dau_convnet_tpu/ops/gaussian.py`: the layer-shared Gaussian
blur filter, its three analytic derivative filters with the quotient-rule
normalisation corrections, and the zero-padded depthwise blur. Semantics
(grid, normalisation modes, 1e-10 clip) are those of the JAX module.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ._cache import tensor_cache
from ._precision import conv_precision

__all__ = ["blur_kernel_size", "gaussian_filters", "gaussian_factor_filters",
           "rank1_blur", "rank1_blur_stack", "depthwise_blur"]


def blur_kernel_size(sigma: float, min_size: int = 9) -> int:
    """Static blur-filter size, rule 2*ceil(5*sigma)+1 with a floor of
    `min_size` (9 keeps the numpy oracle's fixed 9x9 grid for small sigma)."""
    size = 2 * int(math.ceil(5.0 * float(sigma))) + 1
    size = max(size, min_size)
    if size > 33:
        raise ValueError(
            f"sigma={sigma} requires a {size}x{size} blur filter; max supported is 33x33"
        )
    return size


def gaussian_filters(
    sigma,
    size: int = 9,
    *,
    single_dim_kernel: bool = False,
    forbid_positive_dim1: bool = False,
    unit_normalization: bool = True,
    square_unit_normalization: bool = False,
    dtype=torch.float32,
    device=None,
):
    """The blur filter and its derivative filters, each (size, size).

    Returns a dict with keys ``w`` (normalised blur filter), ``dmu1``,
    ``dmu2``, ``dsigma`` (quotient-rule-corrected derivative filters) and
    ``error`` (the blur filter rotated by 180 degrees). Rows are the y axis,
    columns the x axis; the grid is centred at size//2.
    """
    if isinstance(sigma, torch.Tensor):
        device = sigma.device if device is None else device
        sigma = sigma.to(device=device, dtype=dtype).reshape(())
    else:
        sigma = torch.tensor(float(sigma), dtype=dtype, device=device)
    c = size // 2
    ax = torch.arange(size, dtype=dtype, device=device) - c
    x = ax[None, :].expand(size, size)  # columns
    y = ax[:, None].expand(size, size)  # rows
    r2 = x * x + y * y

    sigma2_inv = 1.0 / (sigma * sigma)
    g = torch.exp(-r2 * (0.5 * sigma2_inv))

    zero = torch.zeros((), dtype=dtype, device=device)
    if single_dim_kernel:
        g = torch.where(y == 0, g, zero)
    if forbid_positive_dim1:
        g = torch.where(x > 0, zero, g)

    d_mu1 = x * sigma2_inv * g
    d_mu2 = y * sigma2_inv * g
    d_sigma = r2 * (sigma2_inv / sigma) * g

    # unit: f = g/sum(g); square: f = g/sum(g^2), corrections 2*sum(g*dm);
    # none: f = g, no correction
    if square_unit_normalization:
        z = torch.sum(g * g)
        s1 = 2.0 * torch.sum(g * d_mu1) / z
        s2 = 2.0 * torch.sum(g * d_mu2) / z
        ss = 2.0 * torch.sum(g * d_sigma) / z
    elif unit_normalization:
        z = torch.sum(g)
        s1 = torch.sum(d_mu1) / z
        s2 = torch.sum(d_mu2) / z
        ss = torch.sum(d_sigma) / z
    else:
        z = torch.ones((), dtype=dtype, device=device)
        s1 = s2 = ss = zero

    # tiny mu sums are zeroed (the reference's clip_eps(1e-10))
    s1 = torch.where(torch.abs(s1) > 1e-10, s1, zero)
    s2 = torch.where(torch.abs(s2) > 1e-10, s2, zero)

    g_n = g / z
    return {
        "w": g_n,
        "dmu1": d_mu1 / z - g_n * s1,
        "dmu2": d_mu2 / z - g_n * s2,
        "dsigma": d_sigma / z - g_n * ss,
        "error": torch.flip(g_n, dims=(0, 1)),
    }


def gaussian_factor_filters(
    sigma,
    size: int = 9,
    *,
    single_dim_kernel: bool = False,
    forbid_positive_dim1: bool = False,
    unit_normalization: bool = True,
    square_unit_normalization: bool = False,
    dtype=torch.float32,
    device=None,
):
    """The filters of `gaussian_filters` as separable rank-1/rank-2 terms.

    Returns ``(vecs, terms)``: ``vecs`` maps vector names to (size,)
    tensors; ``terms`` maps each filter name to a list of ``(row, col)``
    pairs with filter = sum_r vecs[row] (outer) vecs[col] (w, dmu1, dmu2 and
    error rank 1, dsigma rank 2), matching `gaussian_filters` to roundoff.
    """
    if isinstance(sigma, torch.Tensor):
        device = sigma.device if device is None else device
        sigma = sigma.to(device=device, dtype=dtype).reshape(())
    else:
        sigma = torch.tensor(float(sigma), dtype=dtype, device=device)
    c = size // 2
    t = torch.arange(size, dtype=dtype, device=device) - c
    sigma2_inv = 1.0 / (sigma * sigma)
    g1 = torch.exp(-t * t * (0.5 * sigma2_inv))
    zero = torch.zeros((), dtype=dtype, device=device)

    gy = torch.where(t == 0, g1, zero) if single_dim_kernel else g1
    gx = torch.where(t > 0, zero, g1) if forbid_positive_dim1 else g1

    dx1 = t * sigma2_inv * gx
    dy1 = t * sigma2_inv * gy
    sx1 = t * t * (sigma2_inv / sigma) * gx
    sy1 = t * t * (sigma2_inv / sigma) * gy

    zy = torch.sum(gy)
    zx = torch.sum(gx)
    if square_unit_normalization:
        z = torch.sum(gy * gy) * torch.sum(gx * gx)
        s1 = 2.0 * torch.sum(gy * gy) * torch.sum(gx * dx1) / z
        s2 = 2.0 * torch.sum(gy * dy1) * torch.sum(gx * gx) / z
        ss = 2.0 * (torch.sum(gy * sy1) * torch.sum(gx * gx)
                    + torch.sum(gy * gy) * torch.sum(gx * sx1)) / z
    elif unit_normalization:
        z = zy * zx
        s1 = zy * torch.sum(dx1) / z
        s2 = torch.sum(dy1) * zx / z
        ss = (torch.sum(sy1) * zx + zy * torch.sum(sx1)) / z
    else:
        z = torch.ones((), dtype=dtype, device=device)
        s1 = s2 = ss = zero
    s1 = torch.where(torch.abs(s1) > 1e-10, s1, zero)
    s2 = torch.where(torch.abs(s2) > 1e-10, s2, zero)

    gxn = gx / z
    vecs = {
        "gy": gy,
        "gx": gxn,
        "dx": dx1 / z - gxn * s1,
        "dy": dy1 - gy * s2,
        "sy": sy1 - gy * ss,
        "sx": sx1 / z,
        "gy_f": torch.flip(gy, dims=(0,)),
        "gx_f": torch.flip(gxn, dims=(0,)),
    }
    terms = {
        "w": [("gy", "gx")],
        "dmu1": [("gy", "dx")],
        "dmu2": [("dy", "gx")],
        "dsigma": [("sy", "gx"), ("gy", "sx")],
        "error": [("gy_f", "gx_f")],
    }
    return vecs, terms


@tensor_cache
def _band_index(size: int, n: int, device: torch.device):
    """The constant part of `_band_matrix`, cached per device: the clipped
    tap index d = a - b + size//2 and the in-band mask, each (n, n)."""
    idx = torch.arange(n, device=device)
    d = idx[:, None] - idx[None, :] + size // 2
    return d.clamp(0, size - 1), (d >= 0) & (d < size)


def _band_matrix(vec: torch.Tensor, n: int) -> torch.Tensor:
    """(n, n) banded matrix B[a, b] = vec[a - b + c] (zero outside the band):
    x @ B correlates the last axis of x with `vec` under zero padding."""
    d, inband = _band_index(vec.shape[0], n, vec.device)
    return torch.where(inband, vec[d], vec.new_zeros(()))


def rank1_blur(x: torch.Tensor, vecs, term_list) -> torch.Tensor:
    """Correlate NCHW ``x`` with the separable filter sum_r row_r (x) col_r:
    the zero-padded semantics of `depthwise_blur` as two banded matmuls per
    rank-1 term, each in x's dtype (in bf16 the column pass rounds to bf16
    before the row pass, as in JAX). Column passes are shared between terms
    by vector name."""
    return rank1_blur_stack(x, vecs, {"_": term_list}, ["_"])[0]


def rank1_blur_stack(x: torch.Tensor, vecs, terms, names) -> torch.Tensor:
    """Blur ``x`` (N, C, H, W) with each named filter -> (M, N, C, H, W);
    column passes are shared across the M filters."""
    h, w = x.shape[-2:]
    col_cache = {}
    outs = []
    for name in names:
        y = None
        for row_name, col_name in terms[name]:
            if col_name not in col_cache:
                cmat = _band_matrix(vecs[col_name], w).to(x.dtype)
                col_cache[col_name] = torch.matmul(x, cmat)
            rmat = _band_matrix(vecs[row_name], h).to(x.dtype)
            z = torch.matmul(rmat.t(), col_cache[col_name])
            y = z if y is None else y + z
        outs.append(y)
    return torch.stack(outs)


def depthwise_blur(x: torch.Tensor, filt: torch.Tensor,
                   precision: str = "highest") -> torch.Tensor:
    """Correlate every (n, channel) plane of NCHW ``x`` with ``filt`` under
    zero padding kh//2, kw//2. ``filt`` is (kh, kw) for one shared filter,
    -> (N, C, H, W); or (m, kh, kw) for m filters per channel, -> (N, C*m,
    H, W) with the m results of channel c at [c*m, (c+1)*m). The filter is
    cast to x's dtype; precision='highest' runs the convolution with cuDNN's
    TF32 off (`_precision.conv_precision`)."""
    chan = x.shape[1]
    if filt.dim() == 2:
        filt = filt[None]
    m, kh, kw = filt.shape
    rhs = filt.to(x.dtype)[None].expand(chan, m, kh, kw).reshape(chan * m, 1, kh, kw)
    with conv_precision(precision):
        return F.conv2d(x, rhs, padding=(kh // 2, kw // 2), groups=chan)
