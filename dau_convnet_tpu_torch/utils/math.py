"""Elementwise and host-side helpers.

Counterpart of `dau_convnet_tpu/utils/math.py`: the reference's
`caffe_gpu_*` math shims under their reference names, each a line of torch,
and the host-side parameter check `validate_dau_params`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["clip_lower", "clip_upper", "clip_eps", "clip_nan", "pad2d", "amax",
           "segmented_sum", "im2col", "validate_dau_params"]


def clip_lower(x: torch.Tensor, lower) -> torch.Tensor:
    """max(x, lower) elementwise."""
    return torch.clamp_min(x, lower)


def clip_upper(x: torch.Tensor, upper) -> torch.Tensor:
    """min(x, upper) elementwise."""
    return torch.clamp_max(x, upper)


def clip_eps(x: torch.Tensor, eps) -> torch.Tensor:
    """Zero the values with |x| <= eps."""
    return torch.where(x.abs() > eps, x, torch.zeros((), dtype=x.dtype, device=x.device))


def clip_nan(x: torch.Tensor) -> torch.Tensor:
    """NaN -> 0; +-inf passes through (unlike `torch.nan_to_num`, which
    maps +-inf to the largest finite values)."""
    return torch.where(torch.isnan(x), torch.zeros((), dtype=x.dtype, device=x.device), x)


def pad2d(x: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    """Pad the trailing two (spatial) dims by `pad` on each side."""
    return F.pad(x, (pad, pad, pad, pad), value=value)


def amax(x: torch.Tensor) -> torch.Tensor:
    """max |x|."""
    return x.abs().max()


def segmented_sum(x: torch.Tensor, segment_size: int) -> torch.Tensor:
    """Sums over contiguous segments of the flattened input."""
    return x.reshape(-1, segment_size).sum(dim=-1)


def im2col(x: torch.Tensor, kh: int, kw: int, pad: int = 0, stride: int = 1) -> torch.Tensor:
    """Caffe-style im2col of a (C, H, W) plane -> (C*kh*kw, out_h*out_w),
    rows ordered (c, i, j)."""
    return F.unfold(x[None], (kh, kw), padding=pad, stride=stride)[0]


def validate_dau_params(w, mu1, mu2, sigma, *, kernel_size: int,
                        component_border_bound: float = 0.01,
                        sigma_lower_bound: float = 0.3) -> None:
    """Host-side parameter sanity check between steps: NaN in mu, an offset
    past the kernel bound, or sigma below its lower bound raise ValueError.
    Takes tensors (on any device) or arrays; reads them on the host."""
    def host(t):
        return (t.detach().float().cpu().numpy() if torch.is_tensor(t)
                else np.asarray(t))

    mu1, mu2 = host(mu1), host(mu2)
    if np.isnan(mu1).any() or np.isnan(mu2).any():
        raise ValueError("NaN in mu1/mu2 - diverged training?")
    bound = kernel_size // 2 - component_border_bound
    worst = max(np.abs(mu1).max(), np.abs(mu2).max())
    if worst > bound + 1e-6:
        raise ValueError(
            f"max |mu| = {worst:.3f} exceeds the kernel bound {bound:.3f}; "
            "clip offsets (the DAUConv2d layer does this automatically)")
    sig = float(np.reshape(host(sigma), (-1,))[0])
    if not np.isfinite(sig) or sig < sigma_lower_bound:
        raise ValueError(f"sigma {sig} below lower bound {sigma_lower_bound}")
