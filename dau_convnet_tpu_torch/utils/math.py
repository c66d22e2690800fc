"""Elementwise helpers of the DAU backward.

Counterpart of the part of `dau_convnet_tpu/utils/math.py` that the port's
paths use.
"""

from __future__ import annotations

import torch

__all__ = ["clip_nan"]


def clip_nan(x: torch.Tensor) -> torch.Tensor:
    """NaN -> 0; +-inf passes through (unlike `torch.nan_to_num`, which
    maps +-inf to the largest finite values)."""
    return torch.where(torch.isnan(x), torch.zeros((), dtype=x.dtype, device=x.device), x)
