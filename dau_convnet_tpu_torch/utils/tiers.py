"""Kernel-tier selection between steps, in place of the reference's per-call dispatch.

Counterpart of `dau_convnet_tpu/utils/tiers.py`. The reference picks a
CUDA kernel tier at every op call by reading max|mu| back from the device
(`caffe_gpu_amax` -> snap the kernel to {9, 17, 33, 65},
dau_conv_op.cpp:223-256 and dau_conv_forward.cpp:147-159). Here, as in the
JAX package, the tier is a setting of the layer
(`DAUConvSettings.static_max_offset`): callers who know their offsets are
bounded pick it when they build the model, and rebuild it between epochs
if the offsets grow (`tier_for_params` on the parameters' values).
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch

__all__ = ["KERNEL_TIERS", "snap_kernel_tier", "tier_for_params", "max_offset_in_tree",
           "tier_for_tree", "retier_offset", "MAX_SUPPORTED_OFFSET"]

# same tiers as the reference CUDA engine (dau_conv_forward.cpp:147-159)
KERNEL_TIERS = (9, 17, 33, 65)

# reference hard limit: offsets beyond 32 px are unsupported
# (dau_conv_forward.cpp:156-158)
MAX_SUPPORTED_OFFSET = 32.0


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def snap_kernel_tier(max_offset: float) -> int:
    """Smallest tier whose kernel covers the given absolute offset bound
    (reference rule: kernel >= 2*offset + 1, dau_conv_forward.cpp:163-164)."""
    if max_offset > MAX_SUPPORTED_OFFSET:
        raise ValueError(
            f"max offset {max_offset} exceeds the supported bound "
            f"{MAX_SUPPORTED_OFFSET} (reference tier limit)")
    need = 2 * int(math.ceil(max_offset)) + 1
    for tier in KERNEL_TIERS:
        if tier >= need:
            return tier
    return KERNEL_TIERS[-1]


def tier_for_params(mu1, mu2) -> int:
    """Tier for the values of mu1 and mu2 (tensors on any device, or
    arrays): the reference's amax dispatch, evaluated between steps."""
    bound = float(max(np.abs(_host(mu1)).max(), np.abs(_host(mu2)).max()))
    return snap_kernel_tier(bound)


def max_offset_in_tree(params: tp.Union[torch.nn.Module, tp.Mapping[str, tp.Any]]) -> float:
    """max |mu| over every mu1/mu2 parameter of a model (its
    `named_parameters()`) or a state dict (names to tensors).

    Host-side companion of the reference's per-step `caffe_gpu_amax`
    readback (dau_conv_op.cpp:224-236) for whole-model re-tiering: call it
    between steps, then rebuild the model with
    `static_max_offset=math.ceil(result)` (or `snap_kernel_tier`) when the
    tier changed. Tensors are reduced on their device."""
    items = params.named_parameters() if isinstance(params, torch.nn.Module) else params.items()
    worst = 0.0
    with torch.no_grad():
        for name, leaf in items:
            if name.rsplit(".", 1)[-1] in ("mu1", "mu2"):
                worst = max(worst, float(abs(leaf).max()))
    return worst


def tier_for_tree(params) -> int:
    """Kernel tier covering every DAU layer of a model or state dict."""
    return snap_kernel_tier(max_offset_in_tree(params))


def retier_offset(live: float, current: float, kernel_size: int,
                  slack: float = 0.5):
    """Between-steps re-tier policy: the host-side replacement for the
    reference's per-step amax dispatch (dau_conv_op.cpp:223-256), both
    directions.

    `live` is max|mu| over the parameters, `current` the model's
    static_max_offset. Returns the new static_max_offset when the model
    should be rebuilt, else None:

    - GROW immediately when live exceeds the current promise (correctness:
      the op clips |mu| to the static bound, so exceeding it silently
      saturates positions).
    - SHRINK only when the snapped bound ceil(live + slack) drops below the
      current one (a speed optimization: a smaller synthesized aggregation
      kernel, fewer Fourier bins). The +slack inside the ceil gives ~1.5 px
      of hysteresis against drift flapping between two adjacent bounds.
    """
    cap = kernel_size // 2
    snapped = float(min(math.ceil(live + slack), cap))
    if snapped != current and (live > current or snapped < current):
        return snapped
    return None
