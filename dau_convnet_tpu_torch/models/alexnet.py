"""AlexNet-DAU in PyTorch: AlexNet with DAU conv2-conv5.

Counterpart of `dau_convnet_tpu/models/alexnet.py`. conv1 is a standard
11x11 stride-4 VALID convolution, conv2-conv5 are `DAUConv2d` layers, the
max-pools are 3/2 VALID, the flatten is in NCHW order and fc6-fc8 are dense
layers. As in flax, conv1 and the dense layers keep their parameters in f32
and cast them to `dtype` per call; the DAU layers create theirs in `dtype`.
Parameters live on the CUDA card unless the caller names another device.
The fused_* fields and phi_caching (serving only) go to every DAU layer.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import DAUConv2d
from ._common import Affine

__all__ = ["AlexNetDAU", "ALEXNET_DAU_VARIANTS"]

# variant name -> dau_units per layer (G = prod(units))
ALEXNET_DAU_VARIANTS = {
    "small": (1, 1),
    "default": (2, 1),
    "large": (2, 2),
}

_DAU_LAYERS = (("dau_conv2", 96, 256, True),
               ("dau_conv3", 256, 384, False),
               ("dau_conv4", 384, 384, False),
               ("dau_conv5", 384, 256, True))


def _max_pool_nchw(x, window=3, stride=2):
    return F.max_pool2d(x, window, stride)


def _pooled(size: int) -> int:
    return (size - 3) // 2 + 1


class AlexNetDAU(nn.Module):
    """AlexNet with DAU conv2-conv5. Input NCHW (N, 3, image_size, image_size);
    `image_size` fixes fc6's width (227 -> 256*6*6)."""

    def __init__(self, num_classes: int = 1000, variant: str = "default",
                 max_kernel_size: int = 9,
                 static_max_offset: tp.Optional[float] = None,
                 engine: str = "auto", fused_bwd: str = "auto",
                 fused_dx: str = "auto", fused_gather: str = "phi",
                 phi_caching: bool = False, dtype: torch.dtype = torch.float32,
                 image_size: int = 227, device=torch.device("cuda"),
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.dau_units = units = ALEXNET_DAU_VARIANTS[variant]
        self.conv1 = Affine((96, 3, 11, 11), 3 * 11 * 11, device, generator)
        for name, s, f, _ in _DAU_LAYERS:
            setattr(self, name, DAUConv2d(
                s, f, units, max_kernel_size, static_max_offset=static_max_offset,
                engine=engine, fused_bwd=fused_bwd, fused_dx=fused_dx,
                fused_gather=fused_gather, phi_caching=phi_caching, activation=F.relu,
                dtype=dtype, device=device, generator=generator))
        side = _pooled(_pooled(_pooled((image_size - 11) // 4 + 1)))
        fc_in = 256 * side * side
        self.fc6 = Affine((4096, fc_in), fc_in, device, generator)
        self.fc7 = Affine((4096, 4096), 4096, device, generator)
        self.fc8 = Affine((num_classes, 4096), 4096, device, generator)

    def num_dau_units(self, in_channels=(96, 256, 384, 384)) -> int:
        """DAU units of conv2-conv5: sum of S*G*F (G before the rounding to
        groups of 2), the published budgets 0.3M/0.7M/1.5M for the
        variants small/default/large."""
        g = self.dau_units[0] * self.dau_units[1]
        outs = (256, 384, 384, 256)
        return sum(s * g * f for s, f in zip(in_channels, outs))

    def forward(self, x):
        dt = self.dtype
        x = _max_pool_nchw(F.relu(self.conv1.conv(x, dt, stride=4)))
        for name, _, _, pool in _DAU_LAYERS:
            x = getattr(self, name)(x)
            if pool:
                x = _max_pool_nchw(x)
        x = x.reshape(x.shape[0], -1)
        x = F.relu(self.fc6.dense(x, dt))
        x = F.relu(self.fc7.dense(x, dt))
        return self.fc8.dense(x, dt)
