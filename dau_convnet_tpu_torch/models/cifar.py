"""The 3-layer CIFAR nets in PyTorch: `DAUCifarNet` and its plain-conv
control `ConvCifarNet`.

Counterpart of `dau_convnet_tpu/models/cifar.py`. Three layers of 96, 96
and 192 filters, each conv -> BatchNorm -> ReLU -> 2x2 max-pool, then a
dense layer on the NCHW flatten. The attribute names are flax's module
names (`dau_conv1..3` or `conv1..3`, `BatchNorm_0..2`, `fc4`), so the JAX
package's variables and npz artifacts load one to one through
`utils.checkpoint.params_from_flax`. The DAU layers have no bias and
xavier-normal weights and keep their parameters in `dtype`; the convs, the
BatchNorms and fc4 keep theirs in f32 and compute in `dtype`. Train and
eval mode follow `module.train()`/`.eval()`; `train=` sets the mode the
model starts in. Parameters live on the CUDA card unless the caller names
another device.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import DAUConv2d, xavier_normal
from ..nn.norm import BatchNorm
from ._common import Affine

__all__ = ["DAUCifarNet", "ConvCifarNet"]

_FILTERS = (96, 96, 192)


def _max_pool_nchw(x, window=2, stride=2):
    return F.max_pool2d(x, window, stride)


class _CifarNet(nn.Module):
    """The shared topology: `_conv(i)` is layer i's convolution."""

    def __init__(self, num_classes, train, bn_momentum, image_size, dtype, device, generator):
        super().__init__()
        self.dtype = dtype
        for i, f in enumerate(_FILTERS):
            setattr(self, f"BatchNorm_{i}", BatchNorm(f, momentum=bn_momentum, eps=1e-3,
                                                      device=device))
        fc_in = _FILTERS[-1] * (image_size // 8) ** 2
        self.fc4 = Affine((num_classes, fc_in), fc_in, device, generator)
        self.train(train)

    def forward(self, x):
        x = x.to(self.dtype)
        for i in range(len(_FILTERS)):
            x = self._conv(i, x)
            x = F.relu(getattr(self, f"BatchNorm_{i}")(x))
            x = _max_pool_nchw(x)
        return self.fc4.dense(x.reshape(x.shape[0], -1), self.dtype)


class DAUCifarNet(_CifarNet):
    """dau_conv1(96) -> pool -> dau_conv2(96) -> pool -> dau_conv3(192) ->
    pool -> fc4(num_classes). Input NCHW (N, 3, image_size, image_size).

    bn_momentum is PyTorch's (1 minus flax's): the default 1e-4 is the JAX
    model's 0.9999, the reference example's, whose running statistics have
    a horizon of ~10k steps; short runs must raise it. BatchNorm epsilon is
    1e-3. engine, dau_sigma_trainable (sigma learned, its blur filter
    sized for sigma up to 1.6), static_max_offset and mu_learning_rate_factor
    go to every DAU layer.
    """

    def __init__(self, num_classes: int = 10, train: bool = True,
                 dau_units: tp.Tuple[int, int] = (2, 2), max_kernel_size: int = 9,
                 static_max_offset: tp.Optional[float] = None,
                 mu_learning_rate_factor: float = 500.0, bn_momentum: float = 1e-4,
                 dau_sigma_trainable: bool = False, engine: str = "auto",
                 dtype: torch.dtype = torch.float32, image_size: int = 32,
                 device=torch.device("cuda"), generator: tp.Optional[torch.Generator] = None):
        super().__init__(num_classes, train, bn_momentum, image_size, dtype, device, generator)
        s = 3
        for i, f in enumerate(_FILTERS):
            setattr(self, f"dau_conv{i + 1}", DAUConv2d(
                s, f, dau_units, max_kernel_size, use_bias=False,
                weight_initializer=xavier_normal(), static_max_offset=static_max_offset,
                mu_learning_rate_factor=mu_learning_rate_factor,
                dau_sigma_trainable=dau_sigma_trainable, engine=engine, dtype=dtype,
                device=device, generator=generator))
            s = f

    def _conv(self, i, x):
        return getattr(self, f"dau_conv{i + 1}")(x)


class ConvCifarNet(_CifarNet):
    """Plain-conv control for `DAUCifarNet`: the same topology with 3x3
    SAME convolutions without bias in place of the DAU layers."""

    def __init__(self, num_classes: int = 10, train: bool = True, bn_momentum: float = 1e-4,
                 dtype: torch.dtype = torch.float32, image_size: int = 32,
                 device=torch.device("cuda"), generator: tp.Optional[torch.Generator] = None):
        super().__init__(num_classes, train, bn_momentum, image_size, dtype, device, generator)
        s = 3
        for i, f in enumerate(_FILTERS):
            setattr(self, f"conv{i + 1}", Affine((f, s, 3, 3), 9 * s, device, generator,
                                                 bias=False))
            s = f

    def _conv(self, i, x):
        return getattr(self, f"conv{i + 1}").conv(x, self.dtype, padding=1)
