"""DAU-ResNet in PyTorch: residual networks with DAU aggregation layers.

Counterpart of `dau_convnet_tpu/models/resnet.py`: basic blocks whose 3x3
convolutions are DAU layers. The stem is conv 7x7/2 -> max-pool 3/2 with
padding 1 -> `bn_stem` -> ReLU; stride 2 comes from the first DAU layer's
output slicing, and where the shape changes the shortcut is a 1x1 strided
projection plus BatchNorm. The attribute names are flax's (`stem`,
`bn_stem`, `stage{s}_block{b}.dau1/bn1/dau2/bn2/proj/bn_proj`, `head`), so
the JAX package's variables load one to one through
`utils.checkpoint.params_from_flax`. The DAU layers keep their parameters
in `dtype`; the convs, BatchNorms and head keep theirs in f32 and compute
in `dtype`. Train and eval mode follow `module.train()`/`.eval()`. The
`engine` field, which the JAX model lacks (it always takes 'auto'), goes to
every DAU layer. Parameters live on the CUDA card unless the caller names
another device.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import DAUConv2d
from ..nn.norm import BatchNorm
from ._common import Affine

__all__ = ["DAUBasicBlock", "DAUResNet", "RESNET_DAU_DEPTHS"]

# depth name -> blocks per stage
RESNET_DAU_DEPTHS = {
    "18": (2, 2, 2, 2),
    "34": (3, 4, 6, 3),
}


class DAUBasicBlock(nn.Module):
    """dau1 (strided) -> bn1 -> ReLU -> dau2 -> bn2, plus the shortcut
    (proj -> bn_proj where the channels or the stride change), then ReLU.
    BatchNorm momentum 0.1 (flax's 0.9), epsilon 1e-5."""

    def __init__(self, in_channels: int, filters: int, dau_units=(2, 2),
                 max_kernel_size: int = 9, strides: int = 1, engine: str = "auto",
                 dtype: torch.dtype = torch.float32, device=torch.device("cuda"),
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.strides = strides
        dau = dict(use_bias=False, engine=engine, dtype=dtype, device=device,
                   generator=generator)
        self.dau1 = DAUConv2d(in_channels, filters, dau_units, max_kernel_size,
                              strides=strides, **dau)
        self.bn1 = BatchNorm(filters, momentum=0.1, device=device)
        self.dau2 = DAUConv2d(filters, filters, dau_units, max_kernel_size, **dau)
        self.bn2 = BatchNorm(filters, momentum=0.1, device=device)
        if in_channels != filters or strides > 1:
            self.proj = Affine((filters, in_channels, 1, 1), in_channels, device, generator,
                               bias=False)
            self.bn_proj = BatchNorm(filters, momentum=0.1, device=device)
        else:
            self.proj = None

    def forward(self, x):
        y = F.relu(self.bn1(self.dau1(x)))
        y = self.bn2(self.dau2(y))
        residual = x
        if self.proj is not None:
            residual = self.bn_proj(self.proj.conv(x, self.dtype, stride=self.strides))
        return F.relu(y + residual)


class DAUResNet(nn.Module):
    """ResNet-{18,34} with DAU basic blocks. Input NCHW (N, 3, H, W); stage
    s has width * 2**s filters, its first block strided from stage 1 on.
    `bn_stem` has flax's default momentum (0.99, here 0.01) and epsilon
    1e-5."""

    def __init__(self, num_classes: int = 1000, depth: str = "18", width: int = 64,
                 dau_units: tp.Tuple[int, int] = (2, 2), max_kernel_size: int = 9,
                 train: bool = True, engine: str = "auto", dtype: torch.dtype = torch.float32,
                 device=torch.device("cuda"), generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.stem = Affine((width, 3, 7, 7), 3 * 49, device, generator, bias=False)
        self.bn_stem = BatchNorm(width, momentum=0.01, device=device)
        self.blocks = []
        s = width
        for stage, blocks in enumerate(RESNET_DAU_DEPTHS[depth]):
            filters = width * 2 ** stage
            for b in range(blocks):
                name = f"stage{stage}_block{b}"
                setattr(self, name, DAUBasicBlock(
                    s, filters, dau_units, max_kernel_size,
                    strides=2 if (stage > 0 and b == 0) else 1, engine=engine, dtype=dtype,
                    device=device, generator=generator))
                self.blocks.append(name)
                s = filters
        self.head = Affine((num_classes, s), s, device, generator)
        self.train(train)

    def forward(self, x):
        x = self.stem.conv(x, self.dtype, stride=2, padding=3)
        x = F.max_pool2d(x, 3, 2, padding=1)
        x = F.relu(self.bn_stem(x))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.head.dense(x.mean(dim=(2, 3)), self.dtype)
