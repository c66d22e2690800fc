"""Pieces the models share: the f32 weights of their plain conv and dense
layers, cast to the model's dtype per call, as flax's `dtype=` does."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Affine(nn.Module):
    """f32 weight (and bias) of a conv or dense layer, drawn from `generator`
    with the lecun-normal scale 1/sqrt(fan_in); the bias starts at zero."""

    def __init__(self, shape, fan_in, device, generator, bias: bool = True):
        super().__init__()
        gen_device = generator.device if generator is not None else device
        w = torch.randn(shape, generator=generator, device=gen_device) / math.sqrt(fan_in)
        self.weight = nn.Parameter(w.to(device))
        self.bias = nn.Parameter(torch.zeros(shape[0], device=device)) if bias else None

    def dense(self, x, dtype):
        return F.linear(x, self.weight.to(dtype), _cast(self.bias, dtype))

    def conv(self, x, dtype, **kw):
        return F.conv2d(x.to(dtype), self.weight.to(dtype), _cast(self.bias, dtype), **kw)


def _cast(t, dtype):
    return None if t is None else t.to(dtype)
