"""Pieces the models share: the f32 weights of their plain conv and dense
layers, cast to the model's dtype per call, as flax's `dtype=` does."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import _collectives


class Affine(nn.Module):
    """f32 weight (and bias) of a conv or dense layer, drawn from `generator`
    with the lecun-normal scale 1/sqrt(fan_in); the bias starts at zero.

    `mesh` (set by `parallel.init_sharded`, None otherwise) is the device
    mesh the layer is sharded over. Where the weight holds a slice of the
    output features (dim 0), the layer is column-parallel: its input enters
    through `copy_to_model`, it computes this rank's outputs, and they are
    all-gathered over the model axis."""

    mesh = None

    def __init__(self, shape, fan_in, device, generator, bias: bool = True):
        super().__init__()
        self.out_features = shape[0]
        gen_device = generator.device if generator is not None else device
        w = torch.randn(shape, generator=generator, device=gen_device) / math.sqrt(fan_in)
        self.weight = nn.Parameter(w.to(device))
        self.bias = nn.Parameter(torch.zeros(shape[0], device=device)) if bias else None

    def _column_parallel(self, fn, x, dim):
        if self.mesh is None or self.weight.shape[0] == self.out_features:
            return fn(x)
        group = self.mesh.get_group("model")
        return _collectives.gather_from_model(fn(_collectives.copy_to_model(x, group)), group,
                                              dim)

    def dense(self, x, dtype):
        return self._column_parallel(
            lambda v: F.linear(v, self.weight.to(dtype), _cast(self.bias, dtype)), x, -1)

    def conv(self, x, dtype, **kw):
        return self._column_parallel(
            lambda v: F.conv2d(v.to(dtype), self.weight.to(dtype), _cast(self.bias, dtype), **kw),
            x, 1)


def _cast(t, dtype):
    return None if t is None else t.to(dtype)
