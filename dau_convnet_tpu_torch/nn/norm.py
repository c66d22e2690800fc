"""Batch normalization with flax's semantics.

`torch.nn.BatchNorm2d` is not flax's `nn.BatchNorm`: its running variance
takes the unbiased batch variance (n/(n-1) times the biased one), flax's
the biased one. The models of this package load flax's statistics and are
held against flax's training step, so they use this module instead.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["BatchNorm"]


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm` over axis 1 (NCHW, or (N, C) for 2-D input).

    momentum is PyTorch's: the weight of the new batch statistic, i.e. 1
    minus flax's momentum (flax 0.9999 -> 1e-4, 0.9 -> 0.1, flax's default
    0.99 -> 0.01). In train mode (`module.train()`) the batch mean and the
    biased variance E[x^2] - E[x]^2 (clipped at 0, as flax computes it) are
    taken in at least f32 (bf16 activations are promoted, as flax does), and
    the running statistics move to running*(1 - momentum) + batch*momentum;
    in eval mode the running statistics are used. The output, (x - mean) *
    rsqrt(var + eps) * weight + bias in that precision, comes back in the
    activations' dtype, as flax's `dtype=` does. weight (flax's `scale`),
    bias, running_mean and running_var (flax's batch_stats `mean` and `var`)
    are f32.
    """

    def __init__(self, num_features: int, momentum: float = 0.01, eps: float = 1e-5,
                 device=torch.device("cuda")):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean", torch.zeros(num_features, device=device))
        self.register_buffer("running_var", torch.ones(num_features, device=device))

    def forward(self, x):
        if x.dim() < 2 or x.shape[1] != self.num_features:
            raise ValueError(f"BatchNorm({self.num_features}) got input {tuple(x.shape)}")
        axes = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            mean = xf.mean(dim=axes)
            var = torch.clamp_min((xf * xf).mean(dim=axes) - mean * mean, 0.0)
            with torch.no_grad():
                self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(x.dtype)

    def extra_repr(self) -> str:
        return f"{self.num_features}, momentum={self.momentum}, eps={self.eps}"
