"""Batch normalization with flax's semantics.

`torch.nn.BatchNorm2d` is not flax's `nn.BatchNorm`: its running variance
takes the unbiased batch variance (n/(n-1) times the biased one), flax's
the biased one. The models of this package load flax's statistics and are
held against flax's training step, so they use this module instead.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel import _collectives
from ..parallel.mesh import axis_size

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

    `mesh` (set by `parallel.init_sharded`, None otherwise) is the device
    mesh the model is sharded over. In train mode the batch statistics are
    those of the global batch, as in JAX's sharded step (GSPMD computes the
    single-device program): the f32 sum and sum of squares are all-reduced
    over the 'data' axis, and the running statistics stay replicated. A
    bias sharded over 'model' (JAX's rule shards a 1-D `bias`, not the
    scale) is all-gathered before use.
    """

    mesh = None

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
        bias = self.bias
        if self.training:
            mean, sq = self._batch_moments(xf, axes)
            var = torch.clamp_min(sq - mean * mean, 0.0)
            with torch.no_grad():
                self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
        else:
            mean, var = self.running_mean, self.running_var
        if self.mesh is not None and bias.shape[0] != self.num_features:
            bias = _collectives.gather_from_model(bias, self.mesh.get_group("model"), dim=0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) + bias.reshape(shape)
        return y.to(x.dtype)

    def _batch_moments(self, xf, axes):
        """E[x] and E[x^2] over the batch: this rank's, or under a mesh with
        a data axis the global batch's, from all-reduced sums."""
        if self.mesh is None or axis_size(self.mesh, "data") == 1:
            return xf.mean(dim=axes), (xf * xf).mean(dim=axes)
        count = xf.numel() // xf.shape[1] * axis_size(self.mesh, "data")
        sums = torch.stack([xf.sum(dim=axes), (xf * xf).sum(dim=axes)])
        sums = _collectives.all_reduce_sum(sums, self.mesh.get_group("data")) / count
        return sums[0], sums[1]

    def extra_repr(self) -> str:
        return f"{self.num_features}, momentum={self.momentum}, eps={self.eps}"
