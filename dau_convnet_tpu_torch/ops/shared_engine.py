"""Shared-displacement DAU convolution.

Counterpart of `dau_convnet_tpu/ops/shared_engine.py`: displacements (mu1,
mu2) are shared across output channels, per (input channel s, unit g)
instead of per (s, g, f). The numerics are exactly `dau_conv2d_op` with mu
broadcast over F; autograd's adjoint of the broadcast sums the per-f mu
gradients, which is the exact adjoint of sharing.
"""

from __future__ import annotations

from .dau_conv import DAUConvSettings, dau_conv2d_op

__all__ = ["dau_conv2d_shared_op"]


def dau_conv2d_shared_op(cfg: DAUConvSettings, x, w, mu1, mu2, sigma):
    """Shared-displacement DAU convolution.

    x: (N, S, H, W). w: (S, G, F). mu1, mu2: (S, G). sigma: the layer-shared
    width, any shape (its first element is used). Returns (N, F, H, W); the
    gradients of mu1/mu2 have shape (S, G), the op's per-f gradients summed
    over F.
    """
    s, g, f = w.shape
    return dau_conv2d_op(cfg, x, w, mu1[:, :, None].expand(s, g, f),
                         mu2[:, :, None].expand(s, g, f), sigma)
