"""Dense engine: DAU aggregation as kernel synthesis + dense correlation.

Counterpart of `dau_convnet_tpu/ops/xla_engine.py`. The aggregation

    y[n,f] = sum_{s,g} w[s,g,f] * bilinear_shift(x_blur[n,s], mu1, mu2)

is a dense cross-correlation with a synthesized kernel

    K[s,f,ky,kx] = sum_g w[s,g,f] * ty[s,g,f,ky] * tx[s,g,f,kx]

where ty/tx are the one-hot bilinear tap vectors (mu1 is x / columns, mu2 is
y / rows). `synthesize_kernel` accumulates in w's dtype with positions in
mu1's dtype, exactly as the JAX engine does, so a bf16 model rounds where
the JAX one rounds. The two convolutions take JAX's `precision`:
'highest' (the default, JAX's `Precision.HIGHEST`) runs them with cuDNN's
TF32 off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._precision import conv_precision

__all__ = ["tap_vectors", "synthesize_kernel", "aggregate_forward",
           "grad_tables", "tap_gather"]


def tap_vectors(mu1, mu2, ks: int, use_interpolation: bool):
    """One-hot bilinear tap vectors along the kernel x / y axes.

    mu1, mu2: (S, G, F) displacements (x and y). Returns (ty, tx), each
    (S, G, F, ks), such that sum_{ky,kx} ty[...,ky] * tx[...,kx] *
    x(i+ky-c, j+kx-c) is the bilinear read of x at (i + mu2, j + mu1).
    """
    c = ks // 2
    dtype = mu1.dtype
    f1 = torch.floor(mu1)
    f2 = torch.floor(mu2)
    if use_interpolation:
        a1 = mu1 - f1
        a2 = mu2 - f2
    else:
        a1 = torch.zeros_like(mu1)
        a2 = torch.zeros_like(mu2)
    pos = torch.arange(ks, dtype=dtype, device=mu1.device)
    t1 = c + f1[..., None]
    t2 = c + f2[..., None]
    tx = (1.0 - a1)[..., None] * (pos == t1) + a1[..., None] * (pos == t1 + 1.0)
    ty = (1.0 - a2)[..., None] * (pos == t2) + a2[..., None] * (pos == t2 + 1.0)
    return ty.to(dtype), tx.to(dtype)


def _flat_taps(mu1, mu2, ks: int, use_interpolation: bool):
    """(weight, flat target position) of each unit's taps: up to 4 pairs,
    each shaped like mu1; positions index the flattened ks*ks grid and are
    exact small integers in mu1's dtype."""
    c = ks // 2
    f1 = torch.floor(mu1)
    f2 = torch.floor(mu2)
    if use_interpolation:
        a1 = mu1 - f1
        a2 = mu2 - f2
        deltas = ((0, 0), (0, 1), (1, 0), (1, 1))
    else:
        a1 = torch.zeros_like(mu1)
        a2 = torch.zeros_like(mu2)
        deltas = ((0, 0),)
    base = (c + f2) * ks + (c + f1)
    out = []
    for dy, dx in deltas:
        wx = a1 if dx else 1.0 - a1
        wy = a2 if dy else 1.0 - a2
        out.append((wx * wy, base + (dy * ks + dx)))
    return out


def synthesize_kernel(w, mu1, mu2, ks: int, use_interpolation: bool = True):
    """K[s,f,ky,kx] = sum_g w[s,g,f] * bilinear-tap one-hot at (mu2, mu1).

    w, mu1, mu2: (S, G, F). Returns (S, F, ks, ks) in w's dtype.
    """
    s, g, f = w.shape
    p = torch.arange(ks * ks, dtype=mu1.dtype, device=mu1.device)
    kern = torch.zeros((s, f, ks * ks), dtype=w.dtype, device=w.device)
    for iw, tgt in _flat_taps(mu1, mu2, ks, use_interpolation):
        contrib = (w * iw)[..., None] * (p == tgt[..., None])
        kern = kern + torch.sum(contrib.to(w.dtype), dim=1)
    return kern.reshape(s, f, ks, ks)


def aggregate_forward(x_blur, w, mu1, mu2, ks: int,
                      use_interpolation: bool = True, precision: str = "highest"):
    """Offset-and-sum over the (s, g) units as one dense correlation.

    x_blur: (N, S, H, W) pre-blurred input; w, mu1, mu2: (S, G, F) with w
    already masked for dummy units. Returns (N, F, H, W).
    """
    kern = synthesize_kernel(w, mu1, mu2, ks, use_interpolation)
    rhs = kern.transpose(0, 1)  # OIHW = (F, S, ks, ks)
    with conv_precision(precision):
        return F.conv2d(x_blur, rhs.to(x_blur.dtype), padding=ks // 2)


def grad_tables(x_blur_k, err, ks: int, precision: str = "highest"):
    """Full position table of the parameter gradients (conv-backward-filter):

        table[m,s,f,ky,kx] = sum_{n,i,j} x_blur_k[m,n,s,i+ky-c,j+kx-c] * err[n,f,i,j]

    with x_blur_k zero outside the image. One correlation: batch = the (m, s)
    planes, channels = N, kernel = err. x_blur_k: (M, N, S, H, W); err:
    (N, F, H, W). Returns (M, S, F, ks, ks) in x_blur_k's dtype.
    """
    m, n, s, h, w_sp = x_blur_k.shape
    f = err.shape[1]
    lhs = x_blur_k.transpose(1, 2).reshape(m * s, n, h, w_sp)  # m-major, then s
    rhs = err.transpose(0, 1)  # (F, N, H, W)
    with conv_precision(precision):
        table = F.conv2d(lhs, rhs.to(lhs.dtype), padding=ks // 2)  # (M*S, F, ks, ks)
    return table.reshape(m, s, f, ks, ks)


def tap_gather(table, mu1, mu2, ks: int, use_interpolation: bool = True,
               table_layout: str = "msfp"):
    """Per-unit gradients from a position table:

        grad[m,s,g,f] = sum_taps iw * table[m,s,f, tap position]

    as one one-hot multiply-reduce over the flat position axis, with the
    mask built in the table's dtype. table_layout: "msfp" = (M, S, F, ks,
    ks) (`grad_tables`) or "pmsf" = (ks*ks, M, S, F) (the position-major
    table of `fourier_engine.fourier_grad_tables`). Returns (M, S, G, F).
    """
    if table_layout == "pmsf":
        p2, m, s, f = table.shape
        g = mu1.shape[1]
        p = torch.arange(ks * ks, dtype=mu1.dtype, device=mu1.device).reshape(-1, 1, 1, 1)
        mask = torch.zeros((ks * ks, s, g, f), dtype=table.dtype, device=table.device)
        for iw, tgt in _flat_taps(mu1, mu2, ks, use_interpolation):
            mask = mask + (iw * (p == tgt)).to(table.dtype)
        return torch.sum(table.reshape(p2, m, s, 1, f) * mask[:, None], dim=0)
    if table_layout != "msfp":
        raise ValueError(f"unknown table_layout {table_layout!r}")
    m, s, f = table.shape[:3]
    g = mu1.shape[1]
    tf = table.reshape(m, s, 1, f, ks * ks)
    p = torch.arange(ks * ks, dtype=mu1.dtype, device=mu1.device)
    mask = torch.zeros((s, g, f, ks * ks), dtype=table.dtype, device=table.device)
    for iw, tgt in _flat_taps(mu1, mu2, ks, use_interpolation):
        mask = mask + (iw[..., None] * (p == tgt[..., None])).to(table.dtype)
    return torch.sum(tf * mask[None], dim=-1)
