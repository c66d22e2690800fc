"""The DAU convolution in plain float32 PyTorch.

A Displaced Aggregation Unit (Tabernik et al., CVPR 2018) is a Gaussian
placed at an offset (mu1 along x, mu2 along y) from the output pixel. The
layer blurs its input with the normalised Gaussian, reads the blurred plane
of input channel s at each unit's offset by bilinear interpolation, and sums
the reads weighted by the unit's weight:

    y[n, f, i, j] = sum_{s, g} w[s, g, f] * B(blur(x)[n, s], i + mu2, j + mu1)

The read at a fractional offset touches the four integer neighbours, so the
sum is one correlation with a kernel made of four taps per unit
(`synth_kernel`). Its backward is the DAU backward of the original
DAU-ConvNet: the unit gradients read the input blurred with the Gaussian's
derivative filters at the same four taps, the mu gradients are scaled by the
layer's mu learning-rate factor, and dx is the transposed aggregation of the
error blurred with the mirrored Gaussian.

`quant`, where given, is applied to both operands of every product (the
benchmark's lower-precision control).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["blur_size", "filters", "blur", "synth_kernel", "tap_read", "dau_conv"]


def blur_size(sigma: float) -> int:
    """2*ceil(5*sigma)+1, at least 9."""
    return max(2 * int(math.ceil(5.0 * sigma)) + 1, 9)


def filters(sigma: float, size: int, device=None):
    """The normalised Gaussian `w`, its derivatives along x and y with the
    normalisation's quotient-rule term (`dmu1`, `dmu2`), each (size, size),
    rows y and columns x, centred at size // 2."""
    c = size // 2
    t = torch.arange(size, dtype=torch.float64, device=device) - c
    xx, yy = t[None, :].expand(size, size), t[:, None].expand(size, size)
    s2 = 1.0 / (sigma * sigma)
    g = torch.exp(-(xx * xx + yy * yy) * 0.5 * s2)
    z = g.sum()
    gn = g / z
    out = {"w": gn}
    for name, coord in (("dmu1", xx), ("dmu2", yy)):
        d = coord * s2 * g
        corr = d.sum() / z
        corr = corr if abs(float(corr)) > 1e-10 else corr * 0
        out[name] = d / z - gn * corr
    return {k: v.float() for k, v in out.items()}


def blur(x, filt):
    """Zero-padded correlation of every (n, channel) plane with `filt`."""
    ch, k = x.shape[1], filt.shape[-1]
    weight = filt.to(x.dtype).expand(ch, 1, k, k)
    return F.conv2d(x, weight, padding=k // 2, groups=ch)


def _taps(mu1, mu2, ks: int):
    """The four (weight, row, column) taps of each unit, each (S, G, F)."""
    c = ks // 2
    f1, f2 = torch.floor(mu1), torch.floor(mu2)
    a1, a2 = mu1 - f1, mu2 - f2
    col, row = (c + f1).long(), (c + f2).long()
    return [((1 - a2) * (1 - a1), row, col), ((1 - a2) * a1, row, col + 1),
            (a2 * (1 - a1), row + 1, col), (a2 * a1, row + 1, col + 1)]


def synth_kernel(w, mu1, mu2, ks: int):
    """(F, S, ks, ks): every unit's weight spread over its four taps."""
    s, g, f = w.shape
    kern = torch.zeros((f, s, ks * ks), dtype=torch.float32, device=w.device)
    s_idx = torch.arange(s, device=w.device)[:, None, None].expand(s, g, f)
    f_idx = torch.arange(f, device=w.device)[None, None, :].expand(s, g, f)
    for tw, row, col in _taps(mu1, mu2, ks):
        flat = (f_idx * s + s_idx) * ks * ks + row * ks + col
        kern.view(-1).index_add_(0, flat.reshape(-1), (w * tw).reshape(-1))
    return kern.view(f, s, ks, ks)


def tap_read(table, mu1, mu2, ks: int):
    """Per-unit sums of a (F, S, ks, ks) position table at the unit's four
    taps: (S, G, F)."""
    f, s = table.shape[:2]
    g = mu1.shape[1]
    s_idx = torch.arange(s, device=table.device)[:, None, None].expand(s, g, f)
    f_idx = torch.arange(f, device=table.device)[None, None, :].expand(s, g, f)
    out = torch.zeros(mu1.shape, dtype=torch.float32, device=table.device)
    for tw, row, col in _taps(mu1, mu2, ks):
        out += tw * table[f_idx, s_idx, row, col]
    return out


def _same(t):
    return t


class _DAUConv(torch.autograd.Function):
    """x (N, S, H, W), w/mu1/mu2 (S, G, F) -> (N, F, H, W) at stride 1."""

    @staticmethod
    def forward(ctx, x, w, mu1, mu2, layer, quant):
        fl = filters(layer["sigma"], layer["blur_size"], x.device)
        ks = layer["ks"]
        kern = synth_kernel(w, mu1, mu2, ks)
        xb = blur(x, fl["w"])
        ctx.save_for_backward(x, w, mu1, mu2, kern)
        ctx.layer, ctx.quant, ctx.fl = layer, quant, fl
        return F.conv2d(quant(xb), quant(kern), padding=ks // 2)

    @staticmethod
    def backward(ctx, gy):
        x, w, mu1, mu2, kern = ctx.saved_tensors
        layer, q, fl = ctx.layer, ctx.quant, ctx.fl
        ks = layer["ks"]
        gyq = q(gy)
        dx = None
        if ctx.needs_input_grad[0]:
            gyb = blur(gy, torch.flip(fl["w"], dims=(0, 1)))
            dx = F.conv_transpose2d(q(gyb), q(kern), padding=ks // 2)
        grads = {}
        for name in ("w", "dmu1", "dmu2"):
            table = torch.nn.grad.conv2d_weight(q(blur(x, fl[name])), kern.shape, gyq,
                                                padding=ks // 2)
            grads[name] = tap_read(table, mu1, mu2, ks)
        lr = layer["mu_learning_rate_factor"]
        dmu1 = torch.nan_to_num(grads["dmu1"] * w * lr, nan=0.0, posinf=math.inf,
                                neginf=-math.inf)
        dmu2 = torch.nan_to_num(grads["dmu2"] * w * lr, nan=0.0, posinf=math.inf,
                                neginf=-math.inf)
        return dx, grads["w"], dmu1, dmu2, None, None


def dau_conv(x, p, layer, quant=None):
    """One DAU layer: the offsets clipped to +-(ks_max // 2 - border), the
    DAU convolution, the stride taken from the stride-1 output, then the
    bias. `p` holds weights/mu1/mu2 as (1, S, G, F) and an optional bias."""
    bound = layer["max_kernel_size"] // 2 - layer["border_bound"]
    mu1 = torch.clamp(p["mu1"][0].float(), -bound, bound)
    mu2 = torch.clamp(p["mu2"][0].float(), -bound, bound)
    y = _DAUConv.apply(x, p["weights"][0].float(), mu1, mu2, layer, quant or _same)
    stride = layer.get("stride", 1)
    if stride > 1:
        y = y[:, :, ::stride, ::stride]
    if p.get("bias") is not None:
        y = y + p["bias"].float().reshape(1, -1, 1, 1)
    return y


def layer_settings(config: dict, stride: int = 1) -> dict:
    """The per-layer constants of a configuration's DAU layers."""
    mks = config["max_kernel_size"]
    bound = mks // 2 - config["border_bound"]
    sigma = config["sigma"]
    return {"sigma": sigma, "blur_size": blur_size(sigma), "max_kernel_size": mks,
            "border_bound": config["border_bound"],
            "ks": 2 * (int(math.floor(bound)) + 1) + 1, "stride": stride,
            "mu_learning_rate_factor": config["mu_learning_rate_factor"]}
