"""DAU-ResNet in plain float32 PyTorch.

ResNet (He et al. 2016, Table 1) with the two 3x3 convolutions of each basic
block replaced by DAU layers without bias. Stem: 7x7 stride 2 padding 3
without bias, 3/2 max-pool with padding 1, BatchNorm, ReLU. Block: DAU
(strided in the first block of stages 1-3) -> BN -> ReLU -> DAU -> BN, plus
the shortcut (1x1 strided projection without bias -> BN where the shape
changes), then ReLU. Head: global mean, dense to the classes. BatchNorm
takes the batch mean and the biased variance in training mode and moves its
running statistics by `momentum`; epsilon 1e-5.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .dau import dau_conv, layer_settings

__all__ = ["param_specs", "forward", "blocks", "dau_layers", "dense_macs"]


def blocks(config: dict):
    """(name, in_channels, filters, stride) of every basic block."""
    out, s = [], config["width"]
    for stage, n in enumerate(config["stages"]):
        f = config["width"] * 2 ** stage
        for b in range(n):
            out.append((f"stage{stage}_block{b}", s, f, 2 if (stage > 0 and b == 0) else 1))
            s = f
    return out


def _stem_side(config: dict) -> int:
    """Side of the planes after the stem's conv (stride 2) and pool (3/2,
    padding 1)."""
    return ((config["image_size"] + 1) // 2 + 1) // 2


def dau_layers(config: dict, n: int):
    """Shapes of the DAU layers in forward order (see
    `alexnet_dau.dau_layers`); a strided layer reads h x w and keeps every
    stride-th pixel."""
    from .dau import blur_size
    g = config["dau_units"][0] * config["dau_units"][1]
    kb = blur_size(config["sigma"])
    side, out = _stem_side(config), []
    for name, s, f, stride in blocks(config):
        half = (side + stride - 1) // stride
        out.append(dict(name=f"{name}.dau1", n=n, s=s, f=f, g=g, h=side, w=side, h_out=half,
                        w_out=half, kb=kb))
        out.append(dict(name=f"{name}.dau2", n=n, s=f, f=f, g=g, h=half, w=half, h_out=half,
                        w_out=half, kb=kb))
        side = half
    return out


def dense_macs(config: dict):
    """Multiply-adds per image of the stem, the projections and the head."""
    stem = (config["image_size"] + 1) // 2
    macs = [config["width"] * 3 * 49 * stem * stem]
    side = _stem_side(config)
    for _, s, f, stride in blocks(config):
        side = (side + stride - 1) // stride
        if s != f or stride > 1:
            macs.append(s * f * side * side)
    return macs + [blocks(config)[-1][2] * config["num_classes"]]


def _bn_specs(name, c):
    return [(f"{name}.weight", (c,), "bn_weight", 0, False),
            (f"{name}.bias", (c,), "bias", 0, False),
            (f"{name}.running_mean", (c,), "zeros", 0, False),
            (f"{name}.running_var", (c,), "ones", 0, False)]


def param_specs(config: dict):
    """(name, shape, kind, fan_in, in_dau) of every tensor, in the program's
    state-dict names (see `alexnet_dau.param_specs` for the kinds; BN
    weights 'bn_weight', running statistics 'zeros'/'ones')."""
    g = config["dau_units"][0] * config["dau_units"][1]
    w = config["width"]
    specs = [("stem.weight", (w, 3, 7, 7), "dense", 3 * 49, False)] + _bn_specs("bn_stem", w)
    for name, s, f, stride in blocks(config):
        for dau, cin in (("dau1", s), ("dau2", f)):
            specs += [(f"{name}.{dau}.weights", (1, cin, g, f), "dau_w", cin * g, True),
                      (f"{name}.{dau}.mu1", (1, cin, g, f), "mu", 0, True),
                      (f"{name}.{dau}.mu2", (1, cin, g, f), "mu", 0, True),
                      (f"{name}.{dau}.sigma", (1,), "sigma", 0, True)]
        specs += _bn_specs(f"{name}.bn1", f) + _bn_specs(f"{name}.bn2", f)
        if s != f or stride > 1:
            specs += [(f"{name}.proj.weight", (f, s, 1, 1), "dense", s, False)]
            specs += _bn_specs(f"{name}.bn_proj", f)
    last = blocks(config)[-1][2]
    specs += [("head.weight", (config["num_classes"], last), "dense", last, False),
              ("head.bias", (config["num_classes"],), "bias", 0, False)]
    return specs


def _bn(x, p, name, momentum, train, stats):
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
        with torch.no_grad():
            stats[f"{name}.running_mean"] = (stats[f"{name}.running_mean"] * (1 - momentum)
                                             + momentum * mean)
            stats[f"{name}.running_var"] = (stats[f"{name}.running_var"] * (1 - momentum)
                                            + momentum * var)
    else:
        mean, var = stats[f"{name}.running_mean"], stats[f"{name}.running_var"]
    mul = torch.rsqrt(var + 1e-5) * p[f"{name}.weight"]
    return (x - mean.reshape(1, -1, 1, 1)) * mul.reshape(1, -1, 1, 1) + p[
        f"{name}.bias"].reshape(1, -1, 1, 1)


def forward(params, x, config, quant=None, train=True, stats=None):
    """Logits (N, classes) in f32 of the f32 images `x`. In training mode the
    running statistics in `stats` (a dict, updated in place) move."""
    q = quant or (lambda t: t)
    p = {k: v.float() for k, v in params.items()}
    stats = stats if stats is not None else {k: v.float() for k, v in params.items()
                                             if k.endswith(("running_mean", "running_var"))}
    m_stem, m_block = config["bn_momentum_stem"], config["bn_momentum"]
    x = F.conv2d(q(x), q(p["stem.weight"]), stride=2, padding=3)
    x = F.max_pool2d(x, 3, 2, padding=1)
    x = F.relu(_bn(x, p, "bn_stem", m_stem, train, stats))
    for name, s, f, stride in blocks(config):
        def unit(dau, name=name):
            return {k: p[f"{name}.{dau}.{k}"] for k in ("weights", "mu1", "mu2")}
        y = dau_conv(x, unit("dau1"), layer_settings(config, stride), quant)
        y = F.relu(_bn(y, p, f"{name}.bn1", m_block, train, stats))
        y = _bn(dau_conv(y, unit("dau2"), layer_settings(config), quant), p, f"{name}.bn2",
                m_block, train, stats)
        res = x
        if s != f or stride > 1:
            res = _bn(F.conv2d(q(x), q(p[f"{name}.proj.weight"]), stride=stride), p,
                      f"{name}.bn_proj", m_block, train, stats)
        x = F.relu(y + res)
    return F.linear(q(x.mean(dim=(2, 3))), q(p["head.weight"]), p["head.bias"])
