"""AlexNet-DAU (Tabernik et al., CVPR 2018) in plain float32 PyTorch.

AlexNet with its conv2-conv5 replaced by DAU layers: conv1 11x11 stride 4
VALID with bias, ReLU, 3/2 max-pool; four DAU layers with bias and ReLU, a
3/2 max-pool after the first and the last; flatten in NCHW order; fc6 and
fc7 of 4096 with ReLU; fc8 to the classes. The widths come from the
configuration file.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .dau import dau_conv, layer_settings

__all__ = ["param_specs", "forward", "dau_layers", "dense_macs"]


def _pooled(size: int) -> int:
    return (size - 3) // 2 + 1


def _fc_in(config: dict) -> int:
    side = _pooled((config["image_size"] - 11) // 4 + 1)
    for _, _, pool in config["dau_layers"]:
        side = _pooled(side) if pool else side
    return config["dau_layers"][-1][1] * side * side


def dau_layers(config: dict, n: int):
    """Shapes of the DAU layers in forward order: name, n, s, f, g, h, w,
    h_out, w_out, kb (the blur filter's size)."""
    from .dau import blur_size
    g = config["dau_units"][0] * config["dau_units"][1]
    side = _pooled((config["image_size"] - 11) // 4 + 1)
    out = []
    for i, (s, f, pool) in enumerate(config["dau_layers"]):
        out.append(dict(name=f"dau_conv{i + 2}", n=n, s=s, f=f, g=g, h=side, w=side,
                        h_out=side, w_out=side, kb=blur_size(config["sigma"])))
        side = _pooled(side) if pool else side
    return out


def dense_macs(config: dict):
    """Multiply-adds per image of conv1 and the dense layers."""
    side = (config["image_size"] - 11) // 4 + 1
    widths = [_fc_in(config)] + list(config["fc"]) + [config["num_classes"]]
    return ([config["conv1_filters"] * 3 * 121 * side * side]
            + [a * b for a, b in zip(widths[:-1], widths[1:])])


def param_specs(config: dict):
    """(name, shape, kind, fan_in, in_dau) of every tensor of the model, in
    the program's state-dict names. kind: 'dense' (normal / sqrt(fan_in)),
    'bias', 'dau_w' (normal * sqrt(2 / (S*G))), 'mu', 'sigma'. in_dau: the
    tensor belongs to a DAU layer, which stores it in the configuration's
    dtype (all else is stored in f32)."""
    g = config["dau_units"][0] * config["dau_units"][1]
    c1 = config["conv1_filters"]
    specs = [("conv1.weight", (c1, 3, 11, 11), "dense", 3 * 121, False),
             ("conv1.bias", (c1,), "bias", 0, False)]
    for i, (s, f, _) in enumerate(config["dau_layers"]):
        name = f"dau_conv{i + 2}"
        specs += [(f"{name}.weights", (1, s, g, f), "dau_w", s * g, True),
                  (f"{name}.mu1", (1, s, g, f), "mu", 0, True),
                  (f"{name}.mu2", (1, s, g, f), "mu", 0, True),
                  (f"{name}.sigma", (1,), "sigma", 0, True),
                  (f"{name}.bias", (f,), "bias", 0, True)]
    widths = [_fc_in(config)] + list(config["fc"]) + [config["num_classes"]]
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        specs += [(f"fc{i + 6}.weight", (b, a), "dense", a, False),
                  (f"fc{i + 6}.bias", (b,), "bias", 0, False)]
    return specs


def forward(params, x, config, quant=None, train=True, stats=None):
    """Logits (N, classes) in f32 of the f32 images `x` (N, 3, H, W). The
    model has no batch statistics: `train` and `stats` change nothing."""
    del train, stats
    q = quant or (lambda t: t)
    p = {k: v.float() for k, v in params.items() if not k.endswith(("running_mean",
                                                                     "running_var"))}
    layer = layer_settings(config)
    x = F.conv2d(q(x), q(p["conv1.weight"]), p["conv1.bias"], stride=4)
    x = F.max_pool2d(F.relu(x), 3, 2)
    for i, (_, _, pool) in enumerate(config["dau_layers"]):
        name = f"dau_conv{i + 2}"
        x = F.relu(dau_conv(x, {k: p[f"{name}.{k}"] for k in ("weights", "mu1", "mu2", "bias")},
                            layer, quant))
        if pool:
            x = F.max_pool2d(x, 3, 2)
    x = x.reshape(x.shape[0], -1)
    n_fc = len(config["fc"]) + 1
    for i in range(n_fc):
        x = F.linear(q(x), q(p[f"fc{i + 6}.weight"]), p[f"fc{i + 6}.bias"])
        if i < n_fc - 1:
            x = F.relu(x)
    return x
