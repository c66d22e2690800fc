"""Weights from the seed, made on the device in a few large calls.

Every tensor of a configuration's model is listed by its reference module
(`param_specs`). One normal draw fills every weight and bias, one uniform
draw every offset, each then scaled by its kind and stored in the dtype the
configuration stores it in. The same dict is loaded into the program and
handed to the reference.
"""

from __future__ import annotations

import math

import torch

from .reference.train import architecture

__all__ = ["make_weights"]

_NORMAL_SCALE = {"bias": 0.01, "bn_weight": 0.1}


def make_weights(config: dict, seed: int, device) -> dict:
    """name -> tensor, stored as the configuration stores it."""
    specs = architecture(config).param_specs(config)
    dtype = getattr(torch, config["dtype"])
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(shape) for _, shape, *_ in specs]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    bound = config["mu_init_bound"]
    out, at = {}, 0
    for (name, shape, kind, fan_in, in_dau), size in zip(specs, sizes):
        z, u = normal[at:at + size].view(shape), uniform[at:at + size].view(shape)
        at += size
        if kind == "dense":
            t = z / math.sqrt(fan_in)
        elif kind == "dau_w":
            t = z * math.sqrt(2.0 / fan_in)
        elif kind == "mu":
            t = (u * 2 - 1) * bound
        elif kind == "sigma":
            t = torch.full(shape, config["sigma"], device=device)
        elif kind == "zeros":
            t = torch.zeros(shape, device=device)
        elif kind == "ones":
            t = torch.ones(shape, device=device)
        elif kind == "bn_weight":
            t = 1 + z * _NORMAL_SCALE[kind]
        else:
            t = z * _NORMAL_SCALE[kind]
        out[name] = t.to(dtype if in_dau else torch.float32).contiguous()
    return out
