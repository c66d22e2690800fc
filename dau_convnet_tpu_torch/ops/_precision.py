"""The dense engine's `precision` setting on cuDNN's f32 convolutions.

JAX passes `Precision.HIGHEST` to every convolution of the dense engine;
torch lets cuDNN run an f32 convolution in TF32 (a 10-bit mantissa) unless
`torch.backends.cudnn.allow_tf32` is off. `conv_precision("highest")` turns
it off for the convolutions inside and puts it back afterwards;
`conv_precision("default")` leaves it as it is. (`torch.backends.cudnn.flags`
is no substitute: it also resets every other cuDNN flag to its own
defaults, `enabled=False` among them. Setting `allow_tf32` sets cuDNN's
conv and rnn `fp32_precision` together, as the newer API reads them.)
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["conv_precision"]


@contextlib.contextmanager
def conv_precision(precision: str):
    """cuDNN's TF32 off inside at precision='highest'; unchanged at
    'default'."""
    if precision == "default":
        yield
        return
    if precision != "highest":
        raise ValueError(f"unknown precision {precision!r}")
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before
