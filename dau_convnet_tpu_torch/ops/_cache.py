"""A cache for functions that build constant tensors."""

from __future__ import annotations

import functools

import torch


def tensor_cache(fn):
    """`functools.lru_cache(maxsize=None)` of fn, bypassed while
    `torch.export` or `torch.compile` traces: a tensor built under tracing
    is a fake one, and cached it would stand in for the constant in every
    later eager call."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def call(*args):
        return fn(*args) if torch.compiler.is_compiling() else cached(*args)

    call.cache_clear = cached.cache_clear
    return call
