"""A cache for functions that build constant tensors."""

from __future__ import annotations

import functools

import torch

__all__ = ["tensor_cache", "CaptureCacheMiss"]


class CaptureCacheMiss(RuntimeError):
    """A constant tensor was first asked for while a CUDA graph was being
    captured: built there, it would be a captured kernel that never ran."""


def _capturing() -> bool:
    try:
        return torch.cuda.is_current_stream_capturing()
    except RuntimeError:  # a build of torch without CUDA
        return False


def tensor_cache(fn):
    """A cache of fn's results by its arguments, bypassed while
    `torch.export` or `torch.compile` traces: a tensor built under tracing
    is a fake one, and cached it would stand in for the constant in every
    later eager call. A miss while the current stream captures a CUDA graph
    raises `CaptureCacheMiss`: the tables are built by an eager call first."""
    table: dict = {}

    @functools.wraps(fn)
    def call(*args):
        if torch.compiler.is_compiling():
            return fn(*args)
        try:
            return table[args]
        except KeyError:
            if _capturing():
                raise CaptureCacheMiss(f"{fn.__qualname__}{args!r}: built under CUDA graph "
                                       "capture") from None
            out = table[args] = fn(*args)
            return out

    call.cache_clear = table.clear
    return call
