"""The reference GPU's edge-gradient rule, used only under `unit_testing`.

Counterpart of `dau_convnet_tpu/ops/_edge.py`: the reference's CUDA
backward drops the last output row/column of the error when the output size
divides its tile size. The port's engines have no such tiles; the rule
exists so differential tests can compare against the reference semantics.
"""

from __future__ import annotations

__all__ = ["disabled_edges"]

_TILE_SIZES = (64, 32, 16, 8)


def _disable(dim: int) -> bool:
    for tile in _TILE_SIZES:
        if dim >= tile:
            return dim % tile == 0
    return False


def disabled_edges(h: int, w: int):
    """(zero_last_row, zero_last_col) per the reference GPU tile rule."""
    return _disable(h), _disable(w)
