"""The yardstick: peaks of the card, and the operations and bytes of the
DAU work and of the models, counted from shapes alone.

A DAU layer's work is counted at the reference's 4-tap bilinear gather,
2 FLOPs a multiply-add, whatever engine or kernel runs it: the forward and
dx are 4*G taps per (input channel, filter, output pixel) each, and the
three unit-gradient tables (weights, mu1, mu2) as many again each. A model's
FLOPs a step add conv1 or the stem, the projections and the dense layers at
three times their forward (forward, input gradient, weight gradient).
"""

from __future__ import annotations

import typing as tp

__all__ = ["PEAKS", "peak", "bound_s", "dau_pass_ops", "model_flops", "table_work"]

# dense bf16 tensor-core FLOP/s (no sparsity) and HBM bytes/s, by
# torch.cuda.get_device_name()
PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16_flops": 989.4e12, "bytes": 3.35e12}}


def peak(kind: str) -> tp.Optional[dict]:
    """The card's peaks, or None for a card the table does not know."""
    return PEAKS.get(kind)


def bound_s(ops: float, nbytes: float, card: dict) -> float:
    """Least seconds the card needs: operations over the bf16 peak against
    bytes over the memory rate, whichever is larger."""
    return max(ops / card["bf16_flops"], nbytes / card["bytes"])


def dau_pass_ops(layer: dict, out_px: bool = True) -> int:
    """FLOPs of one 4-tap gather pass over a DAU layer: 2 * 4 * G * S * F *
    pixels * N, at the output's pixels (the useful work) or, with
    out_px=False, at the input's (the work of an op that computes every
    pixel and strides afterwards)."""
    hw = layer["h_out"] * layer["w_out"] if out_px else layer["h"] * layer["w"]
    return 2 * 4 * layer["g"] * layer["s"] * layer["f"] * hw * layer["n"]


def model_flops(dau_layers: tp.Sequence[dict], dense_macs: tp.Sequence[int], train: bool) -> int:
    """FLOPs of a training step (train=True) or of a forward: each DAU layer's
    gather passes (5 when training: forward, dx, three tables; else 1) plus
    the other layers' multiply-adds, 2 FLOPs each, three times when
    training."""
    passes, dense = (5, 3) if train else (1, 1)
    return (sum(passes * dau_pass_ops(la) for la in dau_layers)
            + sum(2 * dense * m for m in dense_macs))


def table_work(layer: dict, elem: int = 2) -> tp.Tuple[int, int]:
    """(operations, bytes) of the three unit-gradient tables of a layer from
    its blurred inputs and its error (the work of K6 and of K1): three 4-tap
    gather passes at the op's full resolution; bytes the three blurred input
    stacks and the error read once, the offsets read and the three f32
    gradient tensors written once."""
    px = layer["h"] * layer["w"] * layer["n"]
    units = layer["s"] * layer["g"] * layer["f"]
    ops = 3 * dau_pass_ops(layer, out_px=False)
    return ops, (3 * layer["s"] * px + layer["f"] * px + 2 * units) * elem + 3 * units * 4
