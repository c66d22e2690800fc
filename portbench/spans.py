"""The program's own spans (`dau_convnet_tpu_torch.utils.tracing`), as the
span readers see them; the only file of the benchmark that imports the
program's recorder.

The recorder is on while a `torch.profiler` capture runs, so in a run of
the benchmark it holds the spans of the steady steps that `trace.whole`
profiled, every capture it took, and nothing else. Each reading is a sum a
`train.step` span over those spans. A program without the recorder, or a
run that profiled nothing, gives None.
"""

from __future__ import annotations

import contextlib
import typing as tp

__all__ = ["recorded", "record", "clear", "summary", "per_step"]

STEP = "train.step"


def _tracing():
    """The program's recorder module, or None where it has none."""
    try:
        from dau_convnet_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def recorded() -> list:
    """The spans the program's recorder holds; [] where it has none."""
    tracing = _tracing()
    return [] if tracing is None else tracing.spans()


def record():
    """The recorder's `record()` block (spans recorded without the
    profiler), or a block that records nothing where there is none."""
    tracing = _tracing()
    return contextlib.nullcontext() if tracing is None else tracing.record()


def clear() -> None:
    tracing = _tracing()
    if tracing is not None:
        tracing.clear()


def summary() -> dict:
    """The recorder's summary a `train.step` (per span name: count, ms,
    self ms, attrs summed); {} where there is none."""
    tracing = _tracing()
    return {} if tracing is None else tracing.summary(STEP)


def per_step(names: tp.Sequence[str], value: tp.Callable = lambda s: s.ms,
             where: tp.Callable = lambda s: True,
             spans: tp.Optional[list] = None) -> tp.Optional[float]:
    """Sum of `value(span)` over the spans named in `names` that `where`
    keeps, over the number of `train.step` spans; None where there is no
    step."""
    spans = recorded() if spans is None else spans
    steps = sum(1 for s in spans if s.name == STEP)
    if not steps:
        return None
    return sum(value(s) for s in spans if s.name in names and where(s)) / steps
