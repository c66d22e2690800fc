"""Spans of the port's own layers, recorded on the host.

A span is one named interval of host time at a layer boundary (the train
step and its phases, each DAU layer's forward and backward, the input
pipeline), with the counts taken at the same boundary in `attrs`. Sites
open one with `span(name)`:

    with tracing.span("dau.unit_grads") as sp:
        ...
        if sp:
            sp.set(route=route, bins=bins)

Recording is off by default. Then `span` checks one flag and returns a
shared no-op that is false, so a site builds nothing. It is on inside
`record()` (nestable) and while a `torch.profiler` capture is active, so a
profiled block gets the program's spans beside its own events. It is never
on while `torch.export` or `torch.compile` traces. Spans are not mirrored
as profiler ranges: the profiler would give each range a device-side copy,
and a range of the program would then count as a device launch.

The parent of a span is the innermost open span of its thread. A thread
with no open span (the autograd engine's device thread, running a backward
while the caller waits in `loss.backward()`) takes the innermost open span
opened with `adopt=True` instead; one opened with `root=True` (the input
pipeline's producer) takes none.

Times are epoch nanoseconds, the clock the profiler stamps its host and
device events in: each span is stamped by `time.perf_counter_ns()` and
shifted by one anchor pair (`time.time_ns()`, `time.perf_counter_ns()`)
taken when recording starts. So a device trace's idle gap can be put down
to the span that was open on the host at the time. Closed spans are kept in
memory, the newest `CAPACITY`; `dropped()` counts the oldest let go. Inside
`diverted()` they go to a list of the block's own instead (the spans of a
CUDA graph's capture, which no step of the store should count), and
`emit` records a span of zero length for work the host no longer runs
(the layers of a replayed graph).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
import typing as tp

import torch
from torch.autograd import profiler as _profiler

__all__ = ["CAPACITY", "Span", "span", "record", "recording", "diverted", "emit", "enclosing",
           "spans", "clear", "dropped", "summary"]

CAPACITY = 1 << 17

_depth = 0  # open record() blocks
_offset: tp.Optional[int] = None  # time_ns() - perf_counter_ns() of the anchor pair
_lock = threading.Lock()
_store: tp.Deque["Span"] = collections.deque(maxlen=CAPACITY)
_sink: tp.Optional[tp.List["Span"]] = None  # diverted(): where closed spans go instead
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()  # .stack: this thread's open spans
_adopters: tp.List["_Open"] = []  # open spans opened with adopt=True, innermost last


class Span(tp.NamedTuple):
    """A closed span: `start_ns`/`end_ns` in epoch ns, `thread` the native
    thread id (the profiler's `tid`), `parent` the id of the span that
    caused it or None."""

    name: str
    id: int
    parent: tp.Optional[int]
    thread: int
    start_ns: int
    end_ns: int
    attrs: tp.Dict[str, tp.Any]

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Off:
    """The shared no-op of a site while recording is off."""

    __slots__ = ()

    def __bool__(self):
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    """An open span: the object a site's `with` holds while recording."""

    __slots__ = ("name", "id", "parent", "attrs", "adopt", "root", "t0")

    def __init__(self, name: str, adopt: bool, root: bool):
        self.name, self.adopt, self.root = name, adopt, root
        self.attrs: tp.Dict[str, tp.Any] = {}

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].id if stack else None if self.root else _adopter()
        self.id = next(_ids)
        stack.append(self)
        if self.adopt:
            _adopters.append(self)  # one call under the interpreter lock: atomic
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _stack().pop()
        if self.adopt:
            _adopters.remove(self)
        offset = _anchor()
        _keep(Span(self.name, self.id, self.parent, threading.get_native_id(),
                   self.t0 + offset, t1 + offset, self.attrs))
        return False


def _keep(done: Span) -> None:
    global _dropped
    with _lock:
        if _sink is not None:
            _sink.append(done)
            return
        if len(_store) == _store.maxlen:
            _dropped += 1
        _store.append(done)


def _adopter() -> tp.Optional[int]:
    """The id of the innermost open span opened with adopt=True, or None."""
    try:
        return _adopters[-1].id
    except IndexError:  # none open (or the last one closed meanwhile)
        return None


def _stack() -> tp.List[_Open]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _anchor() -> int:
    global _offset
    if _offset is None:
        _offset = time.time_ns() - time.perf_counter_ns()
    return _offset


def recording() -> bool:
    """Whether spans are recorded here and now."""
    return bool(_depth or _profiler._is_profiler_enabled) and not torch.compiler.is_compiling()


def span(name: str, adopt: bool = False, root: bool = False):
    """A span named `name` around the `with` block, recorded where
    recording is on, else the shared no-op. `adopt`: spans of threads with
    none open become its children while it is open; `root`: it takes no
    parent from another thread."""
    if not (_depth or _profiler._is_profiler_enabled) or torch.compiler.is_compiling():
        return _OFF
    return _Open(name, adopt, root)


def emit(name: str, **attrs) -> None:
    """Record a span of zero length named `name` with `attrs`, closed now
    under this thread's innermost open span, where recording is on."""
    if not recording():
        return
    stack = _stack()
    t = time.perf_counter_ns() + _anchor()
    _keep(Span(name, next(_ids), stack[-1].id if stack else _adopter(),
               threading.get_native_id(), t, t, attrs))


@contextlib.contextmanager
def record():
    """Record spans inside the block (nestable)."""
    global _depth, _offset
    with _lock:
        if _depth == 0:
            _offset = None  # the anchor pair is taken again by the first span
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1


@contextlib.contextmanager
def diverted():
    """Record spans inside the block, every thread's, into the list it
    yields, and none into the shared store."""
    global _sink
    held: tp.List[Span] = []
    with record():
        with _lock:
            outer, _sink = _sink, held
        try:
            yield held
        finally:
            with _lock:
                _sink = outer


def enclosing(key: str) -> tp.Any:
    """attrs[key] of the innermost open span of this thread that has it, or
    None (also while recording is off)."""
    if not (_depth or _profiler._is_profiler_enabled):
        return None
    for sp in reversed(_stack()):
        if key in sp.attrs:
            return sp.attrs[key]
    return None


def spans() -> tp.List[Span]:
    """The recorded spans, in the order they closed."""
    with _lock:
        return list(_store)


def clear() -> None:
    """Forget the recorded spans and the dropped count."""
    global _dropped
    with _lock:
        _store.clear()
        _dropped = 0


def dropped() -> int:
    """Spans let go, oldest first, since the store held `CAPACITY`."""
    return _dropped


def _covered_ns(parent: Span, children: tp.Iterable[Span]) -> int:
    """ns of the parent's interval that the union of its children covers."""
    total, end = 0, parent.start_ns
    for c in sorted(children, key=lambda s: s.start_ns):
        a, b = max(c.start_ns, end), min(c.end_ns, parent.end_ns)
        if b > a:
            total += b - a
            end = b
    return total


def summary(root: str = "train.step",
            records: tp.Optional[tp.Sequence[Span]] = None) -> tp.Dict[str, dict]:
    """Per span name, over the `root` spans recorded (or `records`):
    `count` (a root), `ms` (mean host ms), `self_ms` (mean of the duration
    less what its children cover) and `attrs` (the numeric attrs summed, a
    root). Empty where no root span was recorded."""
    recs = spans() if records is None else list(records)
    roots = sum(1 for s in recs if s.name == root)
    if not roots:
        return {}
    children: tp.Dict[int, tp.List[Span]] = {}
    for s in recs:
        if s.parent is not None:
            children.setdefault(s.parent, []).append(s)
    out: tp.Dict[str, dict] = {}
    for s in recs:
        row = out.setdefault(s.name, {"n": 0, "ns": 0, "self_ns": 0, "attrs": {}})
        row["n"] += 1
        row["ns"] += s.end_ns - s.start_ns
        row["self_ns"] += s.end_ns - s.start_ns - _covered_ns(s, children.get(s.id, ()))
        for k, v in s.attrs.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                row["attrs"][k] = row["attrs"].get(k, 0) + v
    return {name: {"count": r["n"] / roots, "ms": r["ns"] / r["n"] / 1e6,
                   "self_ms": r["self_ns"] / r["n"] / 1e6,
                   "attrs": {k: v / roots for k, v in r["attrs"].items()}}
            for name, r in out.items()}
