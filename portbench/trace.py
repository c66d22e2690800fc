"""The device trace: one `torch.profiler` capture of a bounded run of
steady steps or requests, reduced to intervals.

The device is busy where any kernel, copy or fill runs: the union of their
intervals, so a copy on a side stream that overlaps a kernel counts once.
Kernel classes are taken by name fragment, first match wins. The profiler
at times records only part of a trace, so `whole` takes a capture again
until two agree and each holds every hand kernel the program's counters saw.
"""

from __future__ import annotations

import contextlib
import dataclasses
import typing as tp

import torch

__all__ = ["CATEGORIES", "Trace", "capture", "category", "union", "reduce_events", "whole",
           "covers", "agree"]

WINDOW = "portbench.window"

# kernel-name fragments -> classes, first match wins
CATEGORIES = (("K5", ("fused_forward_kernel",)),
              ("K4", ("aggregate_kernel",)),
              ("K6", ("grad_tables_kernel",)),
              ("K8", ("FactoredGather",)),
              ("K1", ("spectral_grads_kernel",)),
              ("dx", ("spectral_dx_kernel",)),
              ("gemm", ("gemm", "Gemm", "cutlass", "xmma", "sm90_", "sm80_")),
              ("conv", ("conv", "cudnn", "Conv")),
              ("glue", ("elementwise", "Elementwise", "reduce", "Reduce", "copy", "Copy", "cat",
                        "index", "fill")))


def category(name: str) -> str:
    return next((c for c, frags in CATEGORIES if any(fr in name for fr in frags)), "other")


def union(intervals: tp.Iterable[tp.Tuple[float, float]]) -> tp.List[tp.Tuple[float, float]]:
    """The union of (start, end) intervals, sorted and merged."""
    out: tp.List[tp.List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclasses.dataclass
class Trace:
    """A reduced trace (seconds): the window, the device's busy time, device
    seconds and launches by kernel class and by name, and the longest idle
    gaps labelled by the host activity they fell in."""

    units: int
    window_s: float
    busy_s: float
    launches: int
    by_category: tp.Dict[str, float]
    by_name: tp.Dict[str, float]
    idle_gaps: tp.List[tp.Tuple[str, float]]
    by_category_launches: tp.Dict[str, int] = dataclasses.field(default_factory=dict)

    def per_unit_ms(self, cat: str) -> tp.Optional[float]:
        """Device ms a step (or request) of one kernel class; None if absent."""
        s = self.by_category.get(cat)
        return None if s is None else s * 1e3 / self.units

    def breakdown(self) -> dict:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:160], s] for n, s in top],
                "idle_gaps": [[n[:160], s] for n, s in self.idle_gaps[:10]]}


def reduce_events(device: tp.Sequence[tp.Tuple[str, float, float]],
                  host: tp.Sequence[tp.Tuple[str, float, float]],
                  window: tp.Tuple[float, float], units: int) -> Trace:
    """Reduce device events and host spans ((name, start_us, end_us)) inside
    `window` (start_us, end_us) to a `Trace` of `units` steps or requests."""
    w0, w1 = window
    dev = [(n, max(a, w0), min(b, w1)) for n, a, b in device if b > w0 and a < w1]
    busy = union((a, b) for _, a, b in dev)
    by_cat: tp.Dict[str, float] = {}
    by_name: tp.Dict[str, float] = {}
    cat_launches: tp.Dict[str, int] = {}
    launches = 0
    for n, a, b in dev:
        if n.startswith(("Memcpy", "Memset")):
            by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
            continue
        launches += 1
        c = category(n)
        by_cat[c] = by_cat.get(c, 0.0) + (b - a) / 1e6
        cat_launches[c] = cat_launches.get(c, 0) + 1
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), key=lambda g: g[0] - g[1])[:10]
    spans = sorted((a, b, n) for n, a, b in host if n != WINDOW)
    labelled = []
    for a, b in gaps:
        inner = [s for s in spans if s[0] <= a < s[1]]
        label = max(inner)[2] if inner else "host outside any op"
        labelled.append((label, (b - a) / 1e6))
    return Trace(units=units, window_s=(w1 - w0) / 1e6,
                 busy_s=sum(b - a for a, b in busy) / 1e6, launches=launches,
                 by_category=by_cat, by_name=by_name, idle_gaps=labelled,
                 by_category_launches=cat_launches)


@contextlib.contextmanager
def capture(out: list, units: int):
    """Profile the enclosed block (host ops and the card's kernels) inside a
    span named WINDOW that ends after a synchronize; on exit append the
    reduced `Trace` to `out`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        with record_function(WINDOW):
            yield
            torch.cuda.synchronize()
    device, host, window = [], [], None
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith("portbench."):  # the spans' device-side copies
                device.append((e.name, a, b))
        elif e.name == WINDOW:
            window = (a, b)
        elif e.name.startswith(("aten::", "portbench.")):
            host.append((e.name, a, b))
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    out.append(reduce_events(device, host, window, units))


# the program's launch counters -> the trace's class of the kernel each
# launch runs at least once (K2 runs K1's kernel, then the dx kernel)
COUNTED_IN = {"K5": "K5", "K4": "K4", "K6": "K6", "K8": "K8", "K1": "K1", "K2": "K1"}


def covers(t: Trace, counted: tp.Dict[str, int]) -> bool:
    """Whether the trace holds at least one launch of its class for every
    launch of a hand kernel that the program's counters saw."""
    need: tp.Dict[str, int] = {}
    for k, v in counted.items():
        if k in COUNTED_IN:
            need[COUNTED_IN[k]] = need.get(COUNTED_IN[k], 0) + v
    return all(t.by_category_launches.get(c, 0) >= v for c, v in need.items())


def agree(a: Trace, b: Trace, share: float = 0.01) -> bool:
    """Whether two captures of the same work hold the same hand-kernel
    launches and, within `share`, as many launches in all."""
    hand = set(COUNTED_IN.values())
    same = all(a.by_category_launches.get(c, 0) == b.by_category_launches.get(c, 0)
               for c in hand)
    return same and abs(a.launches - b.launches) <= share * max(a.launches, b.launches)


def whole(run_units: tp.Callable[[], None], units: int,
          counters: tp.Callable[[], tp.Dict[str, int]],
          attempts: int = 4) -> tp.Tuple[Trace, tp.Dict[str, float], int]:
    """Capture `run_units` (which runs `units` steps or requests) until a
    capture that `covers` the counters' launches agrees with an earlier one
    that does; return it with the counters' launches a unit and the number
    of captures taken. Raises where
    `attempts` captures give no such pair: a partial trace would read the
    kernels' times low and the device's idle share high."""
    kept: tp.List[Trace] = []
    for taken in range(1, attempts + 1):
        before = counters()
        out: tp.List[Trace] = []
        with capture(out, units):
            run_units()
        counted = {k: v - before[k] for k, v in counters().items()}
        t = out[0]
        if not covers(t, counted):
            continue
        if any(agree(t, k) for k in kept):
            return t, {k: v / units for k, v in counted.items()}, taken
        kept.append(t)
    raise RuntimeError(f"no two of {attempts} traces were whole and agreed "
                       f"(launches: {[k.launches for k in kept]})")
