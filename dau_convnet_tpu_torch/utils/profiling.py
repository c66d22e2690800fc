"""Profiling and timing helpers.

Counterpart of `dau_convnet_tpu/utils/profiling.py`. The reference's
tracing is compile-time `#define PROFILE_CUDA` blocks that synchronize and
clock() each sub-kernel (dau_conv_forward_core.hpp:2506-2562). Here it is a
`torch.profiler` trace (a Chrome trace, viewable in Perfetto) and CUDA-event
timing on the card: PyTorch returns before the device finishes, so a host
clock without a synchronize measures only the enqueue.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import typing as tp

import torch

from . import tracing

__all__ = ["SPAN_PID", "trace", "device_time", "kernel_ms", "device_busy_ms"]

# the Chrome trace's process id of the program's spans: 2**22 lies above
# every Linux pid, so no process of the trace has it
SPAN_PID = 1 << 22


@contextlib.contextmanager
def trace(logdir: tp.Optional[str] = None, device: str = "cuda", host: bool = True):
    """Profile the enclosed block with `torch.profiler` (host activity
    unless `host=False`, and the card's kernels unless `device="cpu"`) and
    yield the profiler. The
    device is synchronized on entry (work queued before the block stays out
    of it) and on exit; when `logdir` is given, a Chrome trace is written
    into it as `trace_<pid>_<ns>.json`. The program's spans recorded inside
    the block (`utils.tracing`, on while the profiler runs) are written into
    that file too, as the process track "program spans" (pid `SPAN_PID`,
    one row a thread, each span's attrs, id and parent in its args), on the
    file's own time base."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if host or device == "cpu" else []
    if device != "cpu":
        activities.append(ProfilerActivity.CUDA)
    # one cycle: acc_events keeps its events (and the profiler's warning
    # that a cycle clears them quiet)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.time_ns()
    with profile(activities=activities, acc_events=True) as prof:
        yield prof
        if device != "cpu":
            torch.cuda.synchronize()
    t1 = time.time_ns()
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir, f"trace_{os.getpid()}_{time.monotonic_ns()}.json")
        prof.export_chrome_trace(path)
        inside = [s for s in tracing.spans() if s.start_ns >= t0 and s.end_ns <= t1]
        if inside:
            with open(path) as f:
                doc = json.load(f)
            doc["traceEvents"] += _span_events(inside, doc.get("baseTimeNanoseconds", 0))
            with open(path, "w") as f:
                json.dump(doc, f)


def _span_events(spans: tp.Sequence["tracing.Span"], base_ns: int) -> tp.List[dict]:
    """The spans as Chrome trace events of the process track `SPAN_PID`,
    one row a thread, on the file's time base (microseconds after
    `base_ns`)."""
    events = [{"ph": "M", "name": "process_name", "pid": SPAN_PID, "tid": 0,
               "args": {"name": "program spans"}}]
    for s in spans:
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": SPAN_PID,
                       "tid": s.thread, "ts": (s.start_ns - base_ns) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {**s.attrs, "id": s.id, "parent": s.parent}})
    return events


def kernel_ms(prof) -> tp.Dict[str, float]:
    """Device ms of each kernel, copy and fill a `trace` recorded, by name:
    the sum of their self device times (empty where it recorded none)."""
    out: tp.Dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key] = out.get(e.key, 0.0) + e.self_device_time_total / 1e3
    return out


def device_busy_ms(prof, fragment: str = "") -> tp.Optional[float]:
    """Device ms of the rows of `kernel_ms` whose name holds `fragment` (all
    of them by default; one stream's kernels do not overlap, so all of them
    is the time the device was busy). None where the trace recorded no
    device time at all."""
    rows = kernel_ms(prof)
    return sum(ms for key, ms in rows.items() if fragment in key) if rows else None


def device_time(fn, *args, iters: int = 10, device: str = "cuda") -> float:
    """Seconds per call of `fn(*args)`: one warm-up call, then CUDA events
    around `iters` calls on the card, or the host clock around them when
    `device="cpu"`. The calls are not chained: eager PyTorch elides no
    repeated call, so each one runs."""
    fn(*args)
    if device == "cpu":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / iters
