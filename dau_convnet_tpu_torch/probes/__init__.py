"""The probes of `benchmarks/` asked again of the card.

`benchmarks/mosaic_probe.py` (P1-P7) and `benchmarks/pallas_ladder.py`
(P8, P9) ask, with small Pallas kernels, what a TPU can do: contract into a
3-D operand, hold a large VMEM scratch, pay for a grid step, run per-bin
batched dots, gather from a table, copy and contract at the DMA rate. Their
counterparts here ask the same of the H100 through the port's hand-written
kernels (`kernels/probe_kernels.py`, and K7's `kernels/spectral.py` for P9):

    python -m dau_convnet_tpu_torch.probes.mosaic_probe [name]
    python -m dau_convnet_tpu_torch.probes.pallas_ladder

Each probe holds its kernel against the plain twin on the probe's inputs
(made from `numpy.random.default_rng(0)` in the JAX probe's order) and, on
the card, times it (CUDA events: the median, min and max of 5 runs of 10
calls) beside its bound, its twin and one PyTorch call of the same
function. A call of a small kernel is paced by the host (the wrapper's
Python and the launch), so each row also gives the device time of the
kernel alone (`torch.profiler`). This module holds what the two scripts
share: the rows they report, the bounds, the timing and the runner.
"""

from __future__ import annotations

import subprocess
import time
import traceback

import numpy as np
import torch

from ..kernels import probe_kernels as pk
from ..kernels import spectral as ksp
from ..utils.profiling import device_time, trace

__all__ = ["PEAK_BF16", "PEAK_F32", "PEAK_BYTES", "KERNELS", "SOURCES", "bound", "nbytes",
           "gb_per_s", "spread", "device_ms", "queued_ms", "card", "close", "tensor", "new_row",
           "format_row", "run_probes"]

# the card's peaks (H100 SXM data sheet, dense, at 700 W): bf16 on the
# tensor cores, f32 on the FP32 units, the memory rate
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12

# the wrappers whose launches the probes count: the probe GEMM, the
# gather, the three stream kernels and K7 (P9)
KERNELS = (pk.probe_gemm, pk.probe_gather, pk.scale_colsum, pk.add_one, pk.copy_tiles,
           ksp.partial_idft)

_CSRC = "dau_convnet_tpu_torch/kernels/csrc/"
# probe -> (the Pallas call it stands for, the source of the port's kernel)
SOURCES = {
    "P1": ("benchmarks/mosaic_probe.py:51", _CSRC + "dau_probe_gemm.cu"),
    "P2": ("benchmarks/mosaic_probe.py:75", _CSRC + "dau_probe_gemm.cu"),
    "P3": ("benchmarks/mosaic_probe.py:96", _CSRC + "dau_probe_stream.cu"),
    "P4": ("benchmarks/mosaic_probe.py:118", _CSRC + "dau_probe_stream.cu"),
    "P5": ("benchmarks/mosaic_probe.py:151", _CSRC + "dau_probe_gemm.cu"),
    "P6": ("benchmarks/mosaic_probe.py:178", _CSRC + "dau_probe_gemm.cu"),
    "P7": ("benchmarks/mosaic_probe.py:214", _CSRC + "dau_probe_gather.cu"),
    "P8": ("benchmarks/pallas_ladder.py:36", _CSRC + "dau_probe_stream.cu"),
    "P9": ("benchmarks/pallas_ladder.py:49", _CSRC + "dau_partial_idft.cu"),
}


def bound(ops: float, nbytes_: float, peak: float = PEAK_BF16):
    """(ms the card needs at least, which of the two sets it): operations
    over `peak` against bytes over the memory rate."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes_ / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def gb_per_s(nbytes_: float, ms: float) -> float:
    return nbytes_ / ms / 1e6


def spread(fn, device: torch.device, iters: int = 10, repeats: int = 5):
    """(median, min, max) ms per call of fn over `repeats` runs of `iters`
    calls, by CUDA events; None off the card (a CPU run times nothing)."""
    if device.type != "cuda":
        return None
    runs = sorted(device_time(fn, iters=iters) * 1e3 for _ in range(repeats))
    return runs[len(runs) // 2], runs[0], runs[-1]


def device_ms(fn, device: torch.device, kernels, iters: int = 10):
    """Device ms per call of fn of the kernels whose name holds one of
    `kernels` ("" for every kernel fn runs), from a device-only
    `torch.profiler` trace of `iters` calls after a warm-up: the kernels
    alone, whatever pace the host sets. A trace counts only where each of
    `kernels` was recorded at least `iters` times; else it is taken again,
    up to 3 times (the profiler at times records none, or only some, of a
    trace's kernels). None off the card or where no trace was whole."""
    if device.type != "cuda":
        return None
    fn()
    for _ in range(3):
        with trace(host=False) as prof:
            for _ in range(iters):
                fn()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if all(sum(e.count for e in rows if k in e.key) >= iters for k in kernels):
            return sum(e.self_device_time_total for e in rows
                       if any(k in e.key for k in kernels)) / 1e3 / iters
    return None


def queued_ms(fn, repeats: int = 5):
    """(median ms of one call of fn at the card's own pace, the host's
    longest enqueue ms): the host queues the call's launches behind a sleep
    kernel of 2^26 cycles (~35-60 ms), so the CUDA events around them time
    the device running them back to back, launch gaps included, as long as
    the enqueue is shorter than the sleep."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    runs, host = [], []
    for _ in range(repeats):
        torch.cuda._sleep(1 << 26)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end))
    return sorted(runs)[len(runs) // 2], max(host)


def card() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def tensor(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a)).to(device=device, dtype=dtype)


def close(what: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """max|got - want|; raises unless it is within tol * max|want| (tol 0:
    the two must be equal)."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)}, twin {tuple(want.shape)}")
    err = float((got.float() - want.float()).abs().max())
    if tol == 0:
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: not equal to its twin, max|err| {err:.3e}")
    elif not err <= tol * float(want.float().abs().max()):
        raise AssertionError(f"{what}: max|err| {err:.3e} > {tol:g} * max|twin| "
                             f"{float(want.float().abs().max()):.3e}")
    return err


def new_row(probe: str, label: str, kernel, err: float, tol: float, work, **timing) -> dict:
    """One reported line: probe id, label, the kernel's wrapper (whose
    launches the runner counts), the error against the twin and its
    tolerance, the bound from `work` = (operations, bytes[, peak]), and
    the timings given (spreads or None): ms, operand_ms, plain_ms,
    library_ms, and device_ms and library_device_ms (the device time of
    the kernel alone and of the library call's kernels, floats or None);
    `library` names the PyTorch call (by default the plain
    twin, and its time), `note` adds what the probe answers."""
    ms, by = bound(*work)
    replaces, source = SOURCES[probe]
    row = dict(probe=probe, label=label, kernel=kernel, replaces=replaces, source=source,
               err=err, tol=tol, bound_ms=ms, bound_by=by, ms=None, device_ms=None,
               operand_ms=None, plain_ms=None, library="the plain twin",
               library_device_ms=None, note="", launches=None)
    row.update(timing)
    row.setdefault("library_ms", row["plain_ms"])
    return row


def _ms(s) -> str:
    return "not measured" if s is None else f"{s[0]:.4f} ms (min {s[1]:.4f}, max {s[2]:.4f})"


def format_row(row: dict, card_name: str | None) -> str:
    tol = "exact" if row["tol"] == 0 else f"<= {row['tol']:g}*max|twin|"
    parts = [f"{row['probe']} {row['label']} [{row['kernel'].__name__}]: max|err| "
             f"{row['err']:.3e} ({tol})", f"kernel {_ms(row['ms'])}"]
    if row["device_ms"] is not None:
        parts.append(f"device time of the kernel alone {row['device_ms']:.4f} ms")
    if row["operand_ms"] is not None:
        parts.append(f"operands apart {_ms(row['operand_ms'])}")
    parts += [f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})", f"twin {_ms(row['plain_ms'])}",
              f"{row['library']} {_ms(row['library_ms'])}"]
    if row["library_device_ms"] is not None:
        parts.append(f"its device time {row['library_device_ms']:.4f} ms")
    if row["launches"] is not None:
        parts.append(f"{row['launches']} launches")
    if row["note"]:
        parts.append(row["note"])
    return "; ".join(parts) + (f" [{card_name}]" if card_name else " [cpu: no device times]")


def run_probes(tests, only, device: torch.device, trace: bool = False):
    """Run each (name, fn(device) -> rows) of `tests` whose name holds
    `only` (all where None), print a PASS or FAIL line for each probe and a
    line for each of its rows; returns (every probe passed, the rows). A
    row's `launches` is its kernel's launches over its probe's run."""
    card_name = card() if device.type == "cuda" else None
    ok, rows = True, []
    for name, fn in tests:
        if only and only not in name:
            continue
        before = {k: k.launches for k in KERNELS}
        try:
            got = fn(device)
            if device.type == "cuda":
                torch.cuda.synchronize()
        except Exception as e:  # a probe's failure is reported, and fails the run
            ok = False
            msg = str(e).split("\n")[0][:300]
            print(f"FAIL {name}: {type(e).__name__}: {msg}", flush=True)
            if trace:
                traceback.print_exc()
            continue
        print(f"PASS {name}", flush=True)
        for row in got:
            row["launches"] = row["kernel"].launches - before[row["kernel"]]
            print(f"  {format_row(row, card_name)}", flush=True)
        rows += got
    return ok, rows
