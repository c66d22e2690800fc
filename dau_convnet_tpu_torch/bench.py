"""Benchmark of the port: AlexNet-DAU training and serving, a long-run
memtest and one DAU layer, each against a plain-conv baseline, on one CUDA
card.

    python -m dau_convnet_tpu_torch.bench [--model alexnet|inference|memtest|layer] ...

Run it from the root of a checkout. Counterpart of the JAX repo's
`bench.py`: the same flags, cells, metric names and JSON schema. Each cell
prints one JSON line {"metric", "value", "unit", "vs_baseline", "detail"};
`detail.device` names the card and its power limit as `nvidia-smi` gives
them.

- `--model alexnet` (the default): one SGD step (lr 1e-4) of AlexNet-DAU,
  `--variant default` at N=32, 3x227x227, bf16, `engine="fourier"`, in
  images/s, against the same net with 3x3 convolutions. After the headline
  prints, the small and large variants, N=128 and the serving cell each run
  in a child process with a timeout (a CUDA fault is sticky for its process
  and a kernel may hang), and the headline is printed again, enriched,
  after each.
- `--model inference`: the serving forward with the phase tables cached
  (`phi_caching=True` after `refresh_phi_cache`), beside the plain DAU
  forward and the 3x3 conv net's forward.
- `--model memtest`: 2,000 chained SGD steps of one DAU layer on 6x6
  planes with |mu| drawn up to 10 and clipped to 3.9 on every step, the
  port's analogue of the reference's `test_DAUConvMemtest`.
- `--model layer`: one DAU layer's forward and backward (N32, S128,
  16x16, F32, 2x1 units) against a 3x3 conv's, on `--engine` (default
  'xla' in f32 "highest"), with `--static-max-offset` as the layer's
  tap bound.

Times are CUDA events around `--iters` steps, taken 5 times (3 under a
tight budget): the median, with every run's per-step ms under `*_pairs_ms`
(the JAX bench's names) and their min and max. The training steps of
`--model alexnet` come from `make_train_step`, which replays a step as one
CUDA graph after its first calls, so `time_steps` times replays there; the
other cells' calls are eager and paced by the host, as a user's are.
`device_busy_ms` is the device time of one profiled step. Without a CUDA
device the bench exits non-zero, unless `--device cpu` asks for a smoke
test of the code path, whose numbers are host times and not the card's.
The top-level process only watches a child that does the work
(`DAU_BENCH_TOTAL_BUDGET_S`, default 1500 s) and prints a null-valued line
if the child printed none; `DAU_BENCH_NO_GUARD=1` runs the work in-process.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .models import ALEXNET_DAU_VARIANTS, AlexNetDAU
from .models._common import Affine
from .nn.layers import _clip, refresh_phi_cache
from .ops import DAUConvSettings, dau_conv2d_op
from .ops._precision import conv_precision
from .parallel import make_train_step
from .utils.profiling import device_busy_ms, device_time, trace

_MODULE = "dau_convnet_tpu_torch.bench"
# the directory that holds the package: the child processes run from it, so
# they import this same tree
_ROOT = Path(__file__).resolve().parents[1]
_T0 = time.monotonic()

# dense bf16 tensor-core peak (no sparsity) by torch.cuda.get_device_name():
# NVIDIA's H100 SXM data sheet
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989.4e12}

IMAGE = 227
# (S, F, H=W) of AlexNet-DAU's DAU layers at 227x227
_LAYER_PX = ((96, 256, 27), (256, 384, 13), (384, 384, 13), (384, 256, 13))


def _total_budget_s() -> float:
    """Wall-clock budget of the whole bench (default 25 min)."""
    return float(os.environ.get("DAU_BENCH_TOTAL_BUDGET_S", 1500))


def _remaining_s() -> float:
    return _total_budget_s() - (time.monotonic() - _T0)


def _repeats() -> int:
    """Timed runs per measurement: 5, or 3 under a tight budget."""
    return 5 if _remaining_s() > 600 else 3


def _default_engine(model: str) -> str:
    """The Fourier engine for the model cells (the system's bf16 default);
    the f32 layer cell keeps the dense engine ("highest", oracle-exact)."""
    return "fourier" if model in ("alexnet", "inference") else "xla"


def _device(args) -> torch.device:
    if args.device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device; it measures the card only "
                         "(--device cpu smoke-tests the code path on the CPU)")
    return torch.device("cuda")


def _dtype(args) -> torch.dtype:
    return torch.bfloat16 if args.dtype == "bf16" else torch.float32


def device_label(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or 'cpu'."""
    if dev.type == "cpu":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"{torch.cuda.get_device_name()}, power limit not read ({type(e).__name__})"


def time_steps(fn, iters: int, dev: torch.device, repeats: int):
    """(median seconds per call, per-call ms of each run): `repeats` runs of
    `device_time(fn, iters=iters)`, CUDA events on the card."""
    times = [device_time(fn, iters=iters, device=dev.type) for _ in range(repeats)]
    return sorted(times)[len(times) // 2], [round(t * 1e3, 4) for t in times]


def _spread(tag: str, pairs_ms) -> dict:
    return {f"{tag}_min_ms": min(pairs_ms), f"{tag}_max_ms": max(pairs_ms)}


def _busy_ms(fn, dev: torch.device):
    """Device-busy ms of one call of fn under the profiler, after a warm-up
    (None on the CPU, or where the profiler recorded no device time)."""
    if dev.type == "cpu":
        return None
    fn()
    with trace() as prof:
        fn()
    busy = device_busy_ms(prof)
    return None if busy is None else round(busy, 3)


def gather_flops(variant: str, n: int) -> int:
    """Algorithmic (gather-semantics) FLOPs of the DAU layers per step: the
    reference's 4-tap gather, forward + input grad + 3 derivative tables, 2
    FLOPs a MAC, at the variant's published units (before the rounding to
    groups of 2)."""
    units = ALEXNET_DAU_VARIANTS[variant]
    g_units = units[0] * units[1]
    taps = 4
    return sum(2 * n * s * g_units * f * hw * hw * taps * 5 for s, f, hw in _LAYER_PX)


def _peak(dev: torch.device):
    """(dense bf16 peak FLOP/s of the card, or None and why)."""
    if dev.type == "cpu":
        return None, "no card: the bench ran on the CPU"
    name = torch.cuda.get_device_name()
    peak = PEAK_BF16_FLOPS.get(name)
    return peak, None if peak else f"no bf16 peak known for {name!r}"


class AlexNetConv(nn.Module):
    """The baseline: AlexNet-DAU's widths with 3x3 SAME convolutions in
    place of the DAU layers (conv1 11x11 stride 4 VALID, 3/2 max-pools,
    fc6-fc8), run by cuDNN and cuBLAS. Its weights are f32 and cast to
    `dtype` per call, as AlexNetDAU's conv1 and dense layers (and flax's
    `dtype=`) do."""

    def __init__(self, dtype, device, generator, num_classes: int = 1000):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Affine((96, 3, 11, 11), 3 * 11 * 11, device, generator)
        widths = ((96, 256, True), (256, 384, False), (384, 384, False), (384, 256, True))
        self.convs = nn.ModuleList(Affine((f, s, 3, 3), 9 * s, device, generator)
                                   for s, f, _ in widths)
        self.pools = tuple(pool for *_, pool in widths)
        fc_in = 256 * 6 * 6  # 227 -> 55 -> 27 -> 13 -> 6
        self.fc6 = Affine((4096, fc_in), fc_in, device, generator)
        self.fc7 = Affine((4096, 4096), 4096, device, generator)
        self.fc8 = Affine((num_classes, 4096), 4096, device, generator)

    def forward(self, x):
        dt = self.dtype
        x = F.max_pool2d(F.relu(self.conv1.conv(x, dt, stride=4)), 3, 2)
        for conv, pool in zip(self.convs, self.pools):
            x = F.relu(conv.conv(x, dt, padding=1))
            if pool:
                x = F.max_pool2d(x, 3, 2)
        x = x.reshape(x.shape[0], -1)
        x = F.relu(self.fc6.dense(x, dt))
        x = F.relu(self.fc7.dense(x, dt))
        return self.fc8.dense(x, dt)


def _images(n: int, dtype, dev):
    """Random images and labels from np.random.default_rng(0)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((n, 3, IMAGE, IMAGE))).to(dev, dtype)
    labels = torch.from_numpy(rng.integers(0, 1000, (n,))).to(dev)
    return x, labels


def _alexnet_dau(args, dtype, dev, **kw):
    return AlexNetDAU(variant=args.variant, engine=args.engine, fused_bwd=args.fused_bwd,
                      fused_dx=args.fused_dx, fused_gather=args.fused_gather, dtype=dtype,
                      image_size=IMAGE, device=dev,
                      generator=torch.Generator().manual_seed(0), **kw)


def _measure_variant_subprocess(vname, args, t_conv, _run=None, extra=(),
                                own_baseline=False, raw=False):
    """Measure one AlexNet-DAU variant in a child process with a timeout.

    The headline is printed before this runs; a CUDA fault (sticky for its
    process) or a hung kernel in a variant must not take it down, so each
    variant gets its own process and a hard timeout (capped by the
    remaining total budget). Returns the variants[] entry and never raises
    (errors come back as {"error": ...}). `extra` appends argv (e.g. another
    --N); `own_baseline=True` takes the child's own vs_baseline (its conv
    ran at its batch size); `raw=True` forwards the child's value,
    vs_baseline and detail as they are (modes with another detail schema,
    --model inference). `_run` injects a subprocess.run stand-in for tests.
    """
    run = _run or subprocess.run
    try:
        env = dict(os.environ, DAU_BENCH_ALL_VARIANTS="0")
        cmd = [sys.executable, "-m", _MODULE,
               "--variant", vname, "--engine", args.engine,
               "--fused-bwd", args.fused_bwd,
               "--fused-dx", args.fused_dx,
               "--fused-gather", args.fused_gather,
               "--iters", str(args.iters)] + list(extra)
        timeout = min(float(os.environ.get("DAU_BENCH_VARIANT_TIMEOUT_S", 2400)),
                      max(60.0, _remaining_s() - 60))
        r = run(cmd, capture_output=True, text=True, env=env, timeout=timeout, cwd=_ROOT)
        line = next((ln for ln in reversed(r.stdout.splitlines()) if ln.startswith("{")), None)
        if line is None:
            tail = (r.stderr or r.stdout).strip().splitlines()
            raise RuntimeError(f"variant subprocess rc={r.returncode}: "
                               f"{tail[-1] if tail else 'no output'}")
        sub = json.loads(line)
        if raw:
            det = dict(sub.get("detail", {}))
            det.pop("device", None)
            return {"images_per_sec": sub["value"], "vs_baseline": sub["vs_baseline"], **det}
        det = sub["detail"]
        out = {
            "images_per_sec": sub["value"],
            "dau_step_ms": det["dau_step_ms"],
            # against the headline run's conv median, so that the variants
            # share one baseline (but own_baseline runs, see above)
            "vs_baseline": sub["vs_baseline"] if own_baseline else round(
                t_conv * 1e3 / det["dau_step_ms"], 4),
            "dau_step_pairs_ms": det["dau_step_pairs_ms"],
            "dau_units": det["dau_units"],
        }
        out.update({k: det[k] for k in ("device_busy_ms", "dau_peak_memory_gib") if k in det})
        if own_baseline:
            out["conv3x3_step_ms"] = det["conv3x3_step_ms"]
        return out
    except Exception as e:  # noqa: BLE001 - the headline's record must survive
        return {"error": f"{type(e).__name__}: {e}"[:300]}


def bench_alexnet(args):
    """One AlexNet-DAU training step (forward, loss, backward, SGD) in
    images/s against the same net with 3x3 convolutions."""
    dev, dtype = _device(args), _dtype(args)
    n = args.N
    x, labels = _images(n, dtype, dev)
    repeats = _repeats()

    dau = _alexnet_dau(args, dtype, dev)
    dau_units = dau.num_dau_units()
    step = make_train_step(dau, torch.optim.SGD(dau.parameters(), lr=1e-4))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_dau, dau_pairs = time_steps(lambda: step(x, labels), args.iters, dev, repeats)
    peak_gib = (round(torch.cuda.max_memory_allocated() / 2**30, 3) if dev.type == "cuda"
                else None)
    busy = _busy_ms(lambda: step(x, labels), dev)
    del dau, step

    conv = AlexNetConv(dtype, dev, torch.Generator().manual_seed(0))
    cstep = make_train_step(conv, torch.optim.SGD(conv.parameters(), lr=1e-4))
    t_conv, conv_pairs = time_steps(lambda: cstep(x, labels), args.iters, dev, repeats)
    del conv, cstep

    peak, why = _peak(dev)
    detail = {
        "dau_step_ms": round(t_dau * 1e3, 3),
        "conv3x3_step_ms": round(t_conv * 1e3, 3),
        "dau_step_pairs_ms": dau_pairs,
        "conv3x3_step_pairs_ms": conv_pairs,
        **_spread("dau_step", dau_pairs),
        **_spread("conv3x3_step", conv_pairs),
        "device_busy_ms": busy,
        # the most device memory the DAU steps held (model, batch, optimizer)
        "dau_peak_memory_gib": peak_gib,
        "dau_units": dau_units,
        "engine": args.engine,
        # algorithmic MFU: reference-gather FLOPs / time / the card's bf16 peak
        "gather_mfu_pct": None if peak is None else round(
            gather_flops(args.variant, n) / t_dau / peak * 100, 2),
        "device": device_label(dev),
    }
    if why:
        detail["gather_mfu_note"] = why
    headline = {
        "metric": f"alexnet_dau_{args.variant}_trainstep_images_per_sec(N{n},227x227,{args.dtype})",
        "value": round(n / t_dau, 1),
        "unit": "images/sec",
        "vs_baseline": round(t_conv / t_dau, 4),
        "detail": detail,
    }
    # the headline prints the moment it exists; each variant below prints
    # it again, enriched, so the last line is always a whole record
    print(json.dumps(headline), flush=True)

    if (args.variant == "default" and n == 32 and dev.type != "cpu"
            and os.environ.get("DAU_BENCH_ALL_VARIANTS", "1") != "0"):
        variants = {}
        # the last entries go first under a tight budget; inference (own
        # conv-forward baseline, another detail schema) rides along raw
        plan = (("small", "small", (), False, False),
                ("large", "large", (), False, False),
                ("N128", "default", ("--N", "128"), True, False),
                ("inference", "default", ("--model", "inference"), True, True))
        for key, vname, extra, own, raw in plan:
            if _remaining_s() < 240:
                variants[key] = {"skipped": f"budget ({_remaining_s():.0f}s left)"}
            else:
                variants[key] = _measure_variant_subprocess(
                    vname, args, t_conv, extra=extra, own_baseline=own, raw=raw)
            headline["detail"]["variants"] = dict(variants)
            print(json.dumps(headline), flush=True)


def bench_alexnet_inference(args):
    """Serving throughput: AlexNet-DAU's forward to the logits, in images/s.

    Three forwards: the 3x3 conv net's, the plain DAU forward (phase tables
    built per call, as in training) and the serving forward with the phase
    tables built once from the frozen weights (`phi_caching=True` and
    `refresh_phi_cache`). The value is the serving forward's; vs_baseline
    is the conv forward's time over it."""
    dev, dtype = _device(args), _dtype(args)
    n = args.N
    x, _ = _images(n, dtype, dev)
    repeats = _repeats()
    with torch.inference_mode():
        dau = _alexnet_dau(args, dtype, dev)
        t_plain, plain_pairs = time_steps(lambda: dau(x), args.iters, dev, repeats)
        del dau
        cached = refresh_phi_cache(_alexnet_dau(args, dtype, dev, phi_caching=True), x)
        t_serving, serving_pairs = time_steps(lambda: cached(x), args.iters, dev, repeats)
        busy = _busy_ms(lambda: cached(x), dev)
        del cached
        conv = AlexNetConv(dtype, dev, torch.Generator().manual_seed(0))
        t_conv, conv_pairs = time_steps(lambda: conv(x), args.iters, dev, repeats)

    print(json.dumps({
        "metric": (f"alexnet_dau_{args.variant}_inference_images_per_sec"
                   f"(N{n},227x227,{args.dtype},phi_cached)"),
        "value": round(n / t_serving, 1),
        "unit": "images/sec",
        "vs_baseline": round(t_conv / t_serving, 4),
        "detail": {
            "dau_serving_ms": round(t_serving * 1e3, 3),
            "dau_plain_fwd_ms": round(t_plain * 1e3, 3),
            "conv3x3_fwd_ms": round(t_conv * 1e3, 3),
            "phi_cache_speedup": round(t_plain / t_serving, 3),
            "dau_serving_pairs_ms": serving_pairs,
            "dau_plain_fwd_pairs_ms": plain_pairs,
            "conv3x3_fwd_pairs_ms": conv_pairs,
            **_spread("dau_serving", serving_pairs),
            "device_busy_ms": busy,
            "engine": args.engine,
            "device": device_label(dev),
        },
    }), flush=True)


class SGDStep:
    """One chained step of the layer cells: the gradients of
    vdot(dau_conv2d_op(x, w, clip(mu1), clip(mu2), sigma), err) (the vjp
    of the op's output with err) with respect to (x, w, mu1, mu2), each
    tensor less lr times its gradient. `grads(carry)` gives the gradients
    alone."""

    def __init__(self, cfg, sigma, err, bound, lr):
        self.cfg, self.sigma, self.err, self.bound, self.lr = cfg, sigma, err, bound, lr

    def grads(self, carry):
        x, w, mu1, mu2 = (a.detach().requires_grad_() for a in carry)
        b = self.bound
        y = dau_conv2d_op(self.cfg, x, w, _clip(mu1, -b, b), _clip(mu2, -b, b), self.sigma)
        return torch.autograd.grad(y, (x, w, mu1, mu2), grad_outputs=self.err)

    def __call__(self, carry):
        grads = self.grads(carry)
        with torch.no_grad():
            return [a - self.lr * g.to(a.dtype) for a, g in zip(carry, grads)]


def memtest_setup(dtype, dev, n: int = 32, s: int = 128, f: int = 256, hw: int = 6):
    """(step, carry) of the memtest: N=32, S=128, F=256, G=2 on 6x6 planes
    by default, inputs from np.random.default_rng(0), mu uniform in +-10
    (beyond the kernel, so the clip to +-3.9 runs), kernel_size 9, no sigma
    gradient, lr 1e-5."""
    g = 2
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dev, dtype)

    x = t(rng.random((n, s, hw, hw)))
    err = t(rng.standard_normal((n, f, hw, hw)))
    w = t(rng.standard_normal((1, s, g, f)) * 0.1)
    # beyond-bounds init exercises the clip path (reference inits +-10 on k=9)
    mu1 = t(rng.uniform(-10, 10, (1, s, g, f)))
    mu2 = t(rng.uniform(-10, 10, (1, s, g, f)))
    sigma = torch.full((1,), 0.5, dtype=dtype, device=dev)
    cfg = DAUConvSettings(kernel_size=9, compute_sigma_grad=False,
                          precision="default" if dtype == torch.bfloat16 else "highest")
    lr = torch.tensor(1e-5, dtype=dtype, device=dev)
    return SGDStep(cfg, sigma, err, 4 - 0.1, lr), [x, w, mu1, mu2]


def bench_memtest(args):
    """Long-run stability: `--iters` (2,000) chained steps with the clip path
    running, timed from the same start after a warm-up of 3 steps; reports
    whether every tensor stayed finite. The port's analogue of the
    reference's `test_DAUConvMemtest` (10k re-runs with offsets initialized
    beyond bounds, dau_conv_test.py:635-682)."""
    dev, dtype = _device(args), _dtype(args)
    step, carry = memtest_setup(dtype, dev)
    iters = args.iters or 2000
    warm = carry
    for _ in range(3):
        warm = step(warm)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = carry
    for _ in range(iters):
        out = step(out)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(a.float()).all()) for a in out)
    print(json.dumps({
        "metric": f"memtest_steps_per_sec({iters}_chained_steps,{args.dtype})",
        "value": round(iters / dt, 1),
        "unit": "steps/sec",
        "vs_baseline": 1.0 if finite else 0.0,
        "detail": {"all_finite": finite, "total_s": round(dt, 2),
                   "device": device_label(dev)},
    }), flush=True)


def layer_setup(n, s, f, hw, dtype, engine, static_max_offset, dev):
    """(dau_step, dau_carry, conv_step, conv_carry) of the layer cell: one
    DAU layer of 2x1 units (G=2, kernel_size 9, no sigma gradient, mu
    learning-rate factor 1, mu drawn within min(3, static_max_offset))
    against a 3x3 conv of the same shapes, each a chained SGD step (lr
    1e-6) on vdot(y, err); inputs from np.random.default_rng(0)."""
    g = 2
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dev, dtype)

    x = t(rng.random((n, s, hw, hw)))
    err = t(rng.standard_normal((n, f, hw, hw)))
    w = t(rng.standard_normal((1, s, g, f)) * 0.1)
    # offsets honour the static promise (the op clips |mu| to it); the
    # reference speedtest inits +-3 on k=9
    mu_init = min(3.0, static_max_offset)
    mu1 = t(rng.uniform(-mu_init, mu_init, (1, s, g, f)))
    mu2 = t(rng.uniform(-mu_init, mu_init, (1, s, g, f)))
    sigma = torch.full((1, s, g, f), 0.5, dtype=dtype, device=dev)
    precision = "highest" if dtype == torch.float32 else "default"
    cfg = DAUConvSettings(kernel_size=9, mu_learning_rate_factor=1.0,
                          static_max_offset=static_max_offset, compute_sigma_grad=False,
                          precision=precision, engine=engine)
    lr = torch.tensor(1e-6, dtype=dtype, device=dev)
    k3 = t(rng.standard_normal((f, s, 3, 3)) * 0.1)

    def conv_step(carry):
        xc, k = (a.detach().requires_grad_() for a in carry)
        with conv_precision(precision):
            y = F.conv2d(xc, k, padding=1)
            grads = torch.autograd.grad(y, (xc, k), grad_outputs=err)
        with torch.no_grad():
            return [a - lr * gr for a, gr in zip((xc, k), grads)]

    return SGDStep(cfg, sigma, err, 4 - 0.01, lr), [x, w, mu1, mu2], conv_step, [x, k3]


def _chained(step, carry):
    """A call that advances `carry` (a list) by one step in place."""
    def run():
        carry[:] = step(carry)
    return run


def bench_layer(args):
    """One DAU layer's forward and backward against a 3x3 conv's (the
    reference's `test_DAUConvSpeedTest`, dau_conv_test.py:504-628)."""
    dev, dtype = _device(args), _dtype(args)
    n, s, f, hw = args.N, args.S, args.F, args.HW
    dau_step, dau_carry, conv_step, conv_carry = layer_setup(
        n, s, f, hw, dtype, args.engine, args.static_max_offset, dev)
    repeats = _repeats()
    t_dau, dau_pairs = time_steps(_chained(dau_step, dau_carry), args.iters, dev, repeats)
    busy = _busy_ms(_chained(dau_step, dau_carry), dev)
    t_conv, conv_pairs = time_steps(_chained(conv_step, conv_carry), args.iters, dev, repeats)
    off_tag = (f",off{args.static_max_offset:g}" if args.static_max_offset != 3.0 else "")
    print(json.dumps({
        "metric": (f"dau_layer_fwdbwd_images_per_sec(N{n},S{s},{hw}x{hw},F{f},2x1units,k9,"
                   f"{args.dtype},{args.engine}{off_tag})"),
        "value": round(n / t_dau, 1),
        "unit": "images/sec",
        "vs_baseline": round(t_conv / t_dau, 4),
        "detail": {
            "dau_ms": round(t_dau * 1e3, 4),
            "conv3x3_ms": round(t_conv * 1e3, 4),
            "dau_pairs_ms": dau_pairs,
            "conv3x3_pairs_ms": conv_pairs,
            **_spread("dau", dau_pairs),
            **_spread("conv3x3", conv_pairs),
            "device_busy_ms": busy,
            "device": device_label(dev),
        },
    }), flush=True)


def _run_guarded(argv, _cmd=None) -> int:
    """Run the bench in a watched child and make sure that stdout ends with
    a parseable JSON line however the child ends.

    The child's lines stream through as they arrive; the child is killed
    past the total budget + 180 s. If it printed no JSON line, the guard
    prints the null-valued one itself. Returns the exit code: 0 when the
    last JSON line has a value. `_cmd` replaces the child's command (tests).
    """
    import threading

    budget = _total_budget_s() + 180
    env = dict(os.environ, DAU_BENCH_CHILD="1")
    proc = subprocess.Popen(_cmd or [sys.executable, "-m", _MODULE, *argv],
                            stdout=subprocess.PIPE, text=True, env=env, bufsize=1, cwd=_ROOT)
    emitted = []

    def pump():
        for line in proc.stdout:
            line = line.rstrip("\n")
            if not line:
                continue
            print(line, flush=True)
            if line.startswith("{"):
                emitted.append(line)

    th = threading.Thread(target=pump, daemon=True)
    th.start()
    try:
        rc = proc.wait(timeout=budget)
    except subprocess.TimeoutExpired:
        print(f"bench guard: child overran {budget:.0f}s budget, killing", file=sys.stderr)
        proc.kill()
        proc.wait()
        rc = None
    th.join(timeout=30)
    if not emitted:
        print(json.dumps({
            "metric": "alexnet_dau_default_trainstep_images_per_sec",
            "value": None, "unit": "images/sec", "vs_baseline": None,
            "error": f"bench child rc={rc} produced no JSON line"
                     + (f" within {budget:.0f}s" if rc is None else ""),
        }), flush=True)
        return 1
    try:
        ok = json.loads(emitted[-1]).get("value") is not None
    except ValueError:
        ok = False
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0], allow_abbrev=False)
    ap.add_argument("--N", type=int, default=32)
    ap.add_argument("--S", type=int, default=128)
    ap.add_argument("--F", type=int, default=32)
    ap.add_argument("--HW", type=int, default=16)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--dtype", default=None, choices=["f32", "bf16"])
    ap.add_argument("--engine", default=None,
                    choices=["xla", "fourier", "pallas", "pallas_fused"])
    ap.add_argument("--model", default="alexnet",
                    choices=["layer", "alexnet", "inference", "memtest"])
    ap.add_argument("--variant", default="default", choices=["small", "default", "large"])
    ap.add_argument("--fused-bwd", dest="fused_bwd", default="auto",
                    choices=["auto", "on", "off"])
    ap.add_argument("--fused-dx", dest="fused_dx", default="auto",
                    choices=["auto", "on", "off"])
    ap.add_argument("--fused-gather", dest="fused_gather", default="phi",
                    choices=["phi", "factored", "auto"])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cpu = smoke-test the bench's code path without a card "
                         "(host times, not the card's)")
    ap.add_argument("--static-max-offset", dest="static_max_offset", type=float, default=3.0,
                    help="layer model only: the layer's static tap bound (the stand-in "
                         "for the reference's runtime tier dispatch); smaller = a smaller "
                         "synthesized kernel. Measures what re-tiering pays "
                         "(utils.tiers.retier_offset).")
    args = ap.parse_args(argv)

    if args.dtype is None:
        # bf16 for the model cells; oracle-exact f32 for the layer cell
        args.dtype = "f32" if args.model == "layer" else "bf16"
    if args.engine is None:
        args.engine = _default_engine(args.model)
    if args.iters is None:
        args.iters = {"alexnet": 20, "layer": 100, "memtest": 2000,
                      "inference": 50}[args.model]

    {"alexnet": bench_alexnet, "inference": bench_alexnet_inference,
     "memtest": bench_memtest, "layer": bench_layer}[args.model](args)


if __name__ == "__main__":
    # the top-level process only watches; the work runs in the child
    # (DAU_BENCH_CHILD=1). DAU_BENCH_NO_GUARD=1 runs it in-process.
    if (os.environ.get("DAU_BENCH_CHILD") != "1"
            and os.environ.get("DAU_BENCH_NO_GUARD") != "1"):
        sys.exit(_run_guarded(sys.argv[1:]))
    main()
