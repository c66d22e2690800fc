"""Chip smoke test of the PyTorch port: AlexNet-DAU serving and training on
one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of the repository, on a machine with a CUDA card. Phases:

1. build: compile the three kernels for sm_90a, one nvcc each, all at once
   (K5 the fused forward, K4 the aggregation, K6 the grad tables), and print
   their registers and spills at ks=9;
2. kernel vs twin: `dau_forward_fused` against `dau_forward_fused_plain` at
   the four AlexNet-DAU layer shapes (N=4) in f32 (TF32 off, bound
   1e-4*max|y|) and bf16 (twin in f32 on the same bf16 values, bound
   1e-2*max|y|, about one bf16 rounding of the output), plus an edge case
   with mu at +-max_offset and at integers;
3. serving: the default-variant AlexNet-DAU in bf16 with engine
   'pallas_fused', random weights from --seed, answers 3 requests of 32
   images at 3x227x227; the kernel's launch count must rise by 4 (one per
   DAU layer) per request and the logits must be finite;
4. reference: the same weights in f32, through the kernel and through the
   plain twins, must agree within 1e-3*max|logits|;
5. timing: CUDA-event times of each layer's kernel and twin at N=32, and of
   a whole request through either, beside the card's name and power limit;
6. backward kernels vs twins at the four layer shapes (N=4), f32 and bf16:
   K6 with M=3 (bound 1e-4*max|table|: f32 sums of N*H*W products in
   another order), K4 (bounds as K5's), and K5 at the four transposed dx
   shapes with the mirrored 'error' filter;
7. training: the default-variant AlexNet-DAU in bf16 takes 3 SGD steps
   (lr 1e-4) on batches of 32 images at 3x227x227 through
   `make_train_step`, first with engine 'pallas_fused' (8 K5 + 4 K6
   launches per step), then with 'pallas' (8 K4 + 4 K6 per step); per step
   the loss must be finite, every trainable parameter must get a finite
   nonzero gradient and take the SGD update (old - lr*grad, rounded once to
   its dtype, within two ulps);
8. reference: one f32 step from the same weights, through the kernels and
   through the plain twins, per engine: every parameter's gradient must
   agree within 1e-3*max|grad| of that tensor;
9. timing: per-layer K6, K4 and dx-shape K5 against their twins at N=32
   bf16, and a whole bf16 training step through the kernels and through the
   twins, per engine.

The second-to-last line is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; so
does a machine without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import dau_convnet_tpu_torch  # noqa: E402
from dau_convnet_tpu_torch.kernels import backward as kbwd  # noqa: E402
from dau_convnet_tpu_torch.kernels import forward as kfwd  # noqa: E402
from dau_convnet_tpu_torch.kernels._build import build, build_log  # noqa: E402
from dau_convnet_tpu_torch.models import AlexNetDAU  # noqa: E402
from dau_convnet_tpu_torch.ops import DAUConvSettings, gaussian_filters  # noqa: E402
from dau_convnet_tpu_torch.parallel import make_train_step  # noqa: E402

KERNEL = dict(name="dau_forward_fused", route="cuda",
              source="dau_convnet_tpu_torch/kernels/csrc/dau_forward_fused.cu",
              replaces="dau_convnet_tpu/kernels/forward.py:209")
KERNEL_K6 = dict(name="grad_tables", route="cuda",
                 source="dau_convnet_tpu_torch/kernels/csrc/dau_grad_tables.cu",
                 replaces="dau_convnet_tpu/kernels/backward.py:74")
KERNEL_K4 = dict(name="aggregate_forward", route="cuda",
                 source="dau_convnet_tpu_torch/kernels/csrc/dau_aggregate.cu",
                 replaces="dau_convnet_tpu/kernels/forward.py:129")
LIBRARIES = ("dau_forward_fused", "dau_aggregate", "dau_grad_tables")
# (name, S, F, H=W) of the AlexNet-DAU DAU layers at 227x227 input
LAYERS = (("conv2", 96, 256, 27), ("conv3", 256, 384, 13),
          ("conv4", 384, 384, 13), ("conv5", 384, 256, 13))
G = 2
BATCH, IMAGE, REQUESTS = 32, 227, 3
STEPS, LR, M = 3, 1e-4, 3


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def _cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _layer_inputs(gen, n, s, f, hw, dtype, dev, mu=None):
    x = torch.rand((n, s, hw, hw), generator=gen).to(dev, dtype)
    w = (torch.randn((s, G, f), generator=gen) * 0.1).to(dev, dtype)
    if mu is None:
        mu1, mu2 = (torch.rand((2, s, G, f), generator=gen) * 7.98 - 3.99).to(dev, dtype)
    else:
        idx = torch.randint(0, len(mu), (2, s, G, f), generator=gen)
        mu1, mu2 = torch.tensor(mu)[idx].to(dev, dtype)
    return x, w, mu1, mu2


def compare(gen, dev, filt, ks):
    """Kernel vs twin at each layer shape; returns the largest |error|."""
    worst = 0.0
    edge = DAUConvSettings().max_offset
    cases = [(name, s, f, hw, None) for name, s, f, hw in LAYERS]
    cases.append(("conv2-edge-mu", 96, 256, 27, [-edge, edge, -3.0, 0.0, 1.0, 3.0]))
    for name, s, f, hw, mu in cases:
        for dtype, bound in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            x, w, mu1, mu2 = _layer_inputs(gen, 4, s, f, hw, dtype, dev, mu)
            y = kfwd.dau_forward_fused(x, w, mu1, mu2, filt, ks)
            want = kfwd.dau_forward_fused_plain(x.float(), w, mu1, mu2, filt, ks)
            torch.cuda.synchronize()
            if y.dtype != dtype or y.shape != want.shape:
                raise AssertionError(f"{name}: got {y.dtype} {tuple(y.shape)}")
            err = float((y.float() - want).abs().max())
            scale = float(want.abs().max())
            print(f"compare {name} {str(dtype)[6:]}: max|err|={err:.3e} "
                  f"max|y|={scale:.3e} bound={bound * scale:.3e}")
            if not err <= bound * scale:
                raise AssertionError(f"{name} {dtype}: kernel disagrees with the twin")
            worst = max(worst, err)
    return worst


@contextlib.contextmanager
def plain_twin():
    """Route the op's kernel calls (K5, K4, K6) to their plain twins (for
    timing and the reference runs); the launch counters are left alone."""
    routes = ((kfwd, "dau_forward_fused", kfwd.dau_forward_fused_plain),
              (kfwd, "aggregate_forward", kfwd.aggregate_forward_plain),
              (kbwd, "grad_tables", kbwd.grad_tables_plain))
    kernels = [getattr(mod, name) for mod, name, _ in routes]
    for mod, name, twin in routes:
        setattr(mod, name, twin)
    try:
        yield
    finally:
        for (mod, name, _), kernel in zip(routes, kernels):
            setattr(mod, name, kernel)


def _tables_inputs(gen, n, s, f, hw, dtype, dev):
    """(M, N, S, H, W) view of a stacked blur, as the op hands it to K6, and
    an error of (N, F, H, W)."""
    xb = torch.randn((n, s * M, hw, hw), generator=gen).to(dev, dtype)
    err = torch.randn((n, f, hw, hw), generator=gen).to(dev, dtype)
    return xb.reshape(n, s, M, hw, hw).permute(2, 0, 1, 3, 4), err


def _dx_inputs(gen, n, s, f, hw, dtype, dev):
    """The dx pass's K5 call: an error of F channels and the S<->F
    transposed (strided) params with negated offsets."""
    _, w, mu1, mu2 = _layer_inputs(gen, 1, s, f, 1, dtype, dev)
    err = torch.randn((n, f, hw, hw), generator=gen).to(dev, dtype)
    return err, w.permute(2, 1, 0), -mu1.permute(2, 1, 0), -mu2.permute(2, 1, 0)


def _check_err(name, got, want, bound):
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)}, want {tuple(want.shape)}")
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    print(f"compare {name}: max|err|={err:.3e} max|ref|={scale:.3e} bound={bound * scale:.3e}")
    if not err <= bound * scale:
        raise AssertionError(f"{name}: kernel disagrees with the twin")
    return err


def compare_backward(gen, dev, ks):
    """K6, K4 and dx-shape K5 vs their twins at each layer shape (N=4);
    returns the largest |error| of each."""
    worst = {"k6": 0.0, "k4": 0.0, "k5dx": 0.0}
    error_filt = gaussian_filters(0.5, size=9, device=dev)["error"]
    for name, s, f, hw in LAYERS:
        for dtype, bound in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            tag = f"{name} {str(dtype)[6:]}"
            xb, err = _tables_inputs(gen, 4, s, f, hw, dtype, dev)
            got = kbwd.grad_tables(xb, err, ks)
            worst["k6"] = max(worst["k6"], _check_err(
                f"K6 {tag} M={M}", got, kbwd.grad_tables_plain(xb, err, ks), 1e-4))
            x, w, mu1, mu2 = _layer_inputs(gen, 4, s, f, hw, dtype, dev)
            got = kfwd.aggregate_forward(x, w, mu1, mu2, ks)
            if got.dtype != dtype:
                raise AssertionError(f"K4 {tag}: output is {got.dtype}")
            worst["k4"] = max(worst["k4"], _check_err(
                f"K4 {tag}", got, kfwd.aggregate_forward_plain(x.float(), w, mu1, mu2, ks),
                bound))
            e, wt, m1, m2 = _dx_inputs(gen, 4, s, f, hw, dtype, dev)
            got = kfwd.dau_forward_fused(e, wt, m1, m2, error_filt, ks)
            if got.dtype != dtype:
                raise AssertionError(f"K5 dx {tag}: output is {got.dtype}")
            want = kfwd.dau_forward_fused_plain(e.float(), wt, m1, m2, error_filt, ks)
            worst["k5dx"] = max(worst["k5dx"], _check_err(
                f"K5 dx {tag} {f}->{s}", got, want, bound))
    return worst


def _counts():
    return (kfwd.dau_forward_fused.launches, kfwd.aggregate_forward.launches,
            kbwd.grad_tables.launches)


def _zero_counts():
    kfwd.dau_forward_fused.launches = 0
    kfwd.aggregate_forward.launches = 0
    kbwd.grad_tables.launches = 0


def _ulp(t, dtype):
    """One unit in the last place of each entry of t in `dtype` (f32 out)."""
    bits = 8 if dtype == torch.bfloat16 else 24
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32),
                       torch.frexp(t.float().abs()).exponent - bits)


def train(engine, dev, seed, batches, labels):
    """3 bf16 SGD steps through `make_train_step`; checks the launch counts
    of each step, a finite loss and the SGD update of every trainable
    parameter. Returns (model, step, launch counts (K5, K4, K6), moved)."""
    model = AlexNetDAU(variant="default", engine=engine, dtype=torch.bfloat16, device=dev,
                       generator=torch.Generator().manual_seed(seed))
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR))
    want = (8, 0, 4) if engine == "pallas_fused" else (0, 8, 4)
    first = {k: p.detach().clone() for k, p in model.named_parameters()}
    _zero_counts()
    for i, x in enumerate(batches):
        old = {k: p.detach().clone() for k, p in model.named_parameters()}
        before = _counts()
        loss = step(x, labels)
        torch.cuda.synchronize()
        got = tuple(a - b for a, b in zip(_counts(), before))
        if got != want:
            raise AssertionError(f"{engine} step {i}: launches (K5, K4, K6) {got}, want {want}")
        if not torch.isfinite(loss.float()):
            raise AssertionError(f"{engine} step {i}: loss {float(loss)}")
        for name, p in model.named_parameters():
            if name.endswith(".sigma"):  # not trainable in this model
                if p.grad is not None or not torch.equal(p, old[name]):
                    raise AssertionError(f"{engine} step {i}: sigma {name} moved")
                continue
            g = p.grad
            if g is None or not torch.isfinite(g.float()).all() or not torch.any(g != 0):
                raise AssertionError(f"{engine} step {i}: bad gradient for {name}")
            # one rounding of old - lr*grad to p's dtype, within two ulps (of
            # the larger of old and new): the add may be fused, and lr may be
            # rounded to p's dtype first
            sgd = (old[name].float() - LR * g.float()).to(p.dtype)
            tol = 2 * _ulp(torch.maximum(old[name].float().abs(), sgd.float().abs()), p.dtype)
            if not bool(((p.float() - sgd.float()).abs() <= tol).all()):
                raise AssertionError(f"{engine} step {i}: {name} did not take the SGD update")
        print(f"train {engine} step {i}: loss {float(loss):.5f}, launches (K5, K4, K6) {got}")
    counts = _counts()
    moved = [k for k, p in model.named_parameters() if not torch.equal(p, first[k])]
    return model, step, counts, moved


def reference_step(engine, dev, seed, x, labels):
    """One f32 step's gradients through the kernels and through the twins,
    from the same weights; returns the worst gradient error relative to
    its tensor's max|grad|."""
    model = AlexNetDAU(variant="default", engine=engine, dtype=torch.float32, device=dev,
                       generator=torch.Generator().manual_seed(seed))
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0))
    grads = []
    for route in (contextlib.nullcontext, plain_twin):
        with route():
            loss = step(x, labels)
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None})
    worst = 0.0
    for name, want in grads[1].items():
        err = float((grads[0][name] - want).abs().max())
        scale = float(want.abs().max())
        worst = max(worst, err / scale)
        if not err <= 1e-3 * scale:
            raise AssertionError(f"reference {engine}: {name} max|dg|={err:.3e} "
                                 f"max|g|={scale:.3e}")
    print(f"reference f32 step {engine}: loss {float(loss):.5f}; {len(grads[1])} gradients, "
          f"worst max|dg|/max|g| = {worst:.3e} (bound 1e-3)")
    return worst


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on the card",
              file=sys.stderr)
        return 2
    if Path(dau_convnet_tpu_torch.__file__).resolve().parents[1] != ROOT:
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = _card()
    print(f"card: {card}")
    print(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}), "
          f"torch {torch.__version__}, cuda {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    build(LIBRARIES)
    print(f"build: {', '.join(LIBRARIES)} (.cu) for sm_90a, one nvcc each, "
          f"{time.perf_counter() - t0:.1f} s; ptxas:")
    for lib in LIBRARIES:
        lines = build_log(lib).splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "Li9E" in line:
                print(f"  {lib} " + ("bf16" if "bfloat16" in line else "f32") + " ks=9: "
                      + " | ".join(l.split("info    : ")[-1].strip()
                                   for l in lines[i + 2:i + 4]))

    # 2. kernel vs twin
    gen = torch.Generator().manual_seed(args.seed)
    ks = DAUConvSettings().synth_kernel_size
    filt = gaussian_filters(0.5, size=9, device=dev)["w"]
    worst = compare(gen, dev, filt, ks)

    # 3. serving in bf16 through the kernel
    model = AlexNetDAU(variant="default", engine="pallas_fused", dtype=torch.bfloat16,
                       device=dev, generator=torch.Generator().manual_seed(args.seed))
    model.eval()
    requests = [torch.rand((BATCH, 3, IMAGE, IMAGE), generator=gen).to(dev)
                for _ in range(REQUESTS)]
    _zero_counts()
    with torch.inference_mode():
        for i, req in enumerate(requests):
            logits = model(req)
            torch.cuda.synchronize()
            if kfwd.dau_forward_fused.launches != 4 * (i + 1):
                raise AssertionError(f"request {i}: {kfwd.dau_forward_fused.launches} "
                                     "kernel launches, expected 4 per request")
            if logits.shape != (BATCH, 1000) or not torch.isfinite(logits.float()).all():
                raise AssertionError(f"request {i}: bad logits {tuple(logits.shape)}")
    if _counts()[1:] != (0, 0):
        raise AssertionError(f"serving launched K4/K6: {_counts()}")
    launches = kfwd.dau_forward_fused.launches
    print(f"serving: {REQUESTS} requests of {BATCH}x3x{IMAGE}x{IMAGE} bf16, "
          f"{launches} kernel launches, logits finite")

    # 4. f32 reference: kernel path vs plain path on the same weights
    ref_model = AlexNetDAU(variant="default", engine="pallas_fused", dtype=torch.float32,
                           device=dev, generator=torch.Generator().manual_seed(args.seed))
    ref_model.eval()
    with torch.inference_mode():
        y_kernel = ref_model(requests[0])
        with plain_twin():
            y_plain = ref_model(requests[0])
    err = float((y_kernel - y_plain).abs().max())
    scale = float(y_plain.abs().max())
    print(f"reference f32: max|dlogits|={err:.3e} max|logits|={scale:.3e} "
          f"bound={1e-3 * scale:.3e}")
    if not err <= 1e-3 * scale:
        raise AssertionError("f32 kernel path disagrees with the plain path")

    # 5. timing
    kernel_ms = plain_ms = 0.0
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            for name, s, f, hw in LAYERS:
                x, w, mu1, mu2 = _layer_inputs(gen, BATCH, s, f, hw, dtype, dev)
                t_k = _cuda_ms(lambda: kfwd.dau_forward_fused(x, w, mu1, mu2, filt, ks))
                t_p = _cuda_ms(lambda: kfwd.dau_forward_fused_plain(x, w, mu1, mu2, filt, ks))
                gflops = 2 * ks * ks * s * f * hw * hw * BATCH / 1e9
                print(f"layer {name} N={BATCH} {str(dtype)[6:]}: kernel {t_k:.3f} ms "
                      f"({gflops / t_k:.1f} TFLOP/s dense), plain {t_p:.3f} ms [{card}]")
                if dtype == torch.bfloat16:
                    kernel_ms += t_k
                    plain_ms += t_p
        for m, tag in ((model, "bf16"), (ref_model, "f32")):
            t_k = _cuda_ms(lambda: m(requests[0]), iters=5)
            with plain_twin():
                t_p = _cuda_ms(lambda: m(requests[0]), iters=5)
            print(f"request {BATCH}x3x{IMAGE}x{IMAGE} {tag}: kernel path {t_k:.3f} ms, "
                  f"plain path {t_p:.3f} ms [{card}]")
    del model, ref_model, requests

    # 6. backward kernels vs twins
    worst_bwd = compare_backward(gen, dev, ks)

    # 7. training in bf16, each engine's path read on its own
    batches = [torch.rand((BATCH, 3, IMAGE, IMAGE), generator=gen).to(dev)
               for _ in range(STEPS)]
    labels = torch.randint(0, 1000, (BATCH,), generator=gen).to(dev)
    runs = {}
    for engine in ("pallas_fused", "pallas"):
        model, step, counts, moved = train(engine, dev, args.seed, batches, labels)
        trainable = [k for k, p in model.named_parameters() if not k.endswith(".sigma")]
        still = [k for k in trainable if k not in moved]
        print(f"train {engine}: {STEPS} bf16 steps of {BATCH}x3x{IMAGE}x{IMAGE}, launches "
              f"(K5, K4, K6) {counts}; {len(moved)} of {len(trainable)} trainable parameter "
              f"tensors moved" + (f"; unmoved (every update below half a bf16 ulp): {still}"
                                  if still else ""))
        runs[engine] = (step, counts)
    launches_k5 = launches + runs["pallas_fused"][1][0]
    launches_k4 = runs["pallas"][1][1]
    launches_k6 = runs["pallas_fused"][1][2] + runs["pallas"][1][2]

    # 8. f32 reference step: kernels vs twins
    for engine in ("pallas_fused", "pallas"):
        reference_step(engine, dev, args.seed, batches[0], labels)

    # 9. timing of the backward kernels and the training step
    k6_ms = k6_plain = k4_ms = k4_plain = 0.0
    error_filt = gaussian_filters(0.5, size=9, device=dev)["error"]
    for name, s, f, hw in LAYERS:
        xb, err = _tables_inputs(gen, BATCH, s, f, hw, torch.bfloat16, dev)
        t_k = _cuda_ms(lambda: kbwd.grad_tables(xb, err, ks))
        t_p = _cuda_ms(lambda: kbwd.grad_tables_plain(xb, err, ks))
        gflops = 2 * ks * ks * M * s * f * hw * hw * BATCH / 1e9
        print(f"layer {name} K6 N={BATCH} M={M} bf16: kernel {t_k:.3f} ms "
              f"({gflops / t_k:.1f} TFLOP/s), plain {t_p:.3f} ms [{card}]")
        k6_ms, k6_plain = k6_ms + t_k, k6_plain + t_p
        x, w, mu1, mu2 = _layer_inputs(gen, BATCH, s, f, hw, torch.bfloat16, dev)
        t_k = _cuda_ms(lambda: kfwd.aggregate_forward(x, w, mu1, mu2, ks))
        t_p = _cuda_ms(lambda: kfwd.aggregate_forward_plain(x, w, mu1, mu2, ks))
        print(f"layer {name} K4 N={BATCH} bf16: kernel {t_k:.3f} ms, plain {t_p:.3f} ms "
              f"[{card}]")
        k4_ms, k4_plain = k4_ms + t_k, k4_plain + t_p
        e, wt, m1, m2 = _dx_inputs(gen, BATCH, s, f, hw, torch.bfloat16, dev)
        t_k = _cuda_ms(lambda: kfwd.dau_forward_fused(e, wt, m1, m2, error_filt, ks))
        t_p = _cuda_ms(lambda: kfwd.dau_forward_fused_plain(e, wt, m1, m2, error_filt, ks))
        print(f"layer {name} K5 dx {f}->{s} N={BATCH} bf16: kernel {t_k:.3f} ms, "
              f"plain {t_p:.3f} ms [{card}]")
    for engine, (step, _) in runs.items():
        t_k = _cuda_ms(lambda: step(batches[0], labels), iters=3, warmup=1)
        with plain_twin():
            t_p = _cuda_ms(lambda: step(batches[0], labels), iters=3, warmup=1)
        print(f"train step {engine} {BATCH}x3x{IMAGE}x{IMAGE} bf16: kernel path {t_k:.3f} ms, "
              f"plain path {t_p:.3f} ms [{card}]")

    print(json.dumps({"kernels": [
        dict(KERNEL, launches=launches_k5, max_abs_err=max(worst, worst_bwd["k5dx"]),
             ms=kernel_ms, plain_ms=plain_ms),
        dict(KERNEL_K6, launches=launches_k6, max_abs_err=worst_bwd["k6"],
             ms=k6_ms, plain_ms=k6_plain),
        dict(KERNEL_K4, launches=launches_k4, max_abs_err=worst_bwd["k4"],
             ms=k4_ms, plain_ms=k4_plain)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
