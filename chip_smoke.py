"""Chip smoke test of the PyTorch port: AlexNet-DAU serving on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of the repository, on a machine with a CUDA card. Phases:

1. build: compile the fused forward kernel (K5) for sm_90a and print its
   registers and spills;
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
   a whole request through either, beside the card's name and power limit.

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
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import dau_convnet_tpu_torch  # noqa: E402
from dau_convnet_tpu_torch.kernels import forward as kfwd  # noqa: E402
from dau_convnet_tpu_torch.kernels._build import build_log  # noqa: E402
from dau_convnet_tpu_torch.models import AlexNetDAU  # noqa: E402
from dau_convnet_tpu_torch.ops import DAUConvSettings, gaussian_filters  # noqa: E402

KERNEL = dict(name="dau_forward_fused", route="cuda",
              source="dau_convnet_tpu_torch/kernels/csrc/dau_forward_fused.cu",
              replaces="dau_convnet_tpu/kernels/forward.py:209")
# (name, S, F, H=W) of the AlexNet-DAU DAU layers at 227x227 input
LAYERS = (("conv2", 96, 256, 27), ("conv3", 256, 384, 13),
          ("conv4", 384, 384, 13), ("conv5", 384, 256, 13))
G = 2
BATCH, IMAGE, REQUESTS = 32, 227, 3


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
    """Route the op's fused-engine call to the plain twin (for timing and
    the reference run); the launch counter is left alone."""
    kernel = kfwd.dau_forward_fused
    kfwd.dau_forward_fused = kfwd.dau_forward_fused_plain
    try:
        yield
    finally:
        kfwd.dau_forward_fused = kernel


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
    kfwd._library()
    print("build: dau_forward_fused.cu for sm_90a, ptxas:")
    lines = build_log("dau_forward_fused").splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "Li9E" in line:
            print("  " + ("bf16" if "bfloat16" in line else "f32") + " ks=9: "
                  + " | ".join(l.split("info    : ")[-1].strip() for l in lines[i + 2:i + 4]))

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
    kfwd.dau_forward_fused.launches = 0
    with torch.inference_mode():
        for i, req in enumerate(requests):
            logits = model(req)
            torch.cuda.synchronize()
            if kfwd.dau_forward_fused.launches != 4 * (i + 1):
                raise AssertionError(f"request {i}: {kfwd.dau_forward_fused.launches} "
                                     "kernel launches, expected 4 per request")
            if logits.shape != (BATCH, 1000) or not torch.isfinite(logits.float()).all():
                raise AssertionError(f"request {i}: bad logits {tuple(logits.shape)}")
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

    print(json.dumps({"kernels": [dict(KERNEL, launches=launches, max_abs_err=worst,
                                       ms=kernel_ms, plain_ms=plain_ms)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
