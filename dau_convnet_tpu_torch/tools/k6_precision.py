"""K6 (`kernels/backward.py::grad_tables`) on tables whose sums cancel, and its times.

    python dau_convnet_tpu_torch/tools/k6_precision.py [--seed N]

Needs one CUDA card and nvcc; measures the package of the checkout that
holds it (to measure another commit, run the same file from inside that
commit's tree). Builds position tables of CIFAR conv1's backward shape
(N=128, M=3, S=3, F=96, 32x32, ks 9) from blurred planes of mean 3 and an
error of zero mean per channel, as a train-mode BatchNorm hands back, so
each table entry is a sum that cancels, once from f32 and once from bf16
input. Prints one line: for each, the largest error of K6's table against
the float64 table of the same inputs, relative to max|table|, and K6's
device time there (`torch.profiler`, the mean of 5 calls after one
warm-up); then K6's bf16 device time at AlexNet-DAU's four layer shapes
(N=32, M=3) and at the layer shapes of the CIFAR nets (N=128) and of one
layer per DAU-ResNet-18 stage (N=32), beside the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

CIFAR_CONV1 = (128, 3, 96, 32)  # N, S, F, H=W
# (name, N, S, F, H=W)
LAYERS = (("alexnet conv2", 32, 96, 256, 27), ("alexnet conv3", 32, 256, 384, 13),
          ("alexnet conv4", 32, 384, 384, 13), ("alexnet conv5", 32, 384, 256, 13),
          ("cifar conv1", 128, 3, 96, 32), ("cifar conv2", 128, 96, 96, 16),
          ("cifar conv3", 128, 96, 192, 8), ("resnet stage0", 32, 64, 64, 56),
          ("resnet stage1", 32, 128, 128, 28), ("resnet stage2", 32, 256, 256, 14),
          ("resnet stage3", 32, 512, 512, 7))
M, KS = 3, 9


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dau_convnet_tpu_torch.kernels import backward as kb
    from dau_convnet_tpu_torch.ops import xla_engine

    if not torch.cuda.is_available():
        print("k6_precision: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)

    def device_ms(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "grad_tables_kernel" in e.key) / 1e3 / iters

    n, s, f, hw = CIFAR_CONV1
    xb = torch.randn((M, n, s, hw, hw), generator=gen) + 3.0
    err = torch.randn((n, f, hw, hw), generator=gen)
    err = err - err.mean(dim=(0, 2, 3), keepdim=True)
    cancelling = []
    for dtype in (torch.float32, torch.bfloat16):
        x, e = xb.to(dev, dtype), err.to(dev, dtype)
        want = xla_engine.grad_tables(x.double(), e.double(), KS)
        got = kb.grad_tables(x, e, KS)
        rel = float((got.double() - want).abs().max()) / float(want.abs().max())
        cancelling.append((str(dtype)[6:], rel, device_ms(lambda: kb.grad_tables(x, e, KS))))
        del x, e, want, got
    times = []
    for name, n, s, f, hw in LAYERS:
        x = torch.randn((M, n, s, hw, hw), generator=gen).to(dev, torch.bfloat16)
        e = torch.randn((n, f, hw, hw), generator=gen).to(dev, torch.bfloat16)
        times.append((name, device_ms(lambda: kb.grad_tables(x, e, KS))))
        del x, e
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    n, s, f, hw = CIFAR_CONV1
    print(f"K6 of {Path(__file__).resolve().parents[2]}: cancelling table {n}x{s}->{f} "
          f"{hw}x{hw} M={M}, max|err|/max|table| against float64 and device ms: "
          + ", ".join(f"{d} {rel:.3e} {ms:.4f}" for d, rel, ms in cancelling)
          + "; bf16 device ms: " + ", ".join(f"{name} {ms:.4f}" for name, ms in times)
          + f" (AlexNet-DAU sum {sum(ms for _, ms in times[:4]):.4f}) [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
