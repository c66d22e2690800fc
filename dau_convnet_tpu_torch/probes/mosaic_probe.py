"""The Mosaic capability probes P1-P7, asked again of the card.

Counterpart of `benchmarks/mosaic_probe.py` (the JAX script, run on a TPU).
Each probe makes the JAX probe's inputs from `numpy.random.default_rng(0)`
in its order, runs the port's kernel for the probe's Pallas kernel on them
and holds the result against the plain twin; on the card it also times the
kernel beside its bound, its twin and one PyTorch call of the same function:

- P1 `t_3d_dot`: table(P,A,B) = sum_k D(P,K) T(K,A,B), one probe GEMM
  (`kernels/probe_kernels.py::probe_gemm`) on the (K, A*B) view of T;
- P2 `t_3d_dot_batched`: out(A,B,P) = sum_k T(A,K,B) D(K,P), the probe GEMM
  batched over A with T[a] as an M-major A;
- P5 `t_batched_dot`, P6 `t_batched_dot_4d`: the per-bin batched dot at 153
  bins, the 4-D left operand as its (153, 384, 64) view;
- P3 `t_vmem(total_mb)`: the column sums of 2x through a scratch of
  total_mb, in device memory (`scale_colsum`): beside the largest shared
  memory a block can opt into and the L2's size, its time at 24, 40 and
  60 MB says whether the scratch's round trip stays in the L2;
- P4 `t_grid_overhead`: x + 1 over (32768, 512) bf16 (`add_one`) in one
  launch, in 16 and 256 launches of row slices (the per-launch cost, by
  CUDA events and by the host's clock), and in 16 and 256 blocks of one
  launch;
- P7 `t_gather_loop`: the one-hot tap gather (`probe_gather`). The JAX
  probe's Pallas body does not trace (`benchmarks/mosaic_probe.py:209`
  broadcasts the mask (1, S, G, 1, F) against the slab (M, S, 1, F)); the
  function it means is its reference, the einsum at :222-224.

    python -m dau_convnet_tpu_torch.probes.mosaic_probe [name] [--device cpu] [--trace]

`name` keeps the probes whose name holds it, as the JAX script's argument
does. It prints one PASS or FAIL line a probe and a line of numbers for
each of its timings; unlike the JAX script it exits with 1 if any probe
failed. It runs on the CUDA card, and on the CPU (the twins only, no
times) under `--device cpu`.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..examples import device_for
from ..kernels import probe_kernels as pk
from . import (PEAK_F32, card, close, device_ms, gb_per_s, nbytes, new_row, queued_ms,
               run_probes, spread, tensor)

__all__ = ["t_3d_dot", "t_3d_dot_batched", "t_vmem", "t_grid_overhead", "t_batched_dot",
           "t_batched_dot_4d", "t_gather_loop", "TESTS", "run", "main"]

BF16 = torch.bfloat16
CUDA = torch.device("cuda")
GEMM_TOL = 1e-4  # of max|twin|: the products are exact in f32, the sums' order differs


def _gemm_probe(probe, label, a, b, trans_a, library, lib_fn):
    """Hold the probe GEMM against its twin on (a, b), and time it on the
    card: the kernel on operands TMA can read, the padding of those it
    cannot apart, the twin and `lib_fn`."""
    got = pk.probe_gemm(a, b, trans_a)
    want = pk.probe_gemm_plain(a, b, trans_a)
    err = close(f"{probe} {label}", got, want, GEMM_TOL)
    batch = got.shape[0] if got.dim() == 3 else 1
    (m, n), k = got.shape[-2:], b.shape[-2]
    work = (2 * batch * m * n * k, nbytes(a, b, got))
    dev = a.device
    ga, gb = pk.gemm_operand(a), pk.gemm_operand(b)
    padded = ga is not a or gb is not b
    return [new_row(
        probe, label, pk.probe_gemm, err, GEMM_TOL, work,
        ms=spread(lambda: pk.probe_gemm(ga, gb, trans_a), dev),
        device_ms=device_ms(lambda: pk.probe_gemm(ga, gb, trans_a), dev, ("probe_gemm_kernel",)),
        operand_ms=(spread(lambda: (pk.gemm_operand(a), pk.gemm_operand(b)), dev) if padded
                    else None),
        plain_ms=spread(lambda: pk.probe_gemm_plain(a, b, trans_a), dev),
        library=library, library_ms=spread(lib_fn, dev),
        library_device_ms=device_ms(lib_fn, dev, ("",)),
        note=f"batch {batch}, M={m} N={n} K={k}" + (
            ", rows padded to a multiple of 8 values" if padded else ""))]


def t_3d_dot(device=CUDA):
    """P1: table(P,A,B) = sum_k D(P,K) @ T(K,A,B), bf16 with f32 sums."""
    P, K, A, B = 81, 153, 128, 128
    rng = np.random.default_rng(0)
    d = tensor(rng.standard_normal((P, K)), BF16, device)
    t = tensor(rng.standard_normal((K, A, B)), BF16, device).reshape(K, A * B)
    return _gemm_probe("P1", "(P,K)x(K,A,B)", d, t, False, "torch.matmul",
                       lambda: torch.matmul(d, t))


def t_3d_dot_batched(device=CUDA):
    """P2: out(A,B,P) = sum_k T(A,K,B) D(K,P), batched over A (the JAX
    docstring's (A,P,B) is wrong: its output is (A,B,P))."""
    P, K, A, B = 81, 153, 128, 128
    rng = np.random.default_rng(0)
    d = tensor(rng.standard_normal((K, P)), BF16, device)
    t = tensor(rng.standard_normal((A, K, B)), BF16, device)
    return _gemm_probe("P2", "(A,K,B)x(K,P)", t, d, True, "torch.einsum('akb,kp->abp')",
                       lambda: torch.einsum("akb,kp->abp", t, d))


def t_vmem(total_mb, device=CUDA):
    """P3: sum_i 2 x[i, :] of ones (n, 512) f32 through a scratch of
    ~total_mb, n from total_mb as the JAX probe makes it."""
    n = int(total_mb * 1024 * 1024 / 4 / 512 // 8 * 8)
    x = torch.ones((n, 512), dtype=torch.float32, device=device)
    got = pk.scale_colsum(x)
    if float(got[0, 0]) != 2.0 * n:
        raise AssertionError(f"P3: out[0, 0] = {float(got[0, 0])}, expected {2.0 * n}")
    err = close(f"P3 vmem {total_mb} MB", got, pk.scale_colsum_plain(x), 0)
    ms = spread(lambda: pk.scale_colsum(x), device)
    dev_ms = device_ms(lambda: pk.scale_colsum(x), device,
                       ("scale_kernel", "colsum_partial_kernel", "colsum_final_kernel"))
    note = f"scratch {nbytes(x) / 1e6:.1f} MB"
    if ms is not None:
        lim = pk.device_limits(device)
        note += (f"; a block may opt into {lim['smem_optin']} B of shared memory, the L2 holds "
                 f"{lim['l2_bytes'] / 2**20:.1f} MiB; x read, 2x written and read back: "
                 f"{gb_per_s(3 * nbytes(x), ms[0]):.0f} GB/s")
    return [new_row("P3", f"vmem {total_mb} MB scratch", pk.scale_colsum, err, 0,
                    (2 * x.numel(), nbytes(x, got), PEAK_F32), ms=ms, device_ms=dev_ms,
                    plain_ms=spread(lambda: pk.scale_colsum_plain(x), device), note=note)]


def _wall_ms(fn, iters: int = 10) -> float:
    """Host ms per call of fn, the card synchronised before and after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def t_grid_overhead(device=CUDA):
    """P4: x + 1 over (32768, 512) bf16, in one launch, in 16 and 256
    launches of row slices, and in 16 and 256 blocks of one launch."""
    M, N = 256 * 128, 512
    x = torch.ones((M, N), dtype=BF16, device=device)
    want = pk.add_one_plain(x)
    err = close("P4 one launch", pk.add_one(x), want, 0)
    y = torch.empty_like(x)

    def slices(steps):
        blk = M // steps
        return [(x[i * blk:(i + 1) * blk], y[i * blk:(i + 1) * blk]) for i in range(steps)]

    runs = {steps: slices(steps) for steps in (16, 256)}

    def launches(steps):
        for xs, ys in runs[steps]:
            pk.add_one(xs, out=ys)

    for steps in (16, 256):
        y.zero_()
        launches(steps)
        close(f"P4 {steps} launches", y, want, 0)
    for blocks in (16, 256):
        close(f"P4 {blocks} blocks", pk.add_one(x, blocks=blocks), want, 0)
    work = (x.numel(), 2 * nbytes(x), PEAK_F32)
    t = {k: spread(fn, device) for k, fn in (
        ("one", lambda: pk.add_one(x, out=y)), ("l16", lambda: launches(16)),
        ("l256", lambda: launches(256)), ("b16", lambda: pk.add_one(x, out=y, blocks=16)),
        ("b256", lambda: pk.add_one(x, out=y, blocks=256)))}
    note = ""
    if t["one"] is not None:
        wall = {steps: _wall_ms(lambda: launches(steps)) for steps in (16, 256)}
        queued = {steps: queued_ms(lambda: launches(steps)) for steps in (16, 256)}
        per_event = (t["l256"][0] - t["l16"][0]) / 240 * 1e3
        per_wall = (wall[256] - wall[16]) / 240 * 1e3
        per_queued = (queued[256][0] - queued[16][0]) / 240 * 1e3
        note = (f"16 launches {t['l16'][0]:.4f} ms, 256 launches {t['l256'][0]:.4f} ms -> "
                f"{per_event:.2f} us a launch by CUDA events; host clock {wall[16]:.4f} and "
                f"{wall[256]:.4f} ms -> {per_wall:.2f} us a launch; queued behind a sleep "
                f"(the card's own pace) {queued[16][0]:.4f} and {queued[256][0]:.4f} ms -> "
                f"{per_queued:.2f} us a launch (host enqueue up to {queued[256][1]:.3f} ms); "
                f"one launch in 16 blocks {t['b16'][0]:.4f} ms, in 256 blocks "
                f"{t['b256'][0]:.4f} ms")
    return [new_row("P4", "grid overhead: one launch", pk.add_one, err, 0, work, ms=t["one"],
                    device_ms=device_ms(lambda: pk.add_one(x, out=y), device, ("add_one_kernel",)),
                    plain_ms=spread(lambda: pk.add_one_plain(x), device), note=note)]


def t_batched_dot(device=CUDA):
    """P5: per-bin batched matmul (B,M,K) x (B,K,N), batch dim 0."""
    Bb, Mm, K, Nn = 153, 384, 64, 128
    rng = np.random.default_rng(0)
    a = tensor(rng.standard_normal((Bb, Mm, K)), BF16, device)
    b = tensor(rng.standard_normal((Bb, K, Nn)), BF16, device)
    return _gemm_probe("P5", "(B,M,K)x(B,K,N)", a, b, False, "torch.bmm",
                       lambda: torch.bmm(a, b))


def t_batched_dot_4d(device=CUDA):
    """P6: (B,M,S,K) x (B,K,N) with the left operand viewed as (B, M*S, K),
    as the Pallas body reshapes it."""
    Bb, Mm, Ss, K, Nn = 153, 3, 128, 64, 128
    rng = np.random.default_rng(0)
    a = tensor(rng.standard_normal((Bb, Mm, Ss, K)), BF16, device).reshape(Bb, Mm * Ss, K)
    b = tensor(rng.standard_normal((Bb, K, Nn)), BF16, device)
    return _gemm_probe("P6", "(B,M,S,K)x(B,K,N)", a, b, False, "torch.bmm",
                       lambda: torch.bmm(a, b))


def t_gather_loop(device=CUDA):
    """P7: out[m,s,g,f] = sum_p [tgt[s,g,f] == p] iw[s,g,f] tab[p,m,s,f] over
    a (P, M, S, F) table."""
    P, Mm, Ss, Ff, G = 81, 3, 128, 128, 2
    ks = 9
    rng = np.random.default_rng(0)
    tab = tensor(rng.standard_normal((P, Mm, Ss, Ff)), torch.float32, device)
    tgt = tensor(rng.integers(0, P - ks - 1, (Ss, G, Ff)), torch.float32, device)
    iw = tensor(rng.random((Ss, G, Ff)), torch.float32, device)
    got = pk.probe_gather(tab, tgt, iw)
    err = close("P7", got, pk.probe_gather_plain(tab, tgt, iw), 0)
    # the data needs one word of tab per output whose target it names
    hits = int(((tgt >= 0) & (tgt < P) & (tgt == torch.floor(tgt))).sum())
    work = (hits * Mm, hits * Mm * 4 + nbytes(tgt, iw, got), PEAK_F32)
    return [new_row("P7", "gather_loop", pk.probe_gather, err, 0, work,
                    ms=spread(lambda: pk.probe_gather(tab, tgt, iw), device),
                    device_ms=device_ms(lambda: pk.probe_gather(tab, tgt, iw), device,
                                        ("probe_gather_kernel",)),
                    plain_ms=spread(lambda: pk.probe_gather_plain(tab, tgt, iw), device),
                    note=f"{hits} of {tgt.numel()} targets in [0, {P})")]


# the JAX script's list, in its order, and P3 at 24 and 40 MB beside 60
TESTS = (
    ("3d_dot (P,K)x(K,A,B)", t_3d_dot),
    ("3d_dot (A,K,B)x(K,P)", t_3d_dot_batched),
    ("batched_dot (B,M,K)x(B,K,N)", t_batched_dot),
    ("batched_dot_4d (B,M,S,K)x(B,K,N)", t_batched_dot_4d),
    ("gather_loop", t_gather_loop),
    ("vmem 24 MB scratch", lambda dev: t_vmem(24, dev)),
    ("vmem 40 MB scratch", lambda dev: t_vmem(40, dev)),
    ("vmem 60 MB scratch", lambda dev: t_vmem(60, dev)),
    ("grid overhead", t_grid_overhead),
)


def run(only=None, device=CUDA, trace: bool = False):
    """Run the probes whose name holds `only` (all where None) on `device`;
    returns (every probe passed, their rows)."""
    return run_probes(TESTS, only, torch.device(device), trace)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("name", nargs="?", default=None,
                    help="run only the probes whose name holds this")
    ap.add_argument("--device", choices=["default", "cpu"], default="default",
                    help="default: the CUDA card; cpu runs the twins on the CPU")
    ap.add_argument("--trace", action="store_true", help="print a failing probe's traceback")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = device_for(args.device)
    print(f"device: {card() if dev.type == 'cuda' else 'cpu'}", flush=True)
    ok, _ = run(args.name, dev, args.trace)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
