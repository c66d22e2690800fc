"""Time variants of K1's kernel source on the card, to see what paces it.

    python -m dau_convnet_tpu_torch.tools.k1_variants [--seed N] [--dx]

Each variant is `kernels/csrc/dau_spectral_grads.cu` with one part of K1's
kernel (`spectral_grads_kernel` under `PhiGather`) changed by a text edit
(`VARIANTS`), compiled with the package's nvcc flags into
`kernels/build/` and run through `fused_spectral_grads` at the AlexNet-DAU
layer shapes (N=32, bf16, M=3, G=2, spectra and offsets from --seed). One
line per variant gives the kernel's device time per layer (`torch.profiler`,
the mean of 5 calls after one warm-up), beside the card's name and power
limit. With --dx the variants are of K2's dx kernel (`dx::spectral_dx_kernel`,
`DX_VARIANTS`; most edits fall in its mainloop `tapgemm::tap_gemm`, in
`csrc/dau_tap_gemm.cuh`), timed through `fused_spectral_grads` with the dx
operands.
Variants that drop work compute wrong results; they only time. Needs one
CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import subprocess
import sys

import torch

from ..kernels import _build
from ..kernels import fused_bwd as kfb
from ..ops import fourier_engine as fe

LAYERS = (("conv2", 96, 256, 27), ("conv3", 256, 384, 13), ("conv4", 384, 384, 13),
          ("conv5", 384, 256, 13))
M, G, N, KS = 3, 2, 32, 9

_PHASE = "        if (c + 1 == chunks) {\n"
_GATHER = "            gacc[m][g][p] = fmaf(phr[g][p], tr, fmaf(-phm[g][p], ti, gacc[m][g][p]));"
_WGMMA = ("          if constexpr (FT == 16)\n"
          "            wgmma_m64n32<1, 1>(tacc[m], desc_advance(da, 2048 * kk), desc_advance(db, 256 * kk));\n"
          "          else if constexpr (FT == 8)\n"
          "            wgmma_m64n16<1, 1>(tacc[m], desc_advance(da, 2048 * kk), desc_advance(db, 256 * kk));\n"
          "          else\n"
          "            wgmma_m64n8<1, 1>(tacc[m], desc_advance(da, 2048 * kk), desc_advance(db, 256 * kk));\n")
_STAGE_BYTES = "  const uint32_t stage_bytes = M * A_M + B_STAGE + 2 * q * 4;"
_ES_LOAD = "    tma_load_4d(base + lay.b + ahead.stage * B_STAGE, &e_map, full, 0, c * KC, f0 / 4, k);\n"

# name -> [(text, replacement), ...], applied in order; each text must occur
VARIANTS = {
    "as built": [],
    "no gather (phase factors and gather dropped)": [
        (_PHASE, "        if (false) {\n"),
        (_GATHER, "            gacc[m][g][p] += tr - ti;")],
    "no wgmma": [(_WGMMA, "")],
    "neither gather nor wgmma": [
        (_PHASE, "        if (false) {\n"), (_GATHER, "            gacc[m][g][p] += tr - ti;"),
        (_WGMMA, "")],
    "X of M-1 planes loaded": [
        (_STAGE_BYTES, "  const uint32_t stage_bytes = (M - 1) * A_M + B_STAGE + 2 * q * 4;"),
        ("const cuuint32_t x_box[4] = {ST, KC, (cuuint32_t)M, 1};",
         "const cuuint32_t x_box[4] = {ST, KC, (cuuint32_t)(M - 1), 1};")],
    "no ES loaded": [
        (_STAGE_BYTES, "  const uint32_t stage_bytes = M * A_M + 2 * q * 4;"), (_ES_LOAD, "")],
    "ring of 3, two steps ahead": [
        ("constexpr int STAGES = 2;", "constexpr int STAGES = 3;"),
        ("    issue(0);\n", "    for (int i = 0; i < STAGES - 1 && i < steps; ++i) issue(i);\n"),
        ("if (tid == 0 && i + 1 < steps) issue(i + 1);",
         "if (tid == 0 && i + STAGES - 1 < steps) issue(i + STAGES - 1);")],
    "T not rounded": [("          round_pair(tr, ti, T());\n", "")],
    "one bin range (72 / 48 blocks, one wave)": [
        ("constexpr int MAX_RANGES = 8;", "constexpr int MAX_RANGES = 1;")],
}


_DX_LOADS = ("            taps[e][g] = load_tap<A::kWeight>(\n"
             "                rec, plane, ((size_t)gi * F + min(f, F - 1)) * S + min(s, S - 1), "
             "T());")
_DX_BINS = "constexpr int NB = 2;        // bins per group"
_DX_BOUNDS = "__launch_bounds__(tapgemm::THREADS, sizeof(T) == 2 && G <= 2 ? 3 : 1)\nspectral_dx"
_DX_FENCE = '    asm volatile("fence.proxy.async;" ::: "memory");\n    __syncthreads();\n'

# the dx kernel's variants, as VARIANTS
DX_VARIANTS = {
    "as built (2 bins a group, 3 blocks per SM)": [],
    "3 bins a group, 2 blocks per SM": [
        (_DX_BINS, "constexpr int NB = 3;        // bins per group"),
        (_DX_BOUNDS, "__launch_bounds__(tapgemm::THREADS)\nspectral_dx")],
    "1 bin a group, 4 blocks per SM": [
        (_DX_BINS, "constexpr int NB = 1;        // bins per group"),
        (_DX_BOUNDS, "__launch_bounds__(tapgemm::THREADS, 4)\nspectral_dx")],
    "no tap record loads": [
        (_DX_LOADS, "          taps[e][g] = Tap{(f + g) % 9, (s + g) % 9, 0.5f, 0.25f, 0.5f, "
                    "0.25f, 1.f};")],
    "no proxy fence, no barrier per step": [(_DX_FENCE, "")],
    "ring of 6": [("SEGS = 1, PARTS = 1, RING = 3;", "SEGS = 1, PARTS = 1, RING = 6;")],
}


# the sources a variant edits: the kernels' file and the dx kernel's mainloop
_SOURCES = ("dau_spectral_grads.cu", "dau_tap_gemm.cuh")


def _variant_source(edits) -> dict:
    """{file name: text} of the sources with the edits applied, each to
    the one source that holds its text."""
    srcs = {name: (_build._CSRC / name).read_text() for name in _SOURCES}
    for text, repl in edits:
        name = next((n for n, src in srcs.items() if text in src), None)
        if name is None:
            raise RuntimeError(f"variant edit does not apply: {text[:60]!r}")
        srcs[name] = srcs[name].replace(text, repl)
    return srcs


def _compile(tag: str, srcs: dict) -> ctypes.CDLL:
    """Build one variant into kernels/build/ and declare its C signatures
    as `fused_bwd._library` declares the committed library's."""
    folder = _build._BUILD / f"k1_variant_{tag}"
    folder.mkdir(parents=True, exist_ok=True)
    for name, src in srcs.items():
        (folder / name).write_text(src)
    cu = folder / _SOURCES[0]
    so = cu.with_suffix(".so")
    cmd = [_build._tool("nvcc"), *_build.NVCC_FLAGS, "-I", str(_build._CSRC), "-o", str(so),
           str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {tag}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    ref = kfb._library("dau_spectral_grads")
    for fn in ("dau_spectral_grads_smem_bytes", "dau_spectral_grads_ranges",
               "dau_spectral_grads_launch", "dau_spectral_operands_launch",
               "dau_spectral_dx_ranges", "dau_spectral_dx_launch"):
        getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
        getattr(lib, fn).restype = getattr(ref, fn).restype
    return lib


def _inputs(gen, s, f, hw, dev):
    """K1's operands at a layer shape, as `fourier_unit_grads_fused2` makes
    them, from random blurred planes, errors and offsets."""
    p1, p2, rb = fe.plan_bins(hw, hw, KS)
    span = KS // 2 + 1
    xb = torch.randn((M, N, s, hw, hw), generator=gen).to(dev, torch.bfloat16)
    err = torch.randn((N, f, hw, hw), generator=gen).to(dev, torch.bfloat16)
    xre, xim = fe._rdft2(xb, p1, p2, rb)
    xs = torch.cat([xre, xim], dim=1).permute(3, 0, 1, 2).contiguous()
    es = torch.cat(fe._rdft2(err, p1, p2, rb), dim=0).permute(2, 0, 1).contiguous()
    mu1, mu2 = (torch.rand((2, s, G, f), generator=gen) * 7.98 - 3.99).to(dev)
    a1 = fe._phase_onehot(mu1, span, True).permute(0, 2, 1, 3)
    a2 = fe._phase_onehot(mu2, span, True).permute(0, 2, 1, 3)
    t1 = fe._phase_table(p1, p1, span, torch.float32, dev)
    t2 = fe._phase_table(p2, rb, span, torch.float32, dev, coef_p1=p1)
    esb = torch.randn((p1 * rb, 2 * N, f), generator=gen).to(dev, torch.bfloat16)
    wg = (torch.randn((G, s, f), generator=gen) * 0.1).to(dev, torch.bfloat16)
    return (xs, es, t1, t2, a1, a2), dict(n_img=N, p1b=p1, rbb=rb), dict(esb=esb, wg=wg)


def _kernel_ms(call, fragment: str, iters: int = 5) -> float:
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and fragment in e.key) / 1e3 / iters


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dx", action="store_true", help="time the dx kernel's variants")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    inputs = [_inputs(gen, s, f, hw, dev) for _, s, f, hw in LAYERS]
    variants = DX_VARIANTS if args.dx else VARIANTS
    sources = {name: _variant_source(edits) for name, edits in variants.items()}
    kfb._library("dau_spectral_grads")  # built once, before the variants copy its signatures
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(sources)) as pool:
        libs = dict(zip(sources, pool.map(_compile, [str(i) for i in range(len(sources))],
                                          sources.values())))
    library, stages = kfb._library, kfb._K1_STAGES
    try:
        for name, lib in libs.items():
            kfb._library = lambda _name, lib=lib: lib
            kfb._ranges.cache_clear()
            kfb._dx_ranges.cache_clear()
            kfb._K1_STAGES = 3 if "ring of 3" in name and not args.dx else stages
            if args.dx:
                times = [_kernel_ms(lambda: kfb.fused_spectral_grads(*ops, **kw, **dx),
                                    "spectral_dx_kernel") for ops, kw, dx in inputs]
            else:
                times = [_kernel_ms(lambda: kfb.fused_spectral_grads(*ops, **kw),
                                    "spectral_grads_kernel") for ops, kw, _ in inputs]
            cols = " | ".join(f"{lname} {t:.4f}" for (lname, *_), t in zip(LAYERS, times))
            print(f"{'dx' if args.dx else 'K1'} variant '{name}', N={N} bf16, kernel ms: {cols} "
                  f"| conv3-conv5 {sum(times[1:]):.4f} [{card}]")
    finally:
        kfb._library, kfb._K1_STAGES = library, stages
        kfb._ranges.cache_clear()
        kfb._dx_ranges.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
