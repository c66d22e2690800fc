"""The Pallas throughput ladder P8-P9, asked again of the card.

Counterpart of `benchmarks/pallas_ladder.py` (the JAX script, run on a
TPU), which asked where a low DMA rate and a per-step cost came from, with
a copy kernel (P8 `run_copy`) and K7's contraction (P9 `run_dot`) in column
chunks of 2,048 and 8,192 over the same (B, C) = (153, 442,368) bf16 data
(C: conv4's M*S*F). Here:

- P8 `run_copy(x, ch)`: `kernels/probe_kernels.py::copy_tiles`, one block
  a tile of ch columns, beside `Tensor.copy_` and the 3.35 TB/s that every
  bound in the port divides by: the copy rate the card really reaches;
- P9 `run_dot(cm, sm, tre, tim, ch)`: the table C^T tre - S^T tim in bf16
  through K7's kernel (`kernels/spectral.py::partial_idft`, which computes
  exactly this), once over all C and once a chunk (216 and 54 launches);
  the chunks are cut (copied) apart and that time reported apart.

    python -m dau_convnet_tpu_torch.probes.pallas_ladder [--device cpu] [--trace]

The inputs come from `numpy.random.default_rng(0)` in the JAX script's
order (x, y, cm, sm). One PASS or FAIL line a probe, then its numbers;
unlike the JAX script it exits with 1 if a probe failed. It runs on the
CUDA card, and on the CPU (the twins only, no times) under `--device cpu`.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..examples import device_for
from ..kernels import probe_kernels as pk
from ..kernels import spectral as ksp
from . import (PEAK_BYTES, card, close, device_ms, gb_per_s, nbytes, new_row, run_probes,
               spread, tensor)

__all__ = ["B", "P", "C", "CHUNKS", "run_copy", "column_chunks", "run_dot", "dot_chunks",
           "inputs", "probe_copy", "probe_dot", "run", "main"]

B, P = 153, 81
C = 442368  # conv4 M*S*F
DTYPE = torch.bfloat16
CHUNKS = (2048, 8192)
DOT_TOL = 1e-2  # of max|twin|: one bf16 rounding of the table


def run_copy(x, ch: int):
    """P8: a copy of x in tiles of ch columns (one block each)."""
    return pk.copy_tiles(x, ch)


def column_chunks(t, ch: int):
    """t cut into contiguous (rows, ch) column chunks (copies)."""
    return [t[:, i:i + ch].contiguous() for i in range(0, t.shape[1], ch)]


def dot_chunks(cm, sm, tre_chunks, tim_chunks):
    """K7 on each pair of chunks: one launch and one (P, ch) bf16 table each."""
    return [ksp.partial_idft(cm, sm, re, im, out_dtype=DTYPE)
            for re, im in zip(tre_chunks, tim_chunks)]


def run_dot(cm, sm, tre, tim, ch: int | None = None):
    """P9: the (P, C) bf16 table C^T tre - S^T tim through K7's kernel, in
    one launch (ch None) or one launch per column chunk of ch."""
    if ch is None:
        return ksp.partial_idft(cm, sm, tre, tim, out_dtype=DTYPE)
    return torch.cat(dot_chunks(cm, sm, column_chunks(tre, ch), column_chunks(tim, ch)), dim=1)


def inputs(device):
    """x, y (B, C) and cm, sm (B, P), bf16, in the JAX script's order."""
    rng = np.random.default_rng(0)
    return tuple(tensor(rng.standard_normal(shape), DTYPE, device)
                 for shape in ((B, C), (B, C), (B, P), (B, P)))


def probe_copy(x):
    """P8 at each chunk size: the kernel (exact against the twin), its
    rate against 3.35 TB/s, and `Tensor.copy_`'s."""
    dev = x.device
    out = torch.empty_like(x)
    rows = []
    for ch in CHUNKS:
        err = close(f"P8 ch={ch}", run_copy(x, ch), pk.copy_tiles_plain(x, ch), 0)
        ms = spread(lambda: run_copy(x, ch), dev)
        lib = spread(lambda: out.copy_(x), dev)
        moved = 2 * nbytes(x)
        note = f"{x.shape[1] // ch} tiles"
        if ms is not None:
            rate = gb_per_s(moved, ms[0])
            note += (f"; {rate:.0f} GB/s ({rate * 1e9 / PEAK_BYTES * 100:.1f}% of 3.35 TB/s), "
                     f"Tensor.copy_ {gb_per_s(moved, lib[0]):.0f} GB/s")
        rows.append(new_row("P8", f"copy ch={ch}", pk.copy_tiles, err, 0, (0, moved), ms=ms,
                            device_ms=device_ms(lambda: run_copy(x, ch), dev,
                                                ("copy_tiles_kernel",)),
                            plain_ms=spread(lambda: pk.copy_tiles_plain(x, ch), dev),
                            library="Tensor.copy_", library_ms=lib,
                            library_device_ms=device_ms(lambda: out.copy_(x), dev, ("",)),
                            note=note))
    return rows


def probe_dot(cm, sm, tre, tim):
    """P9 over all C and in each chunk size: K7 against its twin (the
    chunked table also against the whole one), its time (the chunks cut
    beforehand; cutting them timed apart) beside one bf16 matmul of the
    stacked operands."""
    dev = tre.device
    b, p = cm.shape
    c = tre.shape[1]
    want = ksp.partial_idft_plain(cm, sm, tre, tim, out_dtype=DTYPE)
    whole = run_dot(cm, sm, tre, tim)
    err = close("P9 all C", whole, want, DOT_TOL)
    work = (4 * b * p * c, nbytes(cm, sm, tre, tim, whole))
    plain = spread(lambda: ksp.partial_idft_plain(cm, sm, tre, tim, out_dtype=DTYPE), dev)
    # one library call of the same function: [C; -S]^T @ [tre; tim] in bf16
    # (cuBLAS), its operands stacked beforehand
    lhs = torch.cat([cm, -sm]).t().contiguous()
    rhs = torch.cat([tre, tim])
    lib = spread(lambda: torch.matmul(lhs, rhs), dev)
    lib_dev = device_ms(lambda: torch.matmul(lhs, rhs), dev, ("",))
    del rhs
    library = "one bf16 matmul of the stacked operands"
    ms = spread(lambda: run_dot(cm, sm, tre, tim), dev)
    k7 = ("partial_idft_kernel",)
    rows = [new_row("P9", "dot all C (one launch)", ksp.partial_idft, err, DOT_TOL, work, ms=ms,
                    device_ms=device_ms(lambda: run_dot(cm, sm, tre, tim), dev, k7),
                    plain_ms=plain, library=library, library_ms=lib, library_device_ms=lib_dev)]
    for ch in CHUNKS:
        err = close(f"P9 ch={ch}", run_dot(cm, sm, tre, tim, ch), want, DOT_TOL)
        re, im = column_chunks(tre, ch), column_chunks(tim, ch)
        # on the card each column's sums run in the same order either way
        if dev.type == "cuda" and not torch.equal(
                torch.cat(dot_chunks(cm, sm, re, im), dim=1), whole):
            raise AssertionError(f"P9 ch={ch}: the chunked table differs from the whole one")
        rows.append(new_row(
            "P9", f"dot ch={ch} ({len(re)} launches)", ksp.partial_idft, err, DOT_TOL, work,
            ms=spread(lambda: dot_chunks(cm, sm, re, im), dev),
            device_ms=device_ms(lambda: dot_chunks(cm, sm, re, im), dev, k7, iters=3),
            operand_ms=spread(lambda: (column_chunks(tre, ch), column_chunks(tim, ch)), dev),
            plain_ms=plain, library=library, library_ms=lib,
            note="the chunked table equals the whole one bit for bit" if dev.type == "cuda"
            else ""))
        del re, im
    return rows


def run(device=torch.device("cuda"), trace: bool = False):
    """Run P8 and P9 on `device`; returns (both passed, their rows)."""
    device = torch.device(device)
    x, y, cm, sm = inputs(device)
    tests = (("copy", lambda dev: probe_copy(x)), ("dot", lambda dev: probe_dot(cm, sm, x, y)))
    return run_probes(tests, None, device, trace)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=["default", "cpu"], default="default",
                    help="default: the CUDA card; cpu runs the twins on the CPU")
    ap.add_argument("--trace", action="store_true", help="print a failing probe's traceback")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = device_for(args.device)
    print(f"device: {card() if dev.type == 'cuda' else 'cpu'}", flush=True)
    ok, _ = run(dev, args.trace)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
