"""The partial inverse DFT for Hopper (K7), and its plain twin.

Counterpart of `dau_convnet_tpu/kernels/spectral.py::partial_idft`.
`partial_idft` launches the hand-written CUDA kernel of
`csrc/dau_partial_idft.cu` on a CUDA tensor and calls the plain PyTorch twin
`partial_idft_plain` on a CPU tensor. There is no fallback: on a CUDA tensor
the kernel runs or the call raises.

Both compute

    table[p, c] = sum_k C[k,p] * tre[k,c] - S[k,p] * tim[k,c]

with the (B, P) iDFT matrices C and S rounded to the spectra's dtype first,
f32 sums, and the (P, C) table in `out_dtype`. The fused apply-phi (K3,
`fused_fwd.py`) closes with the same kernel, through `idft_launch_split`.

The kernel is one bf16 GEMM on the tensor cores, A @ [tre; tim], with A the
(P, 2B) matrix [C^T, -S^T]. `idft_operands` prepares it in torch: A in
column blocks padded to 64 bins and 128 rows (built once per matrices and
cached), the spectra as bf16 tensors with rows of a multiple of 8 values,
and the list of segments (spectra tensor, block of A) the kernel sums. f32
operands are split into bf16 hi + lo parts (`forward.split_bf16`): the
spectra as [hi, lo, hi] against the matrix blocks [hi, hi, lo] (no lo
block where the matrices are bf16 already).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ._build import load_library
from .forward import _DTYPE_CODE, split_bf16

__all__ = ["partial_idft", "partial_idft_plain", "idft_operands"]

_ROWS, _BINS = 128, 64      # the kernel's tile of positions and of bins
_A_CACHE_SIZE = 32
_a_cache: collections.OrderedDict = collections.OrderedDict()


def partial_idft_plain(cmat, smat, tre, tim, out_dtype=torch.float32):
    """Plain PyTorch twin of the kernel (the module's contract)."""
    cdt = tre.dtype
    out = (cmat.to(cdt).float().t() @ tre.float()
           - smat.to(cdt).float().t() @ tim.float())
    return out.to(out_dtype)


def _check(cmat, smat, tre, tim, out_dtype):
    if cmat.dim() != 2 or cmat.shape != smat.shape:
        raise ValueError(f"cmat, smat must be (B, P), got {tuple(cmat.shape)}, "
                         f"{tuple(smat.shape)}")
    if tre.dim() != 2 or tre.shape != tim.shape or tre.shape[0] != cmat.shape[0]:
        raise ValueError(f"tre, tim must be (B, C) with B={cmat.shape[0]}, got "
                         f"{tuple(tre.shape)}, {tuple(tim.shape)}")
    if tre.dtype not in _DTYPE_CODE or tim.dtype != tre.dtype:
        raise TypeError(f"tre, tim must be float32 or bfloat16 alike, got {tre.dtype}, "
                        f"{tim.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    for name, t in (("cmat", cmat), ("smat", smat), ("tim", tim)):
        if t.device != tre.device:
            raise ValueError(f"{name} is on {t.device}, tre on {tre.device}")


def partial_idft(cmat, smat, tre, tim, out_dtype=torch.float32):
    """The position-major table C^T @ tre - S^T @ tim, (P, C) in out_dtype.

    cmat, smat: (B, P) iDFT matrices (`fourier_engine._idft_mats`); tre,
    tim: (B, C) cross-spectra, f32 or bf16. On a CUDA tensor this launches
    the sm_90a kernel once (counted in `partial_idft.launches`); on a CPU
    tensor it computes the plain twin. Other devices raise.
    """
    _check(cmat, smat, tre, tim, out_dtype)
    if tre.device.type == "cpu":
        return partial_idft_plain(cmat, smat, tre, tim, out_dtype)
    if tre.device.type != "cuda":
        raise RuntimeError(f"partial_idft has no kernel for device {tre.device}")
    out = idft_launch(cmat, smat, tre, tim, out_dtype)
    partial_idft.launches += 1
    return out


partial_idft.launches = 0


def _a_blocks(cmat, smat, mat_dtype):
    """A's column blocks [C^T, -S^T] as bf16 (P_pad, B_pad) each, with the
    matrices rounded to mat_dtype first; in f32, each as hi then lo
    (`split_bf16`): [Ch, Cl, Sh, Sl]. Zero past P and past B."""
    b, p = cmat.shape
    pp, bp = -(-p // _ROWS) * _ROWS, -(-b // _BINS) * _BINS
    blocks = []
    for m in (cmat, -smat):
        mt = m.to(mat_dtype).float().t()
        parts = split_bf16(mt) if mat_dtype == torch.float32 else (mt.to(torch.bfloat16),)
        for part in parts:
            blocks.append(torch.nn.functional.pad(part, (0, bp - b, 0, pp - p)))
    return blocks


def _a_matrix(cmat, smat, mat_dtype):
    """The cached (P_pad, nblocks*B_pad) bf16 A of (cmat, smat) rounded to
    mat_dtype. The cache keeps the matrices alive beside their A, so a key
    of their storage, version, layout and dtypes names one content.

    Keyed on the matrices themselves, not on sizes: `partial_idft` takes
    any (B, P) matrices (the card tests pass random ones), and K3 hands
    over fresh transposed views of its cached matrices on every call. The
    version counter (`_version`, bumped by every in-place write) keeps an
    A built before such a write from being reused."""
    key = tuple((t.data_ptr(), t._version, tuple(t.shape), t.stride(), t.dtype, str(t.device))
                for t in (cmat, smat)) + (mat_dtype,)
    hit = _a_cache.get(key)
    if hit is not None:
        _a_cache.move_to_end(key)
        return hit[0]
    a = torch.cat(_a_blocks(cmat, smat, mat_dtype), dim=1)
    _a_cache[key] = (a, cmat, smat)
    if len(_a_cache) > _A_CACHE_SIZE:
        _a_cache.popitem(last=False)
    return a


def _spectra(t):
    """bf16 (B, C8) with C8 = C rounded up to 8 (zeros past C): rows whose
    byte stride TMA accepts."""
    c = t.shape[1]
    c8 = -(-c // 8) * 8
    t = t.to(torch.bfloat16)
    return torch.nn.functional.pad(t, (0, c8 - c)) if c8 != c else t.contiguous()


def idft_operands(cmat, smat, tre, tim, mat_dtype=None):
    """The kernel's operands: (a, spectra, segments, b_pad). a: the cached
    (P_pad, blocks*B_pad) bf16 matrix (`_a_matrix`); spectra: bf16 (B, C8)
    tensors; segments: (spectra index, first column of A) pairs whose
    products the kernel sums:

        table = sum_g a[:P, col_g:col_g+B] @ spectra[i_g][:, :C]

    mat_dtype: what the matrices are rounded to (default: the spectra's
    dtype)."""
    mat_dtype = tre.dtype if mat_dtype is None else mat_dtype
    a = _a_matrix(cmat, smat, mat_dtype)
    bp = -(-cmat.shape[0] // _BINS) * _BINS
    per = 2 if mat_dtype == torch.float32 else 1  # A's blocks per matrix: hi (and lo)
    if tre.dtype == torch.bfloat16:
        return a, [_spectra(tre), _spectra(tim)], [(0, 0), (1, per * bp)], bp
    spectra = [_spectra(x) for t in (tre, tim) for x in split_bf16(t)]  # re hi, lo; im hi, lo
    return a, spectra, _split_segments(per, bp), bp


def _split_segments(per: int, bp: int):
    """The segments of f32 spectra split in bf16 hi/lo parts, spectra [re
    hi, re lo, im hi, im lo], against A's blocks per matrix (`per`: hi, and
    lo where the matrices are f32)."""
    segments = []
    for half in (0, 1):
        hi, col = 2 * half, half * per * bp
        segments += [(hi, col), (hi + 1, col)]          # t_hi . A_hi + t_lo . A_hi
        if per == 2:
            segments.append((hi, col + bp))             # + t_hi . A_lo
    return segments


def idft_launch(cmat, smat, tre, tim, out_dtype, mat_dtype=None):
    """One launch of the kernel on CUDA tensors, not counted: the closing
    stage of K7. mat_dtype: what cmat and smat are rounded to (default: the
    spectra's dtype)."""
    a, spectra, segments, bp = idft_operands(cmat, smat, tre, tim, mat_dtype)
    return _launch(cmat, a, spectra, segments, bp, tre.shape[1], out_dtype)


def idft_launch_split(cmat, smat, parts, c: int, out_dtype, mat_dtype):
    """One launch of the kernel on f32 spectra already split in bf16 hi/lo
    parts, not counted: the closing stage of K3. parts: (4, B, C8) bf16,
    `split_bf16` of tre then of tim, [re hi, re lo, im hi, im lo], C8 = c
    rounded up to 8; the result is `idft_launch`'s on tre, tim."""
    a = _a_matrix(cmat, smat, mat_dtype)
    bp = -(-cmat.shape[0] // _BINS) * _BINS
    per = 2 if mat_dtype == torch.float32 else 1
    return _launch(cmat, a, list(parts), _split_segments(per, bp), bp, c, out_dtype)


def _launch(cmat, a, spectra, segments, bp: int, c: int, out_dtype):
    b, p = cmat.shape
    dev = spectra[0].device
    out = torch.empty((p, c), dtype=out_dtype, device=dev)
    ptrs = (ctypes.c_void_p * len(spectra))(*(t.data_ptr() for t in spectra))
    seg_idx = (ctypes.c_int * len(segments))(*(i for i, _ in segments))
    seg_col = (ctypes.c_int * len(segments))(*(col for _, col in segments))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().dau_partial_idft_launch(
            a.data_ptr(), a.shape[0], a.shape[1], ptrs, len(spectra), spectra[0].shape[1],
            seg_idx, seg_col, len(segments), bp, out.data_ptr(), _DTYPE_CODE[out_dtype], b, p,
            c, stream)
    if err != 0:
        raise RuntimeError(f"partial_idft launch failed: cudaError {err}")
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signature declared."""
    lib = load_library("dau_partial_idft")
    c_int, c_ptr, c_ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    lib.dau_partial_idft_launch.argtypes = (
        [c_ptr, c_int, c_int, c_ptr, c_int, c_ll, c_ptr, c_ptr, c_int, c_int, c_ptr, c_int, c_int,
         c_int, c_ll, c_ptr])
    lib.dau_partial_idft_launch.restype = c_int
    return lib
