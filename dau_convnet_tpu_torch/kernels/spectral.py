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
`fused_fwd.py`) closes with the same kernel, through `idft_launch`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library
from .forward import _DTYPE_CODE

__all__ = ["partial_idft", "partial_idft_plain"]


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


def idft_launch(cmat, smat, tre, tim, out_dtype):
    """One launch of the kernel on CUDA tensors, not counted: the shared
    closing stage of K7 and K3."""
    b, p = cmat.shape
    c = tre.shape[1]
    cdt = tre.dtype
    # the matrices rounded to the spectra's dtype, widened to f32: (2, B, P)
    cs = torch.stack([cmat.to(cdt), smat.to(cdt)]).float().contiguous()
    tre, tim = tre.contiguous(), tim.contiguous()
    out = torch.empty((p, c), dtype=out_dtype, device=tre.device)
    with torch.cuda.device(tre.device):
        stream = torch.cuda.current_stream(tre.device).cuda_stream
        err = _library().dau_partial_idft_launch(
            cs.data_ptr(), tre.data_ptr(), tim.data_ptr(), out.data_ptr(), _DTYPE_CODE[cdt],
            _DTYPE_CODE[out_dtype], b, p, c, stream)
    if err != 0:
        raise RuntimeError(f"partial_idft launch failed: cudaError {err}")
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signature declared."""
    lib = load_library("dau_partial_idft")
    c_int, c_ptr, c_ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    lib.dau_partial_idft_launch.argtypes = [c_ptr] * 4 + [c_int] * 4 + [c_ll, c_ptr]
    lib.dau_partial_idft_launch.restype = c_int
    return lib
