"""The fused apply-phi for Hopper (K3), and its plain twin.

Counterpart of `dau_convnet_tpu/kernels/fused_fwd.py::fused_apply_phi_call`.
`fused_apply_phi` launches the hand-written CUDA kernels of
`csrc/dau_apply_phi.cu` and `csrc/dau_partial_idft.cu` on a CUDA tensor and
calls the plain PyTorch twin `fused_apply_phi_plain` on a CPU tensor. There
is no fallback: on a CUDA tensor the kernels run or the call raises.

Both compute, for the re/im-stacked input spectra xs (B, 2N, CI),

    Phi[k,ci,co] = sum_g py_g[k1] * px_g[k2]     (each unit's product rounded
                                                  to xs's dtype, the sum over
                                                  g taken in xs's dtype)
    Y[k,n,co]    = sum_ci X[k,n,ci] * Phi[k,ci,co]          (complex, f32)
    out[ij,n,co] = sum_k dct[ij,k] Yre - dst[ij,k] Yim       (f32)

with py_g from the table t1 and the one-hot aw (w folded in; mu2), px_g from
t2 and the one-hot a (mu1), tables, one-hots and iDFT matrices rounded to
xs's dtype first. The input gradient is the same call with CI = F, CO = S
and sin-negated tables (`fourier_engine.fourier_apply_phi_fused`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library
from .forward import _DTYPE_CODE
from .fused_bwd import _MAX_EXPONENTS, _taps
from .spectral import idft_launch

__all__ = ["fused_apply_phi", "fused_apply_phi_plain"]


def fused_apply_phi_plain(xs, t1, t2, aw, a, dct, dst, *, n_img: int, p1b: int, rbb: int):
    """Plain PyTorch twin of the fused kernels (the module's contract)."""
    b, _, ci = xs.shape
    nj, g, _, co = aw.shape
    cdt = xs.dtype
    py = torch.matmul(t1.to(cdt).float(), aw.to(cdt).float().reshape(nj, -1))
    px = torch.matmul(t2.to(cdt).float(), a.to(cdt).float().reshape(nj, -1))
    py = py.reshape(2 * p1b, g, ci, co)
    px = px.reshape(2 * rbb, g, ci, co)
    phre = phim = None
    for gi in range(g):
        pyre, pyim = py[:p1b, gi, None], py[p1b:, gi, None]    # (P1, 1, CI, CO)
        pxre, pxim = px[None, :rbb, gi], px[None, rbb:, gi]    # (1, rb, CI, CO)
        pre = (pyre * pxre - pyim * pxim).reshape(b, ci, co).to(cdt)
        pim = (pyre * pxim + pyim * pxre).reshape(b, ci, co).to(cdt)
        phre = pre if phre is None else phre + pre
        phim = pim if phim is None else phim + pim
    xs32 = xs.float()
    d1 = torch.bmm(xs32, phre.float())                         # (B, 2N, CO)
    d2 = torch.bmm(xs32, phim.float())
    yre = d1[:, :n_img] - d2[:, n_img:]                        # (B, N, CO)
    yim = d2[:, :n_img] + d1[:, n_img:]
    out = (dct.to(cdt).float() @ yre.reshape(b, -1)
           - dst.to(cdt).float() @ yim.reshape(b, -1))
    return out.reshape(-1, n_img, co)


def _check(xs, t1, t2, aw, a, dct, dst, n_img, p1b, rbb):
    if xs.dim() != 3 or xs.shape[1] != 2 * n_img or xs.shape[0] != p1b * rbb:
        raise ValueError(f"xs must be (P1*rb, 2N, CI) = ({p1b * rbb}, {2 * n_img}, CI), got "
                         f"{tuple(xs.shape)}")
    b, _, ci = xs.shape
    if aw.dim() != 4 or aw.shape != a.shape or aw.shape[2] != ci:
        raise ValueError(f"aw, a must be (nj, G, CI, CO) with CI={ci}, got "
                         f"{tuple(aw.shape)}, {tuple(a.shape)}")
    nj = aw.shape[0]
    if t1.shape != (2 * p1b, nj) or t2.shape != (2 * rbb, nj):
        raise ValueError(f"t1 {tuple(t1.shape)}, t2 {tuple(t2.shape)} do not match "
                         f"P1={p1b}, rb={rbb}, nj={nj}")
    if dct.dim() != 2 or dct.shape != dst.shape or dct.shape[1] != b:
        raise ValueError(f"dct, dst must be (HWp, B) with B={b}, got {tuple(dct.shape)}, "
                         f"{tuple(dst.shape)}")
    if xs.dtype not in _DTYPE_CODE:
        raise TypeError(f"xs must be float32 or bfloat16, got {xs.dtype}")
    for name, t in (("t1", t1), ("t2", t2), ("aw", aw), ("a", a), ("dct", dct), ("dst", dst)):
        if t.device != xs.device:
            raise ValueError(f"{name} is on {t.device}, xs on {xs.device}")


def fused_apply_phi(xs, t1, t2, aw, a, dct, dst, *, n_img: int, p1b: int, rbb: int):
    """The spatial output (HWp, N, CO) f32 of the per-bin products with Phi.

    xs: (B, 2N, CI) f32 or bf16, B = P1*rb; t1: (2*P1, nj), t2: (2*rb, nj)
    the integer-exponent tables (sin-negated for the input gradient); aw, a:
    (nj, G, CI, CO) bilinear one-hots of mu2 (w folded in) and mu1, with
    non-zeros at two neighbouring entries at most; dct, dst: (HWp, B)
    partial-iDFT matrices (rfft coefficient folded in).

    On a CUDA tensor this runs K3 as two launches, counted once in
    `fused_apply_phi.launches`: the per-bin products with Phi built in shared
    memory (`dau_apply_phi.cu`), then the partial iDFT of their f32 spectra
    with K7's kernel (`dau_partial_idft.cu`). On a CPU tensor it computes
    the plain twin. Other devices raise, and so does a table wider than 64
    exponents on the card (the kernel's plan) with ValueError.
    """
    _check(xs, t1, t2, aw, a, dct, dst, n_img, p1b, rbb)
    if xs.device.type == "cpu":
        return fused_apply_phi_plain(xs, t1, t2, aw, a, dct, dst, n_img=n_img, p1b=p1b,
                                     rbb=rbb)
    if xs.device.type != "cuda":
        raise RuntimeError(f"fused_apply_phi has no kernel for device {xs.device}")
    b, _, ci = xs.shape
    nj, g, _, co = aw.shape
    if nj > _MAX_EXPONENTS:
        raise ValueError(f"fused_apply_phi: no plan for nj={nj} (at most {_MAX_EXPONENTS})")
    cdt = xs.dtype
    xs = xs.contiguous()
    t1 = t1.to(cdt).float().contiguous()
    t2 = t2.to(cdt).float().contiguous()
    j1, alo, ahi = _taps(a, cdt)
    j2, awlo, awhi = _taps(aw, cdt)
    idx = torch.stack([j1, j2]).contiguous()
    wts = torch.stack([alo, ahi, awlo, awhi]).contiguous()
    y = torch.empty((2, b, n_img, co), dtype=torch.float32, device=xs.device)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = _library().dau_apply_phi_launch(
            xs.data_ptr(), t1.data_ptr(), t2.data_ptr(), idx.data_ptr(), wts.data_ptr(),
            y.data_ptr(), _DTYPE_CODE[cdt], b, n_img, ci, co, g, p1b, rbb, nj, stream)
    if err != 0:
        raise RuntimeError(f"fused_apply_phi launch failed: cudaError {err}")
    out = idft_launch(dct.t(), dst.t(), y[0].reshape(b, -1), y[1].reshape(b, -1),
                      torch.float32, mat_dtype=cdt)
    fused_apply_phi.launches += 1
    return out.reshape(-1, n_img, co)


fused_apply_phi.launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signature declared."""
    lib = load_library("dau_apply_phi")
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    lib.dau_apply_phi_launch.argtypes = [c_ptr] * 6 + [c_int] * 9 + [c_ptr]
    lib.dau_apply_phi_launch.restype = c_int
    return lib
