"""Fused spectral unit gradients for Hopper (K1, and K2 with the input
gradient), and their plain twin.

Counterpart of `dau_convnet_tpu/kernels/fused_bwd.py::fused_spectral_grads_call`
(phi gather). `fused_spectral_grads` launches the hand-written CUDA kernels of
`csrc/dau_spectral_grads.cu` on a CUDA tensor and calls the plain PyTorch
twin `fused_spectral_grads_plain` on a CPU tensor. There is no fallback: on
a CUDA tensor the kernel runs or the call raises.

Both compute, for the re/im-stacked spectra xs (B, M, 2N, S) and es (B, 2N,
F) cast to xs's dtype,

    T[k,m,s,f]    = sum_n X[k,m,n,s] * conj(E[k,n,f])   (f32 sums, rounded
                                                          to xs's dtype)
    grad[m,s,g,f] = sum_k Re(phiU[k,s,g,f]) * Tre - Im(phiU) * Tim   (f32)

with phiU[k] = py[k1] * px[k2] (k = k1*rb + k2), py from the table t1 and
the one-hot a2 (mu2), px from t2 (which carries the rfft coefficient) and
a1 (mu1), the tables and one-hots rounded to xs's dtype first. With esb
(B, 2N, F) and wg (G, S, F) they also return the input-gradient spectra
dX[k,n,s] = sum_{g,f} conj(phiU) * wg * Eb[k,n,f], (B, 2N, S) f32 as [dXre;
dXim]; the caller closes them with the raw partial iDFT.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library
from .forward import _DTYPE_CODE, _MAX_SMEM

__all__ = ["FusedPlanError", "spectral_plan", "fused_spectral_grads",
           "fused_spectral_grads_plain"]

# (M, G) pairs the kernel is instantiated for: the M*G*8 f32 sums each
# thread keeps in registers spill beyond G = 4
_FILTERS = (3, 4)
_MAX_UNITS = 4
_MAX_EXPONENTS = 64  # table width the dx kernel stages


class FusedPlanError(ValueError):
    """No fused-kernel plan exists for this shape; the op takes the unfused
    spectral gather instead (decided before the call, from the shape)."""


def spectral_plan(*, m: int, g: int, nj: int, p1b: int, rbb: int):
    """Shape-only plan of the fused kernel: {'smem': K1's shared-memory
    bytes}, or None where the kernel cannot take the shape: M not in (3, 4),
    G > 4, more than 64 exponents, or K1's shared memory above 227 KB."""
    if m not in _FILTERS or not 1 <= g <= _MAX_UNITS or nj > _MAX_EXPONENTS:
        return None
    st = 32 if m * g <= 8 else 16
    tab = -(-2 * (p1b + rbb) * nj // 4) * 4
    smem = 4 * (tab + 6 * g * st * 32 + m * 2 * 16 * st + 2 * 16 * 32)
    return {"smem": smem} if smem <= _MAX_SMEM else None


def _dx_spectra_plain(esb, phire, phiim, wg, n_img: int):
    """dX spectra from the per-unit phase factors (B, G, S, F) f32."""
    eb = esb.float()
    prs = torch.sum(phire * wg[None], dim=1)                 # (B, S, F)
    pis = torch.sum(phiim * wg[None], dim=1)
    ebre, ebim = eb[:, :n_img], eb[:, n_img:]                # (B, N, F)
    prt, pit = prs.transpose(1, 2), pis.transpose(1, 2)      # (B, F, S)
    dre = torch.bmm(ebre, prt) + torch.bmm(ebim, pit)
    dim = torch.bmm(ebim, prt) - torch.bmm(ebre, pit)
    return torch.cat([dre, dim], dim=1)


def fused_spectral_grads_plain(xs, es, t1, t2, a1, a2, *, n_img: int, p1b: int,
                               rbb: int, esb=None, wg=None):
    """Plain PyTorch twin of the fused kernel (the module's contract)."""
    b, m, n2, s = xs.shape
    cdt = xs.dtype
    xs32 = xs.float()
    es32 = es.to(cdt).float()
    xs_im = torch.cat([xs32[:, :, n_img:], -xs32[:, :, :n_img]], dim=2)

    def cross(lhs):                                          # -> (B, M, S, F)
        t = torch.bmm(lhs.transpose(2, 3).reshape(b, m * s, n2), es32)
        return t.to(cdt).float().reshape(b, m, s, -1)

    tre, tim = cross(xs32), cross(xs_im)
    t1 = t1.to(cdt).float()
    t2 = t2.to(cdt).float()
    a1 = a1.to(cdt).float()
    a2 = a2.to(cdt).float()
    nj, g = a1.shape[0], a1.shape[1]
    py = torch.matmul(t1, a2.reshape(nj, -1)).reshape(2 * p1b, g, s, -1)
    px = torch.matmul(t2, a1.reshape(nj, -1)).reshape(2 * rbb, g, s, -1)
    pyre, pyim = py[:p1b, None], py[p1b:, None]              # (P1, 1, G, S, F)
    pxre, pxim = px[None, :rbb], px[None, rbb:]              # (1, rb, G, S, F)
    phire = (pyre * pxre - pyim * pxim).reshape(b, g, s, -1)
    phiim = (pyre * pxim + pyim * pxre).reshape(b, g, s, -1)
    grads = torch.stack([
        torch.sum(phire * tre[:, mi, None] - phiim * tim[:, mi, None], dim=0)
        for mi in range(m)])                                 # (M, G, S, F)
    grads = grads.transpose(1, 2)
    if esb is None:
        return grads
    return grads, _dx_spectra_plain(esb.to(cdt), phire, phiim, wg.to(cdt).float(), n_img)


def _check(xs, es, t1, t2, a1, a2, n_img, p1b, rbb, esb, wg):
    if xs.dim() != 4 or es.dim() != 3:
        raise ValueError(f"expected xs (B, M, 2N, S) and es (B, 2N, F), got "
                         f"{tuple(xs.shape)} and {tuple(es.shape)}")
    b, m, n2, s = xs.shape
    f = es.shape[2]
    if es.shape[:2] != (b, n2) or n2 != 2 * n_img:
        raise ValueError(f"es {tuple(es.shape)} does not match xs {tuple(xs.shape)}, "
                         f"n_img={n_img}")
    if b != p1b * rbb:
        raise ValueError(f"B={b} != P1*rb={p1b * rbb}")
    if a1.dim() != 4 or a1.shape != a2.shape or a1.shape[2:] != (s, f):
        raise ValueError(f"a1, a2 must be (nj, G, S, F), got {tuple(a1.shape)}, "
                         f"{tuple(a2.shape)}")
    nj = a1.shape[0]
    if t1.shape != (2 * p1b, nj) or t2.shape != (2 * rbb, nj):
        raise ValueError(f"t1 {tuple(t1.shape)}, t2 {tuple(t2.shape)} do not match "
                         f"P1={p1b}, rb={rbb}, nj={nj}")
    if (esb is None) != (wg is None):
        raise ValueError("esb and wg go together")
    if esb is not None and (esb.shape != es.shape or wg.shape != (a1.shape[1], s, f)):
        raise ValueError(f"esb {tuple(esb.shape)} or wg {tuple(wg.shape)} does not match")
    if xs.dtype not in _DTYPE_CODE:
        raise TypeError(f"xs must be float32 or bfloat16, got {xs.dtype}")
    for name, t in (("es", es), ("t1", t1), ("t2", t2), ("a1", a1), ("a2", a2),
                    ("esb", esb), ("wg", wg)):
        if t is not None and t.device != xs.device:
            raise ValueError(f"{name} is on {t.device}, xs on {xs.device}")


def _taps(a, cdt):
    """The two taps of each bilinear one-hot column of a (nj, G, S, F): the
    index j of the first (clamped to nj-2) and the weights a[j], a[j+1],
    rounded to cdt. A one-hot from `_phase_onehot` has its non-zeros at
    two neighbouring entries at most; the kernel reads only those two."""
    nj = a.shape[0]
    j = (a != 0).float().argmax(dim=0).clamp(max=nj - 2)
    w = a.to(cdt).float()
    return j.int(), w.gather(0, j[None])[0], w.gather(0, (j + 1)[None])[0]


def fused_spectral_grads(xs, es, t1, t2, a1, a2, *, n_img: int, p1b: int, rbb: int,
                         esb=None, wg=None):
    """Unit gradients (M, S, G, F) f32 from the spectra; with esb and wg,
    (grads, dx spectra (B, 2N, S) f32).

    xs: (B, M, 2N, S) f32 or bf16, contiguous; es, esb: (B, 2N, F); t1:
    (2*P1, nj); t2: (2*rb, nj), the rfft coefficient folded in; a1, a2:
    (nj, G, S, F) bilinear one-hots of mu1, mu2 (non-zeros at two
    neighbouring entries at most); wg: (G, S, F) unit weights.

    On a CUDA tensor this launches the sm_90a kernels: without esb one K1
    launch (counted in `fused_spectral_grads.launches_k1`), with esb one K2
    call, K1's kernel and the dx kernel (counted once in `launches_k2`).
    On a CPU tensor it computes the plain twin. Other devices raise, and so
    does a shape without a plan (`spectral_plan`) on the card.
    """
    _check(xs, es, t1, t2, a1, a2, n_img, p1b, rbb, esb, wg)
    if xs.device.type == "cpu":
        return fused_spectral_grads_plain(xs, es, t1, t2, a1, a2, n_img=n_img, p1b=p1b,
                                          rbb=rbb, esb=esb, wg=wg)
    if xs.device.type != "cuda":
        raise RuntimeError(f"fused_spectral_grads has no kernel for device {xs.device}")
    if not xs.is_contiguous():
        raise ValueError("xs must be contiguous")
    b, m, _, s = xs.shape
    f = es.shape[2]
    nj, g = a1.shape[0], a1.shape[1]
    plan = spectral_plan(m=m, g=g, nj=nj, p1b=p1b, rbb=rbb)
    if plan is None:
        raise FusedPlanError(f"fused_spectral_grads: no plan for M={m} G={g} nj={nj} "
                             f"P1={p1b} rb={rbb}")
    cdt = xs.dtype
    code = _DTYPE_CODE[cdt]
    es = es.to(cdt).contiguous()
    t1 = t1.to(cdt).float().contiguous()
    t2 = t2.to(cdt).float().contiguous()
    j1, a1lo, a1hi = _taps(a1, cdt)
    j2, a2lo, a2hi = _taps(a2, cdt)
    idx = torch.stack([j1, j2]).contiguous()
    wts = torch.stack([a1lo, a1hi, a2lo, a2hi]).contiguous()

    lib = _library()
    if lib.dau_spectral_grads_smem_bytes(m, g, p1b, rbb, nj) != plan["smem"]:
        raise RuntimeError("fused_spectral_grads: the plan disagrees with the kernel's")
    r = _ranges(code, m, g, b, s, f, p1b, rbb, nj)
    out = torch.empty((r, m, s, g, f), dtype=torch.float32, device=xs.device)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = lib.dau_spectral_grads_launch(
            xs.data_ptr(), es.data_ptr(), t1.data_ptr(), t2.data_ptr(), idx.data_ptr(),
            wts.data_ptr(), out.data_ptr(), code, m, g, b, n_img, s, f, p1b, rbb, nj, r,
            plan["smem"], stream)
        if err != 0:
            raise RuntimeError(f"fused_spectral_grads launch failed: cudaError {err}")
        grads = out[0] if r == 1 else out.sum(dim=0)
        if esb is None:
            fused_spectral_grads.launches_k1 += 1
            return grads
        esb = esb.to(cdt).contiguous()
        wg = wg.to(cdt).float().contiguous()
        dxs = torch.empty((b, 2 * n_img, s), dtype=torch.float32, device=xs.device)
        err = lib.dau_spectral_dx_launch(
            esb.data_ptr(), t1.data_ptr(), t2.data_ptr(), idx.data_ptr(), wts.data_ptr(),
            wg.data_ptr(), dxs.data_ptr(), code, g, b, n_img, s, f, p1b, rbb, nj, stream)
    if err != 0:
        raise RuntimeError(f"fused_spectral_grads dx launch failed: cudaError {err}")
    fused_spectral_grads.launches_k2 += 1
    return grads, dxs


fused_spectral_grads.launches_k1 = 0
fused_spectral_grads.launches_k2 = 0


@functools.lru_cache(maxsize=None)
def _ranges(code, m, g, b, s, f, p1b, rbb, nj) -> int:
    """K1's bin ranges for a shape (the grid fills the card about once)."""
    r = _library().dau_spectral_grads_ranges(code, m, g, b, s, f, p1b, rbb, nj)
    if r < 1:
        raise RuntimeError(f"fused_spectral_grads occupancy query failed: cudaError {-r}")
    return r


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with every C signature declared."""
    lib = load_library("dau_spectral_grads")
    c_int, c_ptr, c_ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    lib.dau_spectral_grads_smem_bytes.argtypes = [c_int] * 5
    lib.dau_spectral_grads_smem_bytes.restype = c_ll
    lib.dau_spectral_grads_ranges.argtypes = [c_int] * 9
    lib.dau_spectral_grads_ranges.restype = c_int
    lib.dau_spectral_grads_launch.argtypes = [c_ptr] * 7 + [c_int] * 11 + [c_ll, c_ptr]
    lib.dau_spectral_grads_launch.restype = c_int
    lib.dau_spectral_dx_launch.argtypes = [c_ptr] * 7 + [c_int] * 9 + [c_ptr]
    lib.dau_spectral_dx_launch.restype = c_int
    return lib
