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

On the card the per-bin products are one bf16 GEMM per bin on the tensor
cores, Y^T[k] (CO x 2N) = A (CO x 2CI) . B (2CI x 2N), with A's columns 2ci,
2ci+1 holding Phre[ci, :], Phim[ci, :] (built in shared memory from each
unit's tap record) and B the interleaved copy of xs (`apply_phi_operands`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library
from .forward import _DTYPE_CODE, _MAX_SMEM
from .fused_bwd import _taps, interleaved_b, tap_records
from .spectral import idft_launch_split

__all__ = ["fused_apply_phi", "fused_apply_phi_plain", "apply_phi_plan", "apply_phi_operands"]

# widest exponent table K3 takes: its bf16 tap records keep j (<= nj - 2) in
# 8 bits (`dau_apply_phi.cu`)
_MAX_EXPONENTS = 256
_TILE = 64 * 32 * 2  # bytes of one 64 x 32 bf16 tile of the products kernel


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


def apply_phi_plan(*, nj: int, dtype):
    """{'smem': bytes} of a block of K3's products kernel
    (`tapgemm::layout` in csrc/dau_tap_gemm.cuh) for operands in `dtype`,
    or None where nj is outside 2 .. 256 (the records keep j in 8 bits). A
    block holds B's ring (3 stages of two bins' 64 x 32 tiles in bf16; 2 of
    six stacked tiles in f32), two A buffers (one part in bf16, three in
    f32), two bins' table quads and the ring's barriers; P1, rb, CI, CO and
    the units do not enter."""
    if not 2 <= nj <= _MAX_EXPONENTS:
        return None
    segs, parts, ring = (6, 3, 2) if dtype == torch.float32 else (1, 1, 3)
    smem = 1024 + ring * 2 * segs * _TILE + 2 * 2 * parts * _TILE + 2 * 2 * (nj - 1) * 16
    smem += 16 * ring
    return {"smem": smem} if smem <= _MAX_SMEM else None


def apply_phi_operands(xs, aw, a, n_img: int):
    """K3's GEMM operands, as its operand kernel builds them: (b_t, rec), for
    xs (B, 2N, CI) in the spectra's dtype cdt and the one-hots aw (mu2, w
    folded in), a (mu1), each (nj, G, CI, CO).

    b_t (B, KT, NC) bf16 is the GEMM's B, the interleaved copy of xs: for
    ci = 16c + ci', row (c, segment q, 2ci' + h) holds [Xre | Xim] (h = 0)
    or [-Xim | Xre] (h = 1) over the first 2N of NC = 2N rounded up to 8
    columns, zero past CI and 2N; KT = ceil(CI / 16) * segs * 32. bf16: one
    segment, xs as it is; f32: segs = 6, xs split in three (`split_bf16_3`)
    and stacked per step as [x1, x2, x1, x3, x2, x1] against A's [Phi1,
    Phi1, Phi2, Phi1, Phi2, Phi3]: the six products of K1, K2 and K4.

    rec (PLANES, G, CI, CO) int32 holds each unit's taps (`_taps`, rounded to
    cdt), co innermost: j1, a0, a1 of a (into t2), j2, b0, b1 of aw (into
    t1). bf16, three planes (1.0 | j1 << 16 | j2 << 24; a0 | a1 << 16; b0 |
    b1 << 16, bf16 bits: the dx kernel's record with w = 1); f32, five (j1 |
    j2 << 16; a0; a1; b0; b1 as f32 bits)."""
    cdt = xs.dtype
    n = n_img
    xre, xim = xs[:, :n], xs[:, n:]
    rows = torch.stack([torch.cat([xre, xim], dim=1), torch.cat([-xim, xre], dim=1)], dim=1)
    b_t = interleaved_b(rows.transpose(2, 3))                   # rows (B, 2 h, CI, 2N)
    return b_t, tap_records(_taps(a, cdt), _taps(aw, cdt), None, cdt).contiguous()


def fused_apply_phi(xs, t1, t2, aw, a, dct, dst, *, n_img: int, p1b: int, rbb: int):
    """The spatial output (HWp, N, CO) f32 of the per-bin products with Phi.

    xs: (B, 2N, CI) f32 or bf16, B = P1*rb; t1: (2*P1, nj), t2: (2*rb, nj)
    the integer-exponent tables (sin-negated for the input gradient); aw, a:
    (nj, G, CI, CO) bilinear one-hots of mu2 (w folded in) and mu1, with
    non-zeros at two neighbouring entries at most, any strides; dct, dst:
    (HWp, B) partial-iDFT matrices (rfft coefficient folded in).

    On a CUDA tensor this runs K3 as four launches, counted once in
    `fused_apply_phi.launches`: the operand kernel (B, the tap records and
    the table quads, `apply_phi_operands`), the per-bin products on the
    tensor cores into Y (B, 2N, CO) f32, the split of Y into bf16 hi/lo
    parts (`dau_apply_phi.cu`), and the partial iDFT of those with K7's
    kernel (`dau_partial_idft.cu`). On a CPU tensor it computes the plain twin.
    Other devices raise, and so does a table of more than 256 exponents on
    the card (`apply_phi_plan`) with ValueError.
    """
    _check(xs, t1, t2, aw, a, dct, dst, n_img, p1b, rbb)
    if xs.device.type == "cpu":
        return fused_apply_phi_plain(xs, t1, t2, aw, a, dct, dst, n_img=n_img, p1b=p1b,
                                     rbb=rbb)
    if xs.device.type != "cuda":
        raise RuntimeError(f"fused_apply_phi has no kernel for device {xs.device}")
    b, _, ci = xs.shape
    nj, g, _, co = aw.shape
    cdt = xs.dtype
    code = _check_plan(nj, cdt)
    lib = _library()
    dev = xs.device
    b_t, rec, tq = _operands_cuda(lib, xs, t1, t2, aw, a, n_img, p1b, rbb)
    y = torch.empty((b, 2 * n_img, co), dtype=torch.float32, device=dev)  # [Yre; Yim]
    with torch.cuda.device(dev):
        err = lib.dau_apply_phi_launch(
            b_t.data_ptr(), rec.data_ptr(), tq.data_ptr(), y.data_ptr(), code, g, b, n_img,
            ci, co, p1b, rbb, nj, _ranges(code, g, b, n_img, co, nj),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_apply_phi launch failed: cudaError {err}")
    out = idft_launch_split(dct.t(), dst.t(), _split_cuda(lib, y, n_img), n_img * co,
                            torch.float32, mat_dtype=cdt)
    fused_apply_phi.launches += 1
    return out.reshape(-1, n_img, co)


fused_apply_phi.launches = 0


@functools.lru_cache(maxsize=None)
def _check_plan(nj: int, cdt) -> int:
    """The dtype's code where `apply_phi_plan` takes nj and agrees with the
    kernel's shared memory; raises ValueError where it has no plan."""
    plan = apply_phi_plan(nj=nj, dtype=cdt)
    if plan is None:
        raise ValueError(f"fused_apply_phi: no plan for nj={nj} (2 to {_MAX_EXPONENTS} "
                         "exponents: the tap records keep j in 8 bits)")
    code = _DTYPE_CODE[cdt]
    if _library().dau_apply_phi_smem_bytes(code, nj) != plan["smem"]:
        raise RuntimeError("fused_apply_phi: the plan disagrees with the kernel's")
    return code


def _split_cuda(lib, y, n_img: int):
    """(4, B, C8) bf16 parts of y (B, 2N, CO) f32 from one launch of the
    split kernel: `forward.split_bf16` of Yre (B, N*CO) then of Yim, [re hi,
    re lo, im hi, im lo], C8 = N*CO rounded up to 8, zero past N*CO."""
    b, _, co = y.shape
    parts = torch.empty((4, b, -(-n_img * co // 8) * 8), dtype=torch.bfloat16, device=y.device)
    with torch.cuda.device(y.device):
        err = lib.dau_apply_phi_split_launch(y.data_ptr(), parts.data_ptr(), b, n_img, co,
                                             torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_apply_phi split launch failed: cudaError {err}")
    return parts


def _operands_cuda(lib, xs, t1, t2, aw, a, n_img: int, p1b: int, rbb: int):
    """K3's operands on the card from one launch of the operand kernel:
    (b_t, rec, tq) as `apply_phi_operands` and `fused_bwd.spectral_table_quads`
    (t1's rows, then t2's, rounded to xs's dtype) build them (the card tests
    hold them equal bit for bit). xs and the one-hots are read at any
    strides, the one-hots in f32 or bf16."""
    b, _, ci = xs.shape
    nj, g, _, co = aw.shape
    dev = xs.device
    if aw.dtype != a.dtype or aw.dtype not in _DTYPE_CODE:
        aw, a = aw.float(), a.float()
    t1, t2 = t1.float().contiguous(), t2.float().contiguous()
    f32 = xs.dtype == torch.float32
    b_t = torch.empty((b, -(-ci // 16) * (6 if f32 else 1) * 32, -(-2 * n_img // 8) * 8),
                      dtype=torch.bfloat16, device=dev)
    rec = torch.empty((5 if f32 else 3, g, ci, co), dtype=torch.int32, device=dev)
    tq = torch.empty((p1b + rbb, nj - 1, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.dau_apply_phi_operands_launch(
            xs.data_ptr(), (ctypes.c_longlong * 3)(*xs.stride()), aw.data_ptr(), a.data_ptr(),
            (ctypes.c_longlong * 8)(*aw.stride(), *a.stride()), _DTYPE_CODE[aw.dtype],
            t1.data_ptr(), t2.data_ptr(), b_t.data_ptr(), rec.data_ptr(), tq.data_ptr(),
            _DTYPE_CODE[xs.dtype], b, n_img, ci, co, g, p1b, rbb, nj,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_apply_phi operand launch failed: cudaError {err}")
    return b_t, rec, tq


@functools.lru_cache(maxsize=None)
def _ranges(code, g, b, n_img, co, nj) -> int:
    """The products kernel's ranges of groups of bins (the grid fills the
    card in whole waves)."""
    r = _library().dau_apply_phi_ranges(code, g, b, n_img, co, nj)
    if r < 1:
        raise RuntimeError(f"fused_apply_phi occupancy query failed: cudaError {-r}")
    return r


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = load_library("dau_apply_phi")
    c_int, c_ptr, c_ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    lib.dau_apply_phi_smem_bytes.argtypes = [c_int] * 2
    lib.dau_apply_phi_smem_bytes.restype = c_ll
    lib.dau_apply_phi_ranges.argtypes = [c_int] * 6
    lib.dau_apply_phi_ranges.restype = c_int
    lib.dau_apply_phi_operands_launch.argtypes = (
        [c_ptr, ctypes.POINTER(c_ll), c_ptr, c_ptr, ctypes.POINTER(c_ll), c_int] + [c_ptr] * 5
        + [c_int] * 9 + [c_ptr])
    lib.dau_apply_phi_operands_launch.restype = c_int
    lib.dau_apply_phi_launch.argtypes = [c_ptr] * 4 + [c_int] * 10 + [c_ptr]
    lib.dau_apply_phi_launch.restype = c_int
    lib.dau_apply_phi_split_launch.argtypes = [c_ptr] * 2 + [c_int] * 3 + [c_ptr]
    lib.dau_apply_phi_split_launch.restype = c_int
    return lib
