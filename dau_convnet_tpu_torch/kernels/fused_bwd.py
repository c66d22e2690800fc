"""Fused spectral unit gradients for Hopper (K1, and K2 with the input
gradient; K8, the factored gather), and their plain twins.

Counterpart of `dau_convnet_tpu/kernels/fused_bwd.py::fused_spectral_grads_call`.
`fused_spectral_grads` launches the hand-written CUDA kernels of
`csrc/dau_spectral_grads.cu` on a CUDA tensor, one kernel under two gather
policies (gather='phi': K1; gather='factored': K8), and calls the plain
PyTorch twin (`fused_spectral_grads_plain`, `fused_factored_grads_plain`) on
a CPU tensor.
There is no fallback: on a CUDA tensor the kernel runs or the call raises.

All compute, for the re/im-stacked spectra xs (B, M, 2N, S) and es (B, 2N,
F) cast to xs's dtype,

    T[k,m,s,f]    = sum_n X[k,m,n,s] * conj(E[k,n,f])   (f32 sums, rounded
                                                          to xs's dtype)
    grad[m,s,g,f] = sum_k Re(phiU[k,s,g,f]) * Tre - Im(phiU) * Tim   (f32)

with phiU[k] = py[k1] * px[k2] (k = k1*rb + k2), py from the table t1 and
the one-hot a2 (mu2), px from t2 (which carries the rfft coefficient) and
a1 (mu1), the tables and one-hots rounded to xs's dtype first. The phi
gather sums over the bins with each unit's phase factor; the factored gather
first contracts T against the tables, rounding to xs's dtype where the
Pallas kernel's scratch does,

    P[k1,j2] = sum_k2 t2c[k2,j2] Tre - t2s[k2,j2] Tim,   Q[k1,j2] = sum_k2
    t2s Tre + t2c Tim   (f32 sums, rounded to xs's dtype)
    E[j1,j2] = sum_k1 t1c[k1,j1] P - t1s[k1,j1] Q       (f32)
    grad[g]  = sum_{j1,j2} a2[g,j1] a1[g,j2] E[j1,j2]     (f32)

With esb (B, 2N, F) and wg (G, S, F) they also return the input-gradient
spectra dX[k,n,s] = sum_{g,f} conj(phiU) * wg * Eb[k,n,f], (B, 2N, S) f32 as
[dXre; dXim] (the same function under either gather); the caller closes
them with the raw partial iDFT.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library
from .forward import _DTYPE_CODE, _MAX_SMEM, split_bf16_3

__all__ = ["FusedPlanError", "spectral_plan", "factored_plan", "fused_spectral_grads",
           "fused_spectral_grads_plain", "fused_factored_grads_plain", "spectral_operands",
           "spectral_table_quads", "bin_ranges", "row_ranges", "dx_operands", "interleaved_b",
           "tap_records"]

# (M, G) pairs the kernels are instantiated for: the f32 sums each thread
# keeps in registers spill beyond G = 4
_FILTERS = (3, 4)
_MAX_UNITS = 4
_MAX_EXPONENTS = 64  # table width the operand and dx kernels take
_K1_STAGES = 2       # the ring of K1 and K8 (csrc/dau_spectral_grads.cu)
_K1_ROWS = 64        # K rows per stage
_K1_WARPGROUPS = 2   # warpgroups, each on its own f of a block


class FusedPlanError(ValueError):
    """No fused-kernel plan exists for this shape; the op takes the unfused
    spectral gather instead (decided before the call, from the shape)."""


def _tc_plan(m: int, g: int, nj: int, ft: int):
    """{'smem': bytes} of a block of K1's kernel (`layout` in
    csrc/dau_spectral_grads.cu) at FT f per warpgroup, or None where it
    cannot take the shape (M not in (3, 4), G > 4, more than 64 exponents).
    A block of 64 s x 2 warpgroups x FT f holds two ring stages (the M
    planes' X tile, the ES tile and the bin's two table rows each), its
    units' weights and taps and the ring's barriers; the table rows are
    streamed per bin, so P1 and rb do not enter."""
    if m not in _FILTERS or not 1 <= g <= _MAX_UNITS or nj > _MAX_EXPONENTS:
        return None
    wgs = _K1_WARPGROUPS
    row = -(-4 * max(nj - 1, 1) // 32) * 32
    stage = m * _K1_ROWS * 64 * 2 + 2 * wgs * ft // 8 * _K1_ROWS * 16 + 2 * row * 4
    units = g * ft // 2 * 128 * wgs * 20
    smem = 1024 + _K1_STAGES * stage + units + 16 * _K1_STAGES
    return {"smem": smem} if smem <= _MAX_SMEM else None


def spectral_plan(*, m: int, g: int, nj: int, p1b: int, rbb: int):
    """Shape-only plan of the phi-gather kernel K1: {'smem': bytes}, or None
    where it cannot take the shape (`_tc_plan` at FT = `_k1_tile_f`)."""
    return _tc_plan(m, g, nj, _k1_tile_f(m, g))


def factored_plan(*, m: int, g: int, nj: int, p1b: int, rbb: int):
    """Shape-only plan of the factored-gather kernel K8, K1's kernel under
    its factored gather: {'smem': bytes}, or None where it cannot take the
    shape (`_tc_plan` at FT = `_k8_tile_f`). JAX's VMEM budget has no
    counterpart here."""
    return _tc_plan(m, g, nj, _k8_tile_f(m, g))


def _k1_tile_f(m: int, g: int) -> int:
    """f per K1 warpgroup (`PhiGather::tile_f` in csrc/dau_spectral_grads.cu):
    its cross-spectra, gather sums and phase factors fit the registers at 16
    up to M*G = 8, else at 8."""
    return 16 if m * g <= 8 else 8


def _k8_tile_f(m: int, g: int) -> int:
    """f per K8 warpgroup (`FactoredGather::tile_f`): beside K1's sums each
    thread keeps P and Q at each unit's two taps, 2*M*G*FT more; the widest
    of 16 and 8 at which the three take at most 170 registers, else 4."""
    return next((ft for ft in (16, 8) if ft * m * (5 * g + 2) // 2 <= 170), 4)


def _interleave(es_k, n_img: int):
    """ES (B, K, 2F) from re/im-stacked spectra (B, K, F), K a stack of
    2N-row segments [re; im]: column 2f is [Ere; Eim], column 2f+1 [-Eim;
    Ere], so X^T . ES gives Tre(s, f) in column 2f and Tim(s, f) in 2f+1."""
    b, k, f = es_k.shape
    e = es_k.reshape(b, k // (2 * n_img), 2, n_img, f)
    odd = torch.stack([-e[:, :, 1], e[:, :, 0]], dim=2)
    return torch.stack([e, odd], dim=-1).reshape(b, k, 2 * f)


def spectral_operands(xs, es, n_img: int):
    """K1's GEMM operands, both bf16: (xs_t (B, M, K, S8), es_t (B, C8, K,
    8)). bf16 spectra: K = 2N and xs_t is xs itself (S padded with zeros to
    S8, a multiple of 8, where it is not one). f32 spectra are split in
    three bf16 parts (`split_bf16_3`) stacked along K = 12N, x as [x1, x1,
    x2, x1, x2, x3] against es as [e1, e2, e1, e3, e2, e1]: the six products
    of K4, ~2**-24 of each f32 product. es_t is the interleaved ES
    (`_interleave`) chunk-major: column c at chunk c // 8, lane c % 8, the
    columns past 2F zero (C8 = ceil(2F / 8))."""
    b, _, _, s = xs.shape
    es = es.to(xs.dtype)
    if xs.dtype == torch.float32:
        x1, x2, x3 = split_bf16_3(xs)
        e1, e2, e3 = split_bf16_3(es)
        xs_k = torch.cat([x1, x1, x2, x1, x2, x3], dim=2)
        es_k = torch.cat([e1, e2, e1, e3, e2, e1], dim=1)
    else:
        xs_k, es_k = xs, es
    s8 = -(-s // 8) * 8
    if s8 != s:
        xs_k = torch.nn.functional.pad(xs_k, (0, s8 - s))
    es_i = _interleave(es_k, n_img)
    k, f2 = es_i.shape[1:]
    c8 = -(-f2 // 8)
    if c8 * 8 != f2:
        es_i = torch.nn.functional.pad(es_i, (0, c8 * 8 - f2))
    es_t = es_i.reshape(b, k, c8, 8).transpose(1, 2).contiguous()
    return xs_k.contiguous(), es_t


def spectral_table_quads(t, rows: int):
    """(rows, NJ-1, 4) f32 quads (c[j], c[j+1], s[j], s[j+1]) of a [cos;
    sin] table (2*rows, NJ): one 16-byte read gives a tap pair's factors."""
    c, sn = t[:rows], t[rows:]
    return torch.stack([c[:, :-1], c[:, 1:], sn[:, :-1], sn[:, 1:]], dim=-1).contiguous()


def bin_ranges(b: int, r: int):
    """The K1 kernel's bin ranges [(begin, end)], r of them at most: blocks
    of range z take bins [z*per, min(b, (z+1)*per)), per = ceil(b / r)."""
    per = -(-b // r)
    return [(z, min(b, z + per)) for z in range(0, b, per)]


def row_ranges(p1b: int, rbb: int, r: int):
    """K8's bin ranges [(begin, end)], r of them at most, each whole k1 rows
    of rb bins (bin k = k1*rb + k2): blocks of range z take rows [z*per,
    min(P1, (z+1)*per)), per = ceil(P1 / r), as the kernel's launch cuts
    them."""
    per = -(-p1b // r)
    return [(z * rbb, min(p1b, z + per) * rbb) for z in range(0, p1b, per)]


def _bits16(t):
    """The bf16 bits of t (bf16-exact values) as int32 in [0, 65536)."""
    return t.to(torch.bfloat16).view(torch.int16).int() & 0xFFFF


def dx_operands(esb, wg, a1, a2, n_img: int):
    """The dx kernel's operands, as K1's operand kernel builds them beside
    K1's: (eb_t, rec), for esb (B, 2N, F) and wg (G, S, F) in the spectra's
    dtype cdt and the one-hots a1, a2 (nj, G, S, F).

    eb_t (B, KT, NC) bf16 is the GEMM's B, the interleaved error copy: for
    f = 16c + f', row (c, segment q, 2f' + h) holds [Ere | Eim] (h = 0) or
    [Eim | -Ere] (h = 1) over the first 2N of NC = 2N rounded up to 8
    columns, zero past F and 2N; KT = ceil(F / 16) * segs * 32. bf16: one
    segment, esb as it is; f32: segs = 6, esb split in three
    (`split_bf16_3`) and stacked per step as [e1, e2, e1, e3, e2, e1]
    against A's [V1, V1, V2, V1, V2, V3]: the six products of K1 and K4.

    rec (PLANES, G, F, S) int32 holds each unit's taps (`_taps`, rounded to
    cdt) and weight w = wg, s innermost: bf16, three planes (w | j1 << 16 |
    j2 << 24; a0 | a1 << 16; b0 | b1 << 16, bf16 bits); f32, six (j1 | j2 <<
    16; a0; a1; b0; b1; w as f32 bits). j1, a are mu1's taps (into t2), j2,
    b mu2's (into t1)."""
    cdt = esb.dtype
    n = n_img
    ere, eim = esb[:, :n], esb[:, n:]
    rows = torch.stack([torch.cat([ere, eim], dim=1), torch.cat([eim, -ere], dim=1)], dim=1)
    eb_t = interleaved_b(rows.transpose(2, 3))                  # rows (B, 2 h, F, 2N)
    rec = tap_records(_taps(a1, cdt), _taps(a2, cdt), wg.to(cdt).float(), cdt)
    return eb_t, rec.transpose(2, 3).contiguous()               # (PLANES, G, F, S)


def interleaved_b(rows):
    """The per-bin GEMM's B (B, KT, NC) bf16 from its rows (B, 2 h, F, 2N)
    in the spectra's dtype: for f = 16c + f', row (c, segment q, 2f' + h)
    holds rows[:, h, f], zero past F and 2N (NC = 2N rounded up to 8, KT =
    ceil(F / 16) * segs * 32); bf16: one segment; f32: six, the rows split
    in three (`split_bf16_3`) and stacked per step as [e1, e2, e1, e3, e2,
    e1] against A's [V1, V1, V2, V1, V2, V3]. The dx kernel's and K3's."""
    b, _, f, n2 = rows.shape
    f16, nc = -(-f // 16) * 16, -(-n2 // 8) * 8
    f32 = rows.dtype == torch.float32
    parts = split_bf16_3(rows) if f32 else (rows.to(torch.bfloat16),)
    segs = [parts[i] for i in ((0, 1, 0, 2, 1, 0) if f32 else (0,))]
    e = torch.stack(segs, dim=1)                                 # (B, segs, 2, F, 2N)
    e = torch.nn.functional.pad(e, (0, nc - n2, 0, f16 - f))
    e = e.reshape(b, len(segs), 2, f16 // 16, 16, nc).permute(0, 3, 1, 4, 2, 5)
    return e.reshape(b, -1, nc).contiguous()


def tap_records(taps1, taps2, w, cdt):
    """The units' tap records, (PLANES, ...) int32 over the units' shape,
    from `_taps` of mu1's one-hot (j1, a0, a1: into t2) and of mu2's (j2,
    b0, b1: into t1) and the weights w (None: the caller folded them into
    mu2's taps). bf16, three planes (w | j1 << 16 | j2 << 24, w = 1.0 where
    None; a0 | a1 << 16; b0 | b1 << 16, bf16 bits; j up to 255); f32, j1 |
    j2 << 16 and the weights as f32 bits, w's plane only where given."""
    (j1, a0, a1), (j2, b0, b1) = taps1, taps2
    if cdt == torch.float32:
        weights = (a0, a1, b0, b1) + (() if w is None else (w,))
        return torch.stack([j1 | (j2 << 16)] + [t.view(torch.int32) for t in weights])
    wbits = 0x3F80 if w is None else _bits16(w)
    word = wbits | (j1.long() << 16) | (j2.long() << 24)
    word = word - ((word >> 31) << 32)  # j2 past 127 sets the sign bit
    return torch.stack([word.int(), _bits16(a0) | (_bits16(a1) << 16),
                        _bits16(b0) | (_bits16(b1) << 16)])


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


def _cross_plain(xs, es, n_img: int):
    """T = X conj(E) as (tre, tim), each (B, M, S, F): f32 sums of the
    operands in xs's dtype, rounded to it, widened to f32."""
    b, m, n2, s = xs.shape
    cdt = xs.dtype
    xs32 = xs.float()
    es32 = es.to(cdt).float()
    xs_im = torch.cat([xs32[:, :, n_img:], -xs32[:, :, :n_img]], dim=2)

    def cross(lhs):
        t = torch.bmm(lhs.transpose(2, 3).reshape(b, m * s, n2), es32)
        return t.to(cdt).float().reshape(b, m, s, -1)

    return cross(xs32), cross(xs_im)


def _phase_factors(t1, t2, a1, a2, p1b: int, rbb: int, cdt):
    """Each unit's phase factor over the bins, (phire, phiim), each (B, G,
    S, F) f32, from the tables and one-hots rounded to cdt."""
    a1 = a1.to(cdt).float()
    nj, g, s = a1.shape[:3]
    py = torch.matmul(t1.to(cdt).float(), a2.to(cdt).float().reshape(nj, -1))
    px = torch.matmul(t2.to(cdt).float(), a1.reshape(nj, -1))
    py = py.reshape(2 * p1b, g, s, -1)
    px = px.reshape(2 * rbb, g, s, -1)
    pyre, pyim = py[:p1b, None], py[p1b:, None]              # (P1, 1, G, S, F)
    pxre, pxim = px[None, :rbb], px[None, rbb:]              # (1, rb, G, S, F)
    b = p1b * rbb
    return ((pyre * pxre - pyim * pxim).reshape(b, g, s, -1),
            (pyre * pxim + pyim * pxre).reshape(b, g, s, -1))


def fused_spectral_grads_plain(xs, es, t1, t2, a1, a2, *, n_img: int, p1b: int,
                               rbb: int, esb=None, wg=None):
    """Plain PyTorch twin of the phi-gather kernel (the module's contract)."""
    m, cdt = xs.shape[1], xs.dtype
    tre, tim = _cross_plain(xs, es, n_img)
    phire, phiim = _phase_factors(t1, t2, a1, a2, p1b, rbb, cdt)
    grads = torch.stack([
        torch.sum(phire * tre[:, mi, None] - phiim * tim[:, mi, None], dim=0)
        for mi in range(m)])                                 # (M, G, S, F)
    grads = grads.transpose(1, 2)
    if esb is None:
        return grads
    return grads, _dx_spectra_plain(esb.to(cdt), phire, phiim, wg.to(cdt).float(), n_img)


def fused_factored_grads_plain(xs, es, t1, t2, a1, a2, *, n_img: int, p1b: int,
                               rbb: int, esb=None, wg=None):
    """Plain PyTorch twin of the factored-gather kernel K8: the contraction
    order and the roundings of the Pallas kernel `_kernel_factored` (the
    module's contract). The dx spectra are the phi twin's."""
    _, m, _, s = xs.shape
    cdt = xs.dtype
    tre, tim = _cross_plain(xs, es, n_img)                   # (B, M, S, F)
    f = tre.shape[-1]
    tre, tim = tre.reshape(p1b, rbb, -1), tim.reshape(p1b, rbb, -1)
    t1r, t2r = t1.to(cdt).float(), t2.to(cdt).float()
    t2c, t2s = t2r[:rbb].t(), t2r[rbb:].t()                  # (nj, rb)
    # the k2 contraction, rounded to cdt: (P1, nj, M*S*F)
    p = (torch.matmul(t2c, tre) - torch.matmul(t2s, tim)).to(cdt).float()
    q = (torch.matmul(t2s, tre) + torch.matmul(t2c, tim)).to(cdt).float()
    nj = t1.shape[1]
    # the k1 contraction in f32: E[j1, j2, m, s, f]
    e = (t1r[:p1b].t() @ p.reshape(p1b, -1) - t1r[p1b:].t() @ q.reshape(p1b, -1))
    e = e.reshape(nj, nj, m, 1, s, f)
    a1r = a1.to(cdt).float()[:, None]                        # (nj, 1, G, S, F)
    a2r = a2.to(cdt).float()
    grads = torch.zeros((m,) + tuple(a2r.shape[1:]), dtype=torch.float32, device=xs.device)
    for j1 in range(nj):                                     # (M, G, S, F)
        grads += a2r[j1] * torch.sum(a1r * e[j1], dim=0)
    grads = grads.transpose(1, 2)
    if esb is None:
        return grads
    phire, phiim = _phase_factors(t1, t2, a1, a2, p1b, rbb, cdt)
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


def _spectral_operands_cuda(lib, xs, es, a1, a2, t1, t2, n_img: int, p1b: int, rbb: int,
                            esb=None, wg=None):
    """K1's operands on the card, from one launch of the library's operand
    kernel: (xs_t, es_t, tq, idx, wts) as `spectral_operands`,
    `spectral_table_quads` (t1's rows, then t2's, rounded to xs's dtype) and
    `_taps` build them (the card tests hold them equal bit for bit). xs_t is
    xs itself where it can be read as it is (bf16, S a multiple of 8). With
    esb and wg (any strides), also the dx kernel's (eb_t, rec), as
    `dx_operands` builds them, from the same launch."""
    b, m, _, s = xs.shape
    f = es.shape[2]
    nj, g = a1.shape[0], a1.shape[1]
    dev = xs.device
    f32 = xs.dtype == torch.float32
    k = (12 if f32 else 2) * n_img
    s8 = -(-s // 8) * 8
    a1, a2 = a1.float(), a2.float()
    t1, t2 = t1.float().contiguous(), t2.float().contiguous()
    copy_xs = f32 or s8 != s
    xs_t = torch.empty((b, m, k, s8), dtype=torch.bfloat16, device=dev) if copy_xs else xs
    es_t = torch.empty((b, -(-2 * f // 8), k, 8), dtype=torch.bfloat16, device=dev)
    tq = torch.empty((p1b + rbb, nj - 1, 4), dtype=torch.float32, device=dev)
    idx = torch.empty((2, g, s, f), dtype=torch.int32, device=dev)
    wts = torch.empty((4, g, s, f), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 8)(*a1.stride(), *a2.stride())
    dx = ()
    dx_ptrs = (None, None, None, None, None)
    if esb is not None:
        esb, wg = esb.to(xs.dtype), wg.to(xs.dtype)  # no copies where they are in it
        kt = -(-f // 16) * (6 if f32 else 1) * 32
        dx = (torch.empty((b, kt, -(-2 * n_img // 8) * 8), dtype=torch.bfloat16, device=dev),
              torch.empty((6 if f32 else 3, g, f, s), dtype=torch.int32, device=dev))
        dx_ptrs = (esb.data_ptr(), wg.data_ptr(),
                   (ctypes.c_longlong * 6)(*esb.stride(), *wg.stride()), dx[0].data_ptr(),
                   dx[1].data_ptr())
    err = lib.dau_spectral_operands_launch(
        xs.data_ptr(), es.data_ptr(), a1.data_ptr(), a2.data_ptr(), strides, t1.data_ptr(),
        t2.data_ptr(), idx.data_ptr(), wts.data_ptr(), xs_t.data_ptr() if copy_xs else None,
        es_t.data_ptr(), tq.data_ptr(), *dx_ptrs, _DTYPE_CODE[xs.dtype], m, g, b, n_img, s, f,
        p1b, rbb, nj, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_spectral_grads operand launch failed: cudaError {err}")
    return (xs_t, es_t, tq, idx, wts) + dx


def fused_spectral_grads(xs, es, t1, t2, a1, a2, *, n_img: int, p1b: int, rbb: int,
                         esb=None, wg=None, gather: str = "phi"):
    """Unit gradients (M, S, G, F) f32 from the spectra; with esb and wg,
    (grads, dx spectra (B, 2N, S) f32).

    xs: (B, M, 2N, S) f32 or bf16, contiguous; es, esb: (B, 2N, F); t1:
    (2*P1, nj); t2: (2*rb, nj), the rfft coefficient folded in; a1, a2:
    (nj, G, S, F) bilinear one-hots of mu1, mu2 (non-zeros at two
    neighbouring entries at most); wg: (G, S, F) unit weights; gather:
    'phi' or 'factored'.

    On a CUDA tensor this launches the sm_90a kernels. gather='phi': without
    esb one K1 launch (counted in `fused_spectral_grads.launches_k1`), with
    esb one K2 call, K1's kernel and the dx kernel (counted once in
    `launches_k2`). gather='factored': one K8 launch (`launches_k8`), with
    esb K8 and the same dx kernel (counted once in `launches_k8_dx`). On a
    CPU tensor it computes the gather's plain twin. Other devices raise, and
    so does a shape without a plan (`spectral_plan`, `factored_plan`) on the
    card.
    """
    if gather not in ("phi", "factored"):
        raise ValueError(f"unknown gather mode {gather!r}")
    _check(xs, es, t1, t2, a1, a2, n_img, p1b, rbb, esb, wg)
    factored = gather == "factored"
    if xs.device.type == "cpu":
        twin = fused_factored_grads_plain if factored else fused_spectral_grads_plain
        return twin(xs, es, t1, t2, a1, a2, n_img=n_img, p1b=p1b, rbb=rbb, esb=esb, wg=wg)
    if xs.device.type != "cuda":
        raise RuntimeError(f"fused_spectral_grads has no kernel for device {xs.device}")
    if not xs.is_contiguous():
        raise ValueError("xs must be contiguous")
    b, m, _, s = xs.shape
    f = es.shape[2]
    nj, g = a1.shape[0], a1.shape[1]
    plan = (factored_plan if factored else spectral_plan)(m=m, g=g, nj=nj, p1b=p1b, rbb=rbb)
    if plan is None:
        raise FusedPlanError(f"fused_spectral_grads ({gather}): no plan for M={m} G={g} "
                             f"nj={nj} P1={p1b} rb={rbb}")
    cdt = xs.dtype
    code = _DTYPE_CODE[cdt]
    es = es.to(cdt).contiguous()
    # one library, one kernel under the gather's policy: its entry points
    # are named dau_spectral_grads_* (K1) and dau_factored_grads_* (K8)
    name = "dau_factored_grads" if factored else "dau_spectral_grads"
    lib = _library("dau_spectral_grads")
    if getattr(lib, f"{name}_smem_bytes")(m, g, p1b, rbb, nj) != plan["smem"]:
        raise RuntimeError(f"fused_spectral_grads ({gather}): the plan disagrees with the "
                           "kernel's")
    xs_t, es_t, tq, idx, wts, *dx_ops = _spectral_operands_cuda(
        lib, xs, es, a1, a2, t1, t2, n_img, p1b, rbb, esb, wg)
    r = _ranges(name, code, m, g, b, s, f, p1b, rbb, nj)
    out = torch.empty((r, m, s, g, f), dtype=torch.float32, device=xs.device)
    counts = fused_spectral_grads
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = getattr(lib, f"{name}_launch")(
            xs_t.data_ptr(), es_t.data_ptr(), tq.data_ptr(), tq[p1b:].data_ptr(), idx.data_ptr(),
            wts.data_ptr(), out.data_ptr(), code, m, g, b, es_t.shape[2], s, f, p1b, rbb, nj, r,
            plan["smem"], stream)
        if err != 0:
            raise RuntimeError(f"fused_spectral_grads ({gather}) launch failed: cudaError {err}")
        grads = out[0] if r == 1 else out.sum(dim=0)
        if esb is None:
            if factored:
                counts.launches_k8 += 1
            else:
                counts.launches_k1 += 1
            return grads
        # the dx spectra: the same function under either gather, K2's dx
        # kernel on the operands built beside K1's
        eb_t, rec = dx_ops
        dxs = torch.empty((b, 2 * n_img, s), dtype=torch.float32, device=xs.device)
        err = lib.dau_spectral_dx_launch(
            eb_t.data_ptr(), rec.data_ptr(), tq.data_ptr(), dxs.data_ptr(), code, g, b, n_img, s,
            f, p1b, rbb, nj, _dx_ranges(code, g, b, n_img, s, nj), stream)
    if err != 0:
        raise RuntimeError(f"fused_spectral_grads dx launch failed: cudaError {err}")
    if factored:
        counts.launches_k8_dx += 1
    else:
        counts.launches_k2 += 1
    return grads, dxs


fused_spectral_grads.launches_k1 = 0
fused_spectral_grads.launches_k2 = 0
fused_spectral_grads.launches_k8 = 0
fused_spectral_grads.launches_k8_dx = 0


@functools.lru_cache(maxsize=None)
def _ranges(name, code, m, g, b, s, f, p1b, rbb, nj) -> int:
    """The kernel's bin ranges for a shape (the grid fills the card in whole
    waves; K8's ranges hold whole k1 rows, `row_ranges`)."""
    r = getattr(_library("dau_spectral_grads"), f"{name}_ranges")(code, m, g, b, s, f, p1b,
                                                                  rbb, nj)
    if r < 1:
        raise RuntimeError(f"{name} occupancy query failed: cudaError {-r}")
    return r


@functools.lru_cache(maxsize=None)
def _dx_ranges(code, g, b, n_img, s, nj) -> int:
    """The dx kernel's ranges of groups of bins (the grid fills the card in
    whole waves)."""
    r = _library("dau_spectral_grads").dau_spectral_dx_ranges(code, g, b, n_img, s, nj)
    if r < 1:
        raise RuntimeError(f"the dx kernel's occupancy query failed: cudaError {-r}")
    return r


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    """The built kernel library `name` (dau_spectral_grads: K1, K8, their
    operand kernel and the dx kernel) with every C signature declared."""
    lib = load_library(name)
    c_int, c_ptr, c_ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    for entry in ("dau_spectral_grads", "dau_factored_grads"):
        getattr(lib, f"{entry}_smem_bytes").argtypes = [c_int] * 5
        getattr(lib, f"{entry}_smem_bytes").restype = c_ll
        getattr(lib, f"{entry}_ranges").argtypes = [c_int] * 9
        getattr(lib, f"{entry}_ranges").restype = c_int
        getattr(lib, f"{entry}_launch").argtypes = [c_ptr] * 7 + [c_int] * 11 + [c_ll, c_ptr]
        getattr(lib, f"{entry}_launch").restype = c_int
    lib.dau_spectral_dx_smem_bytes.argtypes = [c_int] * 2
    lib.dau_spectral_dx_smem_bytes.restype = c_ll
    lib.dau_spectral_dx_ranges.argtypes = [c_int] * 6
    lib.dau_spectral_dx_ranges.restype = c_int
    lib.dau_spectral_dx_launch.argtypes = [c_ptr] * 4 + [c_int] * 10 + [c_ptr]
    lib.dau_spectral_dx_launch.restype = c_int
    lib.dau_spectral_operands_launch.argtypes = (
        [c_ptr] * 4 + [ctypes.POINTER(c_ll)] + [c_ptr] * 9 + [ctypes.POINTER(c_ll)]
        + [c_ptr] * 2 + [c_int] * 10 + [c_ptr])
    lib.dau_spectral_operands_launch.restype = c_int
    return lib
