"""Fourier engine: DAU aggregation as per-frequency contractions, in PyTorch.

Counterpart of `dau_convnet_tpu/ops/fourier_engine.py`. The sub-pixel
bilinear shift by mu becomes a 2-tap phase factor per frequency bin, so the
offset-and-sum over (s, g) is one small complex matmul per bin:

    Y[k,n,f] = sum_s X[k,n,s] * Phi[k,s,f],
    Phi[k,s,f] = sum_g w[s,g,f] * py[k1] * px[k2]      (k = k1*rb + k2)

and the unit gradients are the same trick on cross-spectra. DFTs are
matrix products against constant DFT matrices whose zero padding is built
in (transform length P >= H + ks//2, so there is no circular wrap).

Numerics follow the JAX dtype flow:
- the rDFT stages (`_rdft2`) and the separable blur are matmuls in the
  operand dtype (bf16 in, bf16 out);
- where JAX asks `dot_general(..., preferred_element_type=float32)` of bf16
  operands (`_bin_matmul`, `_tap_phase_tables`, `fourier_cross_spectra`),
  the port multiplies the operands widened to f32: a product of two bf16
  values is exact in f32, and the sum runs in f32, so the result is the f32
  one JAX gets;
- phase ANGLES are computed in f64 on the host (tables) or f32 (runtime
  trig), never bf16; the phase values may then be cast.

Every constant table (DFT/iDFT matrices, the integer-exponent phase
tables) is built once per (sizes, dtype, device) and cached on the device:
in eager PyTorch a `torch.tensor(array, device="cuda")` per call is a
blocking host copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ._cache import tensor_cache

__all__ = ["plan_bins", "build_phi", "fourier_forward", "fourier_apply_phi",
           "fourier_input_grad", "fourier_cross_spectra", "fourier_unit_grads",
           "fourier_unit_grads_fused2", "fourier_grad_tables", "fourier_apply_phi_fused"]


def plan_bins(h: int, w: int, ks: int):
    """Transform lengths (P1, P2) and rfft bin count for an H x W image with
    aggregation taps reaching ks//2."""
    c = ks // 2
    p1, p2 = h + c, w + c
    return p1, p2, p2 // 2 + 1


def _device(device) -> torch.device:
    return torch.device(device if device is not None else "cpu")


@tensor_cache
def _dft_mats_cached(n_in, p, nbins, dtype, device):
    i = np.arange(n_in)[:, None]
    k = np.arange(nbins)[None, :]
    ang = -2.0 * np.pi * i * k / p
    return (torch.tensor(np.cos(ang), dtype=dtype, device=device),
            torch.tensor(np.sin(ang), dtype=dtype, device=device))


def _dft_mats(n_in: int, p: int, nbins: int, dtype, device=None):
    """(n_in, nbins) cos/sin matrices: X[k] = sum_i x[i] e^{-2 pi i k i / p},
    angles in f64 on the host; cached per device."""
    return _dft_mats_cached(n_in, p, nbins, dtype, _device(device))


@tensor_cache
def _idft_mats_cached(p1, p2, rb, out1, out2, dtype, device, apply_coef):
    k1 = np.arange(p1)
    k2 = np.arange(rb)
    w2 = _rfft_coef(p2, rb)
    o1 = np.asarray(out1)[:, None]
    o2 = np.asarray(out2)[None, :]
    ang1 = 2.0 * np.pi * k1[:, None, None, None] * o1[None, None, :, :] / p1
    ang2 = 2.0 * np.pi * k2[None, :, None, None] * o2[None, None, :, :] / p2
    ang = ang1 + ang2
    coef = w2[None, :, None, None] / (p1 * p2) if apply_coef else 1.0
    shape = (p1 * rb, len(out1) * len(out2))
    return (torch.tensor((np.cos(ang) * coef).reshape(shape), dtype=dtype, device=device),
            torch.tensor((np.sin(ang) * coef).reshape(shape), dtype=dtype, device=device))


def _idft_mats(p1: int, p2: int, rb: int, out1, out2, dtype, device=None,
               apply_coef: bool = True):
    """Partial inverse-rDFT matrices (C, S), each (p1*rb, len(out1)*len(out2)),
    such that y = Xre @ C - Xim @ S is the real inverse at rows `out1` and
    columns `out2`, with the rfft conjugate-half weighting. apply_coef=False
    omits the w2/(P1*P2) coefficient (for spectra that carry it already)."""
    return _idft_mats_cached(p1, p2, rb, tuple(int(v) for v in out1),
                             tuple(int(v) for v in out2), dtype, _device(device),
                             apply_coef)


def _rdft2(x, p1: int, p2: int, rb: int):
    """Batched 2D rDFT of (..., H, W) real input -> (..., p1*rb) as an (re,
    im) pair, via two matmul stages in x's dtype (zero padding embedded)."""
    h, w = x.shape[-2:]
    c2, s2 = _dft_mats(w, p2, rb, x.dtype, x.device)
    are = torch.matmul(x, c2)
    aim = torch.matmul(x, s2)
    c1, s1 = _dft_mats(h, p1, p1, x.dtype, x.device)
    c1t, s1t = c1.t(), s1.t()
    xre = torch.matmul(c1t, are) - torch.matmul(s1t, aim)
    xim = torch.matmul(s1t, are) + torch.matmul(c1t, aim)
    lead = x.shape[:-2]
    return xre.reshape(*lead, p1 * rb), xim.reshape(*lead, p1 * rb)


def _tap_phase(mu, p: int, nbins: int, use_interpolation: bool, out_dtype,
               bin_leading: bool = False):
    """Per-bin complex factor of the bilinear 1D shift-by-mu read, (re, im),
    shape mu.shape + (nbins,), or (nbins,) + mu.shape when bin_leading.
    Runtime trig with f32 angles; results cast to out_dtype."""
    mu32 = mu.float()
    f = torch.floor(mu32)
    a = mu32 - f if use_interpolation else torch.zeros_like(mu32)
    k = torch.arange(nbins, dtype=torch.float32, device=mu.device)
    if bin_leading:
        k = k.reshape((nbins,) + (1,) * mu.dim())
        f, b = f[None], a[None]
    else:
        f, b = f[..., None], a[..., None]
    ang0 = (2.0 * np.pi / p) * f * k
    ang1 = ang0 + (2.0 * np.pi / p) * k
    re = (1.0 - b) * torch.cos(ang0) + b * torch.cos(ang1)
    im = (1.0 - b) * torch.sin(ang0) + b * torch.sin(ang1)
    return re.to(out_dtype), im.to(out_dtype)


def _phase_onehot(mu, span: int, use_interpolation: bool):
    """Bilinear one-hot weights over integer exponents, (2*span+2,) +
    mu.shape, f32: A[j] = (1-a)[j == floor(mu)+span] + a[j == floor(mu)+span+1],
    floor(mu) clamped to [-span, span]."""
    mu32 = mu.float()
    f = torch.floor(mu32)
    a = mu32 - f if use_interpolation else torch.zeros_like(mu32)
    f = torch.clamp(f, -span, span)
    nj = 2 * span + 2
    jidx = (f + span)[None]
    jio = torch.arange(nj, dtype=torch.float32, device=mu.device).reshape(
        (nj,) + (1,) * mu.dim())
    zero = mu32.new_zeros(())
    return (torch.where(jio == jidx, 1.0 - a[None], zero)
            + torch.where(jio == jidx + 1.0, a[None], zero))


def _phase_table_host(p: int, nbins: int, span: int):
    """Stacked [cos; sin] table (2*nbins, 2*span+2) for integer exponents e
    in [-span, span+1]: row k of the cos half is cos(2 pi k e / p). f64,
    numpy."""
    nj = 2 * span + 2
    k = np.arange(nbins)[:, None]
    e = np.arange(nj)[None, :] - span
    ang = 2.0 * np.pi * k * e / p
    return np.concatenate([np.cos(ang), np.sin(ang)])


@tensor_cache
def _phase_table_cached(p, nbins, span, dtype, device, coef_p1, conj):
    tab = _phase_table_host(p, nbins, span)
    if coef_p1:  # the rfft conjugate-half weights and 1/(P1*P2) folded in
        w2 = _rfft_coef(p, nbins)
        tab = tab * (np.concatenate([w2, w2])[:, None] / (coef_p1 * p))
    if conj:
        tab[nbins:] = -tab[nbins:]
    return torch.tensor(tab, dtype=dtype, device=device)


def _phase_table(p: int, nbins: int, span: int, dtype, device=None, coef_p1: int = 0,
                 conj: bool = False):
    """`_phase_table_host` as a device tensor, cached; with coef_p1 = P1 the
    rows carry w2[k]/(P1*P2) (the fused kernel's t2); conj negates the sin
    half (the factor's conjugate)."""
    return _phase_table_cached(p, nbins, span, dtype, _device(device), coef_p1, conj)


def _rfft_coef(p2: int, rb: int):
    """Conjugate-half weights of the rfft bins: 1 for bin 0 (and the Nyquist
    bin of an even length), 2 elsewhere."""
    w2 = np.full(rb, 2.0)
    w2[0] = 1.0
    if p2 % 2 == 0:
        w2[-1] = 1.0
    return w2


def _tap_phase_tables(mu, p: int, nbins: int, use_interpolation: bool,
                      out_dtype, span: int):
    """`_tap_phase` (bin-leading) without runtime transcendentals: the
    stacked integer cos/sin table against the bilinear one-hot weights,
    both in out_dtype, summed in f32, cast to out_dtype. Returns (re, im),
    each (nbins,) + mu.shape."""
    nj = 2 * span + 2
    onehot = _phase_onehot(mu, span, use_interpolation).reshape(nj, -1)
    tab = _phase_table(p, nbins, span, out_dtype, mu.device)
    res = torch.matmul(tab.float(), onehot.to(out_dtype).float())
    res = res.reshape((2, nbins) + tuple(mu.shape)).to(out_dtype)
    return res[0], res[1]


def build_phi(w, mu1, mu2, p1: int, p2: int, rb: int,
              use_interpolation: bool = True, phase_span: int | None = None):
    """Phi[k,s,f] = sum_g w * py(k1) * px(k2), bin-major (k = k1*rb + k2),
    in w's dtype; returns (phire, phiim), each (p1*rb, S, F). phase_span
    (ks//2 + 1 for a ks-tap layer) takes the phase factors from integer
    tables instead of runtime trig."""
    s, g, f = w.shape
    dtype = w.dtype
    if phase_span is not None:
        pyre, pyim = _tap_phase_tables(mu2, p1, p1, use_interpolation, dtype, phase_span)
        pxre, pxim = _tap_phase_tables(mu1, p2, rb, use_interpolation, dtype, phase_span)
    else:
        pyre, pyim = _tap_phase(mu2, p1, p1, use_interpolation, dtype, bin_leading=True)
        pxre, pxim = _tap_phase(mu1, p2, rb, use_interpolation, dtype, bin_leading=True)
    yre, yim = pyre[:, None], pyim[:, None]   # (P1, 1, S, G, F)
    xre, xim = pxre[None], pxim[None]         # (1, rb, S, G, F)
    wb = w[None, None]
    phire = torch.sum(wb * (yre * xre - yim * xim), dim=3)
    phiim = torch.sum(wb * (yre * xim + yim * xre), dim=3)
    return phire.reshape(p1 * rb, s, f), phiim.reshape(p1 * rb, s, f)


def _bmm32(a, b, contract_b_last: bool):
    """Batched f32 product of the operands widened to f32: (k, m, c) x (k, c,
    n), or x (k, n, c) when contract_b_last."""
    b = b.float()
    return torch.bmm(a.float(), b.transpose(1, 2) if contract_b_last else b)


def _bin_matmul(are, aim, bre, bim, conj_b: bool = False, contract=(2, 1),
                out_dtype=torch.float32):
    """Per-bin complex contraction batched over bins (dim 0): A[k,m,c] x
    B[k,c,n] (contract=(2, 1)) or x B[k,n,c] (contract=(2, 2)) ->
    out[k,m,n]; f32 sums of exact products, cast to out_dtype."""
    if conj_b:
        bim = -bim
    last = contract == (2, 2)
    re = (_bmm32(are, bre, last) - _bmm32(aim, bim, last)).to(out_dtype)
    im = (_bmm32(are, bim, last) + _bmm32(aim, bre, last)).to(out_dtype)
    return re, im


def fourier_apply_phi(x_blur, phire, phiim, h, w_sp, p1, p2, rb,
                      contract_f: bool = False, conj_phi: bool = False,
                      stacked: bool = False):
    """Transform x, contract against Phi per bin, transform back; (N, C, H,
    W) in x's dtype. contract_f contracts over Phi's F axis (the input
    gradient's direction); conj_phi conjugates Phi. `stacked` runs two
    products with X's re/im stacked along the rows (2N) instead of four."""
    n = x_blur.shape[0]
    xre, xim = _rdft2(x_blur, p1, p2, rb)                   # (N, C, B)
    if stacked:
        xs_t = torch.cat([xre, xim], dim=0).permute(2, 0, 1)  # (B, 2N, C)
        flip = (not conj_phi) if contract_f else conj_phi
        mm1 = _bmm32(xs_t, phire, contract_f)
        mm2 = _bmm32(xs_t, phiim, contract_f)
        if flip:
            mm2 = -mm2
        yre = mm1[:, :n] - mm2[:, n:]
        yim = mm2[:, :n] + mm1[:, n:]
    else:
        xre_t, xim_t = xre.permute(2, 0, 1), xim.permute(2, 0, 1)  # (B, N, C)
        if contract_f:
            yre, yim = _bin_matmul(xre_t, xim_t, phire, phiim, conj_b=not conj_phi,
                                   contract=(2, 2))
        else:
            yre, yim = _bin_matmul(xre_t, xim_t, phire, phiim, conj_b=conj_phi)
    return _spectra_to_image(yre, yim, p1, p2, rb, h, w_sp, out_dtype=x_blur.dtype)


@tensor_cache
def _idft_stage_mats_cached(p1, p2, rb, h, wd, dtype, device, apply_coef):
    ang1 = 2.0 * np.pi * np.arange(h)[:, None] * np.arange(p1)[None, :] / p1   # (H, P1)
    c1, s1 = np.cos(ang1), np.sin(ang1)
    a_re = np.stack([c1, s1], axis=1).reshape(2 * h, p1)
    a_im = np.stack([-s1, c1], axis=1).reshape(2 * h, p1)
    ang2 = 2.0 * np.pi * np.arange(rb)[:, None] * np.arange(wd)[None, :] / p2  # (rb, W)
    coef = (_rfft_coef(p2, rb) / (p1 * p2))[:, None] if apply_coef else 1.0
    b = np.concatenate([np.cos(ang2) * coef, -np.sin(ang2) * coef])
    return tuple(torch.tensor(t, dtype=dtype, device=device) for t in (a_re, a_im, b))


def _idft_stage_mats(p1: int, p2: int, rb: int, h: int, wd: int, dtype, device=None,
                     apply_coef: bool = True):
    """The two stages of the separable partial inverse rDFT, angles in f64
    on the host, cached per device: (A_re, A_im), each (2H, P1), whose rows
    2i and 2i+1 give Re and Im of sum_k1 e^{2 pi i k1 i / P1} Y[k1] from Yre
    and from Yim; and B (2*rb, W) = [cos; -sin](2 pi k2 j / P2), which
    takes the real part of sum_k2 e^{2 pi i k2 j / P2} Z[k2], its rows
    carrying the rfft weight w2[k2]/(P1*P2) unless apply_coef is False."""
    return _idft_stage_mats_cached(p1, p2, rb, h, wd, dtype, _device(device), apply_coef)


def _spectra_to_image(yre, yim, p1, p2, rb, h, w_sp, apply_coef: bool = True,
                      out_dtype=torch.float32):
    """Partial inverse rDFT of per-bin spectra (B, N, C) -> (N, C, H, W) in
    out_dtype: out[n,c,ij] = sum_k yre[k,n,c] C[k,ij] - yim[k,n,c] S[k,ij]
    with `_idft_mats`' (C, S), taken as two separable stages: k1 first (one
    GEMM pair over every (k2, n, c) column of the bin-major spectra), then
    k2 batched over the image rows. Products and sums in f32 (f64 for f64
    spectra); the permute to (N, C, H, W) rides on the one copy that casts
    to out_dtype. Counts its calls in `_spectra_to_image.calls`."""
    _spectra_to_image.calls += 1
    n, cout = yre.shape[1], yre.shape[2]
    dtype = torch.float64 if yre.dtype == torch.float64 else torch.float32
    a_re, a_im, b = _idft_stage_mats(p1, p2, rb, h, w_sp, dtype, yre.device, apply_coef)
    # reshape copies only a strided slice (the K2 dx closing's halves)
    z = torch.mm(a_re, yre.to(dtype).reshape(p1, -1))          # (2H, rb*N*C)
    z.addmm_(a_im, yim.to(dtype).reshape(p1, -1))
    # (H, N*C, W): W stays innermost, so the permuting copy moves whole rows
    out = torch.bmm(z.view(h, 2 * rb, n * cout).transpose(1, 2), b.expand(h, -1, -1))
    img = out.view(h, n, cout, w_sp).permute(1, 2, 0, 3)
    return torch.empty((n, cout, h, w_sp), dtype=out_dtype, device=yre.device).copy_(img)


_spectra_to_image.calls = 0


def fourier_forward(x_blur, w, mu1, mu2, ks: int, use_interpolation: bool = True,
                    phi=None):
    """Offset-and-sum over (s, g) units via per-frequency contraction, the
    function of `xla_engine.aggregate_forward`. x_blur: (N, S, H, W); w,
    mu1, mu2: (S, G, F) (w dummy-masked); phi: optional prebuilt (phire,
    phiim). Returns (N, F, H, W) in x_blur's dtype."""
    _, _, h, wd = x_blur.shape
    p1, p2, rb = plan_bins(h, wd, ks)
    if phi is None:
        phi = build_phi(w.to(x_blur.dtype), mu1, mu2, p1, p2, rb, use_interpolation)
    return fourier_apply_phi(x_blur, phi[0], phi[1], h, wd, p1, p2, rb)


def fourier_input_grad(gy_blur, phi, ks: int):
    """Input gradient from the mirror-blurred error and the FORWARD Phi:
    Phi(-mu, S<->F) = conj(Phi), contracted over F. (N, F, H, W) -> (N, S,
    H, W)."""
    _, _, h, wd = gy_blur.shape
    p1, p2, rb = plan_bins(h, wd, ks)
    return fourier_apply_phi(gy_blur, phi[0], phi[1], h, wd, p1, p2, rb, contract_f=True)


def _err_spectrum_stacked(err, p1, p2, rb):
    """Error spectrum with re/im stacked along N: (es_re, es_im), each (2N,
    F, B), so Re and Im of X*conj(E) are single K=2N contractions."""
    ere, eim = _rdft2(err, p1, p2, rb)                      # (N, F, B)
    return torch.cat([ere, eim], dim=0), torch.cat([-eim, ere], dim=0)


def fourier_cross_spectra(x_blur_k, err, ks: int, precision: str = "default"):
    """Cross-spectra T[k] = sum_n X[k] conj(E[k]) as (tre, tim), each (B, M,
    S, F), plus the bin plan; f32 sums, stored in f32 at
    precision='highest' and in the operand dtype otherwise."""
    m, n, s, h, wd = x_blur_k.shape
    p1, p2, rb = plan_bins(h, wd, ks)
    spec_dtype = torch.float32 if precision == "highest" else x_blur_k.dtype
    xre, xim = _rdft2(x_blur_k, p1, p2, rb)                 # (M, N, S, B)
    xs = torch.cat([xre, xim], dim=1)                       # (M, 2N, S, B)
    es_re, es_im = _err_spectrum_stacked(err, p1, p2, rb)   # (2N, F, B)
    b = p1 * rb
    lhs = xs.permute(3, 0, 2, 1).reshape(b, m * s, 2 * n)   # (B, M*S, 2N)

    def mm(e):
        return _bmm32(lhs, e.permute(2, 0, 1), False).reshape(b, m, s, -1).to(spec_dtype)

    return mm(es_re), mm(es_im), (p1, p2, rb)


def _spectral_gather(tre, tim, mu1, mu2, p1, p2, rb, use_interpolation,
                     phase_span=None):
    """grad[m,s,g,f] = sum_k Re(phi_unit) tre - Im(phi_unit) tim over the
    cross-spectra (B, M, S, F), the tap-gather in the spectral domain; the
    products in the spectra's dtype, the bin sum in f32."""
    b, m, s, f = tre.shape
    dtype = tre.dtype
    if phase_span is not None:
        pyre, pyim = _tap_phase_tables(mu2, p1, p1, use_interpolation, dtype, phase_span)
        pxre, pxim = _tap_phase_tables(mu1, p2, rb, use_interpolation, dtype, phase_span)
    else:
        pyre, pyim = _tap_phase(mu2, p1, p1, use_interpolation, dtype, bin_leading=True)
        pxre, pxim = _tap_phase(mu1, p2, rb, use_interpolation, dtype, bin_leading=True)
    coef = _coef_tensor(p1, p2, rb, dtype, tre.device)[:, None, None, None]
    xre, xim = pxre * coef, pxim * coef                     # (rb, S, G, F)
    yre, yim = pyre[:, None], pyim[:, None]                 # (P1, 1, S, G, F)
    phre = (yre * xre[None] - yim * xim[None]).reshape(b, s, -1, f)
    phim = (yre * xim[None] + yim * xre[None]).reshape(b, s, -1, f)
    out = []
    for mi in range(m):
        contrib = (tre[:, mi, :, None] * phre - tim[:, mi, :, None] * phim)
        out.append(torch.sum(contrib.float(), dim=0))
    return torch.stack(out)


@tensor_cache
def _coef_tensor(p1, p2, rb, dtype, device):
    return torch.tensor(_rfft_coef(p2, rb) / (p1 * p2), dtype=dtype, device=device)


def fourier_unit_grads(x_blur_k, err, mu1, mu2, ks: int, use_interpolation: bool = True,
                       precision: str = "default", phase_tables: bool = True):
    """Per-unit parameter gradients without the position table:
    cross-spectra, then the spectral tap-gather. x_blur_k: (M, N, S, H, W);
    err: (N, F, H, W). Returns (M, S, G, F) f32."""
    tre, tim, (p1, p2, rb) = fourier_cross_spectra(x_blur_k, err, ks, precision)
    return _spectral_gather(tre, tim, mu1, mu2, p1, p2, rb, use_interpolation,
                            phase_span=(ks // 2 + 1) if phase_tables else None)


def fourier_unit_grads_fused2(x_blur_k, err, mu1, mu2, ks: int,
                              use_interpolation: bool = True,
                              err_blur=None, w_units=None, gather: str = "phi"):
    """`fourier_unit_grads` with the cross-spectra and the spectral
    tap-gather in one kernel (`kernels/fused_bwd.py`): K1 with gather='phi'
    (each unit's phase factor over the bins), K8 with gather='factored'
    (the cross-spectra contracted against the integer-exponent tables, then
    combined per unit). Same contract: (M, S, G, F) f32.

    err_blur (N, F, H, W, the mirror-blurred error) with w_units (S, G, F,
    dummy-masked) also takes the input gradient from the same kernel call
    (K2, or K8 with dx); returns (grads, dx) with dx (N, S, H, W) f32. The
    kernel's t2 carries the rfft coefficient, so dx is closed by the RAW
    partial iDFT.
    """
    from ..kernels.fused_bwd import fused_spectral_grads

    m, n, s, h, wd = x_blur_k.shape
    p1, p2, rb = plan_bins(h, wd, ks)
    span = ks // 2 + 1
    dtype = x_blur_k.dtype
    xre, xim = _rdft2(x_blur_k, p1, p2, rb)                  # (M, N, S, B)
    xs = torch.cat([xre, xim], dim=1).permute(3, 0, 1, 2)    # (B, M, 2N, S)
    ere, eim = _rdft2(err, p1, p2, rb)                       # (N, F, B)
    es = torch.cat([ere, eim], dim=0).permute(2, 0, 1)       # (B, 2N, F)
    esb = wg = None
    if err_blur is not None:
        ebre, ebim = _rdft2(err_blur, p1, p2, rb)
        esb = torch.cat([ebre, ebim], dim=0).permute(2, 0, 1)
        wg = w_units.permute(1, 0, 2)                        # (G, S, F)
    t1 = _phase_table(p1, p1, span, torch.float32, x_blur_k.device)
    t2 = _phase_table(p2, rb, span, torch.float32, x_blur_k.device, coef_p1=p1)
    a1 = _phase_onehot(mu1, span, use_interpolation).permute(0, 2, 1, 3)  # (nj, G, S, F)
    a2 = _phase_onehot(mu2, span, use_interpolation).permute(0, 2, 1, 3)
    res = fused_spectral_grads(
        xs.to(dtype).contiguous(), es.to(dtype).contiguous(), t1, t2, a1, a2,
        n_img=n, p1b=p1, rbb=rb, esb=esb, wg=wg, gather=gather)
    if err_blur is None:
        return res
    grads, dxs = res
    dx = _spectra_to_image(dxs[:, :n], dxs[:, n:], p1, p2, rb, h, wd, apply_coef=False)
    return grads, dx


def fourier_grad_tables(x_blur_k, err, ks: int, precision: str = "default"):
    """Position table T[p,m,s,f] = sum_{n,ij} xbk[m,n,s,ij+p] err[n,f,ij] via
    the cross-spectra and the partial iDFT (K7, `kernels/spectral.py`): the
    function of `xla_engine.grad_tables`, position-major, which
    `xla_engine.tap_gather(..., table_layout='pmsf')` reads. x_blur_k: (M,
    N, S, H, W); err: (N, F, H, W). Returns (ks*ks, M, S, F) in the
    cross-spectra's dtype (f32 at precision='highest')."""
    from ..kernels.spectral import partial_idft

    m, _, s, _, _ = x_blur_k.shape
    f = err.shape[1]
    c = ks // 2
    tre, tim, (p1, p2, rb) = fourier_cross_spectra(x_blur_k, err, ks, precision)
    pos = np.arange(-c, c + 1)
    cmat, smat = _idft_mats(p1, p2, rb, pos, pos, tre.dtype, tre.device)
    table = partial_idft(cmat, smat, tre.reshape(p1 * rb, -1), tim.reshape(p1 * rb, -1),
                         out_dtype=tre.dtype)
    return table.reshape(ks * ks, m, s, f)


@tensor_cache
def _fused_idft_mats_cached(p1, p2, rb, h, wd, device):
    cmat, smat = _idft_mats(p1, p2, rb, range(h), range(wd), torch.float32, device)
    hwp = -(-h * wd // 8) * 8
    pad = (0, 0, 0, hwp - h * wd)
    return (torch.nn.functional.pad(cmat.t(), pad), torch.nn.functional.pad(smat.t(), pad),
            hwp)


def _fused_idft_mats(p1: int, p2: int, rb: int, h: int, wd: int, device=None):
    """(HWp, B) partial-iDFT cos/sin matrices of the fused apply-phi (rows
    padded to a multiple of 8 with zeros; rfft coefficient folded), and HWp;
    cached per device."""
    return _fused_idft_mats_cached(p1, p2, rb, h, wd, _device(device))


def fourier_apply_phi_fused(x_blur, w, mu1, mu2, ks: int, use_interpolation: bool = True,
                            contract_f: bool = False):
    """`fourier_forward` (contract_f=False) or the input gradient
    (contract_f=True, x_blur the mirror-blurred error) with Phi built from
    the taps inside the fused kernel (K3, `kernels/fused_fwd.py`): Phi never
    reaches device memory. The conjugate Phi of the input gradient is the
    same tables with their sin halves negated, contracted over F.

    w, mu1, mu2: (S, G, F). Returns (N, F, H, W), or (N, S, H, W) for the
    input gradient, in x_blur's dtype.
    """
    from ..kernels.fused_fwd import fused_apply_phi

    n, _, h, wd = x_blur.shape
    p1, p2, rb = plan_bins(h, wd, ks)
    span = ks // 2 + 1
    dtype = x_blur.dtype
    xre, xim = _rdft2(x_blur, p1, p2, rb)                    # (N, CI, B)
    xs = torch.cat([xre, xim], dim=0).permute(2, 0, 1)      # (B, 2N, CI)
    t1 = _phase_table(p1, p1, span, torch.float32, x_blur.device, conj=contract_f)
    t2 = _phase_table(p2, rb, span, torch.float32, x_blur.device, conj=contract_f)
    aw = _phase_onehot(mu2, span, use_interpolation) * w.float()[None]   # (nj, S, G, F)
    a1 = _phase_onehot(mu1, span, use_interpolation)
    order = (0, 2, 3, 1) if contract_f else (0, 2, 1, 3)    # (nj, G, CI, CO)
    dct, dst, _ = _fused_idft_mats(p1, p2, rb, h, wd, x_blur.device)
    out = fused_apply_phi(xs.to(dtype).contiguous(), t1, t2, aw.permute(order).to(dtype),
                          a1.permute(order).to(dtype), dct, dst, n_img=n, p1b=p1, rbb=rb)
    co = out.shape[2]
    return out[:h * wd].permute(1, 2, 0).reshape(n, co, h, wd).to(dtype)
