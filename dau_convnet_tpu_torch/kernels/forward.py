"""DAU forward kernels for Hopper and their plain twins.

Counterpart of `dau_convnet_tpu/kernels/forward.py`:
- `dau_forward_fused` (K5, `dau_forward_fused_pallas`): y = aggregate(blur(x))
  with the blur valid only inside the image; CUDA source
  `csrc/dau_forward_fused.cu`, twin `dau_forward_fused_plain`;
- `aggregate_forward` (K4, `aggregate_forward_pallas`): the same aggregation
  on an input blurred beforehand; CUDA source `csrc/dau_aggregate.cu`, twin
  `aggregate_forward_plain`.
Each wrapper launches its kernel on a CUDA tensor and calls its twin on a
CPU tensor. There is no fallback: on a CUDA tensor the kernel runs or the
call raises.

Both kernels run one mainloop (`csrc/dau_aggregate.cuh`): the ks*ks taps as
shifted windows of a flat padded plane staged in shared memory, bf16
products on the tensor cores with f32 sums, and return the input's dtype.
Where ks is too large for one window of all its tap rows, the window holds
a band of kyb tap rows at a time; where a row of the plane is too wide for
one TMA box (256 pixels), the output columns are cut into strips, each its
own flat plane. `aggregate_plan` and `fused_plan` mirror the kernels'
plans, and the wrappers refuse through them before any launch.
Their wrappers build the same K operand (`aggregate_kernel_operand`): the
synthesized aggregation kernel (`synthesize_kernel_pfs`, in w's dtype, as
the JAX wrappers build it) as (ks*ks, F, S8) bf16, split in three
(`split_bf16_3`) and stacked six ways along the channels for f32 input. K4
stages a pre-blurred plane laid out chunk-major by its wrapper
(`aggregate_forward_operands`); K5 takes a chunk-major copy of raw x
(`fused_forward_operands`) and blurs it in f32 into the staged plane
itself, rounding the blurred values once to bf16 (bf16 x) or splitting them
in three (f32 x) as K4's wrapper does.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..ops import xla_engine
from ..ops._cache import tensor_cache
from ..ops.gaussian import depthwise_blur
from ._build import load_library

__all__ = ["dau_forward_fused", "dau_forward_fused_plain", "aggregate_forward",
           "aggregate_forward_plain", "aggregate_forward_operands", "aggregate_kernel_operand",
           "fused_forward_operands", "aggregate_plan", "fused_plan", "fused_cluster_size",
           "chunk_major", "split_bf16", "split_bf16_3"]

_MAX_SMEM = 227 * 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the geometry of K4's and K5's mainloop (csrc/dau_aggregate.cuh,
# csrc/dau_forward_fused.cu), which `aggregate_plan` and `fused_plan` mirror
_QB = 272               # flat output positions per block
_K_RING = 6 * 64 * 64 * 2  # STAGES K tiles of 64 f x 64 s, bf16
_RING_BARRIERS = 2 * 6 * 8
_TMA_BOX_MAX = 256
_FPAD = 3               # zeros on each side of a staged filter row
_GRID_YZ_MAX = 65535
_TMA_COORD_MAX = 2 ** 31
_TMA_DIM_MAX = 2 ** 32
_TMA_STRIDE_MAX = 2 ** 40


def _round128(v: int) -> int:
    return -(-v // 128) * 128


def _smem_for(nxb: int, window: int) -> int:
    """`smem_for`: the K ring, nxb windows and their barriers."""
    return 1024 + _K_RING + nxb * _round128(window) + _RING_BARRIERS + 4 * 8


def _window_plan(h: int, w: int, ks: int, kyb: int) -> dict:
    """`window_plan`: the staged window of one column strip w columns wide
    (the whole plane where it has one strip) at (H, ks) with bands of kyb
    tap rows: the rows that a tile's positions reach through kyb tap rows."""
    wp = w + ks - 1
    tiles = -(-((h - 1) * wp + w) // _QB)
    rows = max((t * _QB % wp + _QB + (kyb - 1) * wp + ks - 1 + wp - 1) // wp
               for t in range(tiles))
    return dict(wp=wp, tiles=tiles, rows=rows, kyb=kyb, bands=-(-ks // kyb),
                window=8 * rows * wp * 16)


def _check_grid(h: int, w: int, n: int, p: dict, what: str) -> None:
    """Raise ValueError, naming the limit, where a launch at N images of H x
    W with plan p leaves the grid's or a TMA map's range: the grid's y
    extent (tiles x strips) and z extent (N), the TMA column coordinates
    (up to W + ks) and dimensions, and the byte strides of the chunk-major
    copy (16*N*H*W bytes per chunk for bf16, 32 for K5's f32 raw copy)."""
    if p["tiles"] * p["strips"] > _GRID_YZ_MAX or n > _GRID_YZ_MAX:
        raise ValueError(f"{what} at N={n}, {h}x{w}: the grid's {p['tiles']} tiles x "
                         f"{p['strips']} strips or its {n} images exceed {_GRID_YZ_MAX}")
    if w + p["wp"] >= _TMA_COORD_MAX or max(h, w, n) >= _TMA_DIM_MAX:
        raise ValueError(f"{what} at N={n}, {h}x{w}: a TMA coordinate or dimension exceeds "
                         "its range")
    if 32 * n * h * w >= _TMA_STRIDE_MAX:
        raise ValueError(f"{what} at N={n}, {h}x{w}: a TMA stride exceeds {_TMA_STRIDE_MAX} "
                         "bytes")


@functools.lru_cache(maxsize=None)
def aggregate_plan(h: int, w: int, ks: int, n: int = 1) -> dict:
    """K4's launch plan, as the kernel's `make_plan` makes it. The output
    columns are cut into strips of wc columns whose padded row of wc + ks -
    1 pixels fits a TMA box side (256): one strip, wc = W, wherever W + ks
    - 1 <= 256. Within a strip, the tallest band of kyb tap rows (kyb = ks,
    one band, wherever that fits) whose staged window fits the shared
    memory, two windows where they fit, else one. {'wc', 'strips', 'wp',
    'tiles', 'rows', 'kyb', 'bands', 'window', 'nxb', 'smem'}; 'tiles' are
    a strip's. Raises ValueError, naming the limit, where none fits: ks
    wider than a TMA box (wc < 1), a window of one tap row above the shared
    memory, or a grid or TMA range exceeded at N images."""
    if h <= 0 or w <= 0 or ks < 1 or ks % 2 == 0:
        raise ValueError(f"no plan for a {h}x{w} plane at ks={ks}: the plane must be "
                         "non-empty and ks odd")
    wc = w if w + ks - 1 <= _TMA_BOX_MAX else _TMA_BOX_MAX - ks + 1
    if wc < 1:
        raise ValueError(f"the staged window of a {h}x{w} plane at ks={ks} does not fit: a "
                         f"padded row of ks={ks} taps is wider than a TMA box side "
                         f"({_TMA_BOX_MAX}) even for a strip of one column")
    strips = -(-w // wc)
    for kyb in range(ks, 0, -1):
        p = _window_plan(h, wc, ks, kyb)
        if p["rows"] > _TMA_BOX_MAX:
            continue
        for nxb in (2, 1):
            if _smem_for(nxb, p["window"]) <= _MAX_SMEM:
                p = dict(p, wc=wc, strips=strips, nxb=nxb, smem=_smem_for(nxb, p["window"]))
                _check_grid(h, w, n, p, f"K4 at ks={ks}")
                return p
    raise ValueError(f"the staged window of a {h}x{w} plane at ks={ks} does not fit the shared "
                     f"memory ({_MAX_SMEM} bytes) even with one tap row per band")


def _fused_plan_at(h: int, w: int, wc: int, ks: int, kb: int, in_bytes: int):
    """K5's plan for strips of wc columns (`fused_plan_at`), or None where
    no band's buffers fit."""
    rwp = (min(w, wc + ks - 1) + kb - 1) | 1
    filt = -(-kb * (kb + 2 * _FPAD) * 4 // 16) * 16
    for kyb in range(ks, 0, -1):
        p = _window_plan(h, wc, ks, kyb)
        vr = 0
        for t in range(p["tiles"]):
            for b in range(p["bands"]):
                top = t * _QB // p["wp"] - ks // 2 + b * kyb
                vr = max(vr, min(top + p["rows"], h) - max(top, 0))
        rr = vr + kb - 1
        if rr > _TMA_BOX_MAX:
            continue
        raw = rr * rwp * 8 * in_bytes
        for nxb in (2, 1):
            for nbuf in (2, 1):
                for rc in (8, 4, 2, 1):
                    smem = _smem_for(nxb, p["window"]) + nbuf * _round128(rc * raw) + filt + 32
                    if smem <= _MAX_SMEM:
                        return dict(p, wc=wc, strips=-(-w // wc), nxb=nxb, smem=smem, vr=vr,
                                    rr=rr, rwp=rwp, rc=rc, nbuf=nbuf)
    return None


@functools.lru_cache(maxsize=None)
def fused_plan(h: int, w: int, ks: int, kb: int, dtype, n: int = 1) -> dict:
    """K5's launch plan, as the kernel's `make_fused_plan` makes it: K4's
    strips, window and bands, and the raw buffers of x in `dtype` (f32 or
    bf16) at the tallest band of kyb tap rows that fits. A strip's raw row
    holds the image columns its window reaches (at most min(W, wc + ks -
    1)) and the blur's kb - 1 halo, rounded up to an odd pitch 'rwp': one
    strip, wc = W, wherever (W + kb - 1) | 1 <= 256 and the buffers fit,
    else the widest wc with (wc + ks - 1 + kb - 1) | 1 <= 256 whose
    buffers fit at some band (found by bisection: narrower strips take less
    shared memory). The keys of `aggregate_plan` and 'vr', 'rr', 'rwp',
    'rc', 'nbuf'. Raises ValueError, naming the limit, where none fits: ks
    + kb too wide for a TMA box (wc < 1), no strip and band whose buffers fit
    the shared memory, or a grid or TMA range exceeded at N images."""
    if h <= 0 or w <= 0 or ks < 1 or ks % 2 == 0 or kb < 1 or kb % 2 == 0:
        raise ValueError(f"no plan for a {h}x{w} plane at ks={ks}, kb={kb}: the plane must be "
                         "non-empty and ks and kb odd")
    in_bytes = 4 if dtype == torch.float32 else 2
    wc = w if (w + kb - 1) | 1 <= _TMA_BOX_MAX else _TMA_BOX_MAX + 1 - ks - kb
    if wc < 1:
        raise ValueError(f"the staged window of a {h}x{w} plane at ks={ks}, kb={kb} does not "
                         f"fit: a raw row of ks + kb - 1 = {ks + kb - 1} pixels is wider than a "
                         f"TMA box side ({_TMA_BOX_MAX}) even for a strip of one column")
    p = _fused_plan_at(h, w, wc, ks, kb, in_bytes)
    lo, hi = 1, wc - 1 if p is None else 0
    while lo <= hi:  # the widest narrower strip that fits
        mid = (lo + hi) // 2
        q = _fused_plan_at(h, w, mid, ks, kb, in_bytes)
        if q is None:
            hi = mid - 1
        else:
            p, lo = q, mid + 1
    if p is None:
        raise ValueError(f"the staged window of a {h}x{w} plane at ks={ks}, kb={kb} does not "
                         f"fit the shared memory ({_MAX_SMEM} bytes) even with one tap row per "
                         "band")
    _check_grid(h, w, n, p, f"K5 at ks={ks}, kb={kb}")
    return p


def split_bf16(t):
    """(hi, lo) bf16 with hi + lo = t to about 2**-16 relative: hi is t
    rounded to bf16, lo the rest rounded to bf16. The bf16 tensor-core
    kernel K7 takes f32 operands x, y as three products, xh*yh + xl*yh +
    xh*yl: x's parts stacked [hi, lo, hi] against y's [hi, hi, lo]."""
    hi = t.to(torch.bfloat16)
    return hi, (t.float() - hi).to(torch.bfloat16)  # hi widens exactly in the f32 sub


def split_bf16_3(t):
    """(t1, t2, t3) bf16 with t1 + t2 + t3 = t to about 2**-25 relative:
    each part is the rest so far rounded to bf16. K4 and K6 take f32
    operands x, y as the six products of parts whose orders sum to at most
    3 (x1*y1, x1*y2, x2*y1, x1*y3, x2*y2, x3*y1), which keep each f32
    product to about 2**-24: K4's f32 path feeds ReLUs and max-pools, and
    K6's sums cancel before a train-mode BatchNorm, where the three
    products of `split_bf16` (~2**-17) already move the gradients of a
    training step beyond 1e-3 of the f32 twins'."""
    t = t.float()
    t1 = t.to(torch.bfloat16)
    r = t - t1  # exact in f32, as is r - t2 below
    t2 = r.to(torch.bfloat16)
    return t1, t2, (r - t2).to(torch.bfloat16)


def chunk_major(t):
    """(N, H, W, C) -> (ceil(C/8), N, H, W*8) contiguous, in t's dtype:
    channel c at chunk c // 8, lane c % 8, the channels past C zero. A TMA
    box of it lands in shared memory as 16-byte pixels of 8 channels, the
    core-matrix rows of wgmma's no-swizzle layouts (K4, K6)."""
    n, h, w, c = t.shape
    cc = -(-c // 8)
    if c % 8:
        t = F.pad(t, (0, cc * 8 - c))
    out = t.new_empty((cc, n, h, w, 8))
    out.permute(1, 2, 3, 0, 4).copy_(t.reshape(n, h, w, cc, 8))  # one strided copy
    return out.reshape(cc, n, h, w * 8)


def dau_forward_fused_plain(x, w, mu1, mu2, blur_filter, ks: int,
                            use_interpolation: bool = True):
    """Plain PyTorch twin: depthwise blur, then the dense aggregation, in
    f32, cast to x's dtype. x: (N, S, H, W); w, mu1, mu2: (S, G, F);
    blur_filter: (kb, kb). Returns (N, F, H, W)."""
    xb = depthwise_blur(x.float(), blur_filter.float())
    y = xla_engine.aggregate_forward(xb, w, mu1, mu2, ks, use_interpolation)
    return y.to(x.dtype)


def aggregate_forward_plain(x_blur, w, mu1, mu2, ks: int,
                            use_interpolation: bool = True):
    """Plain PyTorch twin of K4: the dense aggregation of a pre-blurred
    input, in f32, cast to x_blur's dtype. x_blur: (N, S, H, W); w, mu1,
    mu2: (S, G, F). Returns (N, F, H, W)."""
    y = xla_engine.aggregate_forward(x_blur.float(), w, mu1, mu2, ks, use_interpolation)
    return y.to(x_blur.dtype)


def _check(x, w, mu1, mu2, blur_filter, ks):
    """Validate the arguments of either kernel (blur_filter None for K4)."""
    if x.dim() != 4:
        raise ValueError(f"x must be (N, S, H, W), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w.dim() != 3 or w.shape != mu1.shape or w.shape != mu2.shape:
        raise ValueError("w, mu1, mu2 must share one (S, G, F) shape, got "
                         f"{tuple(w.shape)}, {tuple(mu1.shape)}, {tuple(mu2.shape)}")
    if w.shape[0] != x.shape[1]:
        raise ValueError(f"x has {x.shape[1]} channels, params have {w.shape[0]}")
    tensors = [("w", w), ("mu1", mu1), ("mu2", mu2)]
    if blur_filter is not None:
        kb = blur_filter.shape[-1]
        if blur_filter.shape != (kb, kb) or kb % 2 != 1:
            raise ValueError(f"blur_filter must be odd and square, got {tuple(blur_filter.shape)}")
        tensors.append(("blur_filter", blur_filter))
    if ks % 2 != 1:
        raise ValueError(f"ks must be odd, got {ks}")
    for name, t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


@tensor_cache
def _tap_steps(ks: int, dtype, device):
    """The flat offsets of a unit's four bilinear taps from its floor tap."""
    return torch.tensor([0, 1, ks, ks + 1], dtype=dtype, device=device)


def synthesize_kernel_pfs(w, mu1, mu2, ks: int, use_interpolation: bool = True,
                          s_out: int | None = None):
    """`xla_engine.synthesize_kernel` built straight into K4's GEMM layout:
    (ks*ks, F, s_out) in w's dtype, s innermost, the channels past S zero
    (s_out defaults to S). Equal to synthesize_kernel(...).permute(2, 3, 1,
    0) bit for bit. Each (s, f) has at most 4*G nonzero positions, the
    bilinear taps of its units, so the same sums (per tap, over g in f32,
    rounded to w's dtype; then tap by tap in w's dtype) are formed there
    alone, for all taps at once, and scattered into a zeroed buffer: a few
    dozen small ops in place of a one-hot over all ks*ks positions per unit
    and tap. Where mu's dtype cannot hold every position exactly (bf16 past
    256: ks >= 17), the one-hot's rounded matches are kept by building it
    densely."""
    s, g, f = w.shape
    p2 = ks * ks
    s_out = s if s_out is None else s_out
    if p2 - 1 > 2.0 / torch.finfo(mu1.dtype).eps:  # the largest exact integer
        kern = xla_engine.synthesize_kernel(w, mu1, mu2, ks, use_interpolation)
        return F.pad(kern.permute(2, 3, 1, 0).reshape(p2, f, s), (0, s_out - s)).contiguous()
    # xla_engine._flat_taps for all taps at once: (D, S, G, F), tap d = 2*dy + dx
    c = ks // 2
    f1, f2 = torch.floor(mu1), torch.floor(mu2)
    base = (c + f2) * ks + (c + f1)
    if use_interpolation:
        a1, a2 = mu1 - f1, mu2 - f2
        iw = (torch.stack([1.0 - a2, a2])[:, None] * torch.stack([1.0 - a1, a1])[None])
        iw = iw.reshape(4, s, g, f)
        tgt = base[None] + _tap_steps(ks, mu1.dtype, mu1.device)[:, None, None, None]
    else:
        iw, tgt = torch.ones_like(mu1)[None], base[None]
    val = (w[None] * iw).to(w.dtype).float()
    pos = tgt.permute(0, 2, 1, 3).reshape(-1, s, f)  # (D*G, S, F): every target
    # part[d, q] = the tap-d sum over g at position pos[q]
    hit = tgt[:, None] == pos[None, :, :, None, :]  # (D, D*G, S, G, F)
    part = torch.sum(val[:, None] * hit, dim=3).to(w.dtype)
    kval = part[0]
    for d in range(1, part.shape[0]):
        kval = kval + part[d]
    # positions outside the kernel (offsets past its reach) take no tap, as
    # in the one-hot; they land in a scratch row
    idx = torch.where((pos >= 0) & (pos < p2), pos, p2).long()
    out = torch.zeros((p2 + 1, f, s_out), dtype=w.dtype, device=w.device)
    out.scatter_(0, idx.transpose(1, 2), kval.transpose(1, 2))  # equal targets, equal values
    return out[:p2]


def aggregate_kernel_operand(w, mu1, mu2, ks: int, use_interpolation: bool = True,
                             dtype=torch.bfloat16):
    """The K operand of K4 and K5 for input of `dtype`: K from
    `synthesize_kernel_pfs` (in w's dtype) as (ks*ks, F, S8) bf16,
    position-major, s innermost. bf16 input takes K rounded to bf16 (exact
    where w is bf16), S8 = S rounded up to 8. f32 input takes K split in
    three (`split_bf16_3`) and stacked along the channels as [K1, K2, K1, K3,
    K2, K1] against the input's [x1, x1, x2, x1, x2, x3]; S8 is 6S rounded
    up to 8. The channels past the stack are zero."""
    s = w.shape[0]
    if dtype != torch.float32:
        kern = synthesize_kernel_pfs(w, mu1, mu2, ks, use_interpolation, s_out=-(-s // 8) * 8)
        return kern.to(torch.bfloat16)
    k1, k2, k3 = split_bf16_3(synthesize_kernel_pfs(w, mu1, mu2, ks, use_interpolation))
    return F.pad(torch.cat([k1, k2, k1, k3, k2, k1], dim=-1), (0, -6 * s % 8))


def aggregate_forward_operands(x_blur, w, mu1, mu2, ks: int,
                               use_interpolation: bool = True):
    """K4's operands: (xb_t, kern_t), bf16.

    kern_t: `aggregate_kernel_operand` for x_blur's dtype; xb_t: x_blur
    chunk-major, (S8/8, N, H, W*8) (`chunk_major`), f32 x_blur split in
    three (`split_bf16_3`) and stacked as [x1, x1, x2, x1, x2, x3] along the
    channels, the channels past the stack zero."""
    x = x_blur.permute(0, 2, 3, 1)
    kern_t = aggregate_kernel_operand(w, mu1, mu2, ks, use_interpolation, x_blur.dtype)
    if x_blur.dtype != torch.float32:
        return chunk_major(x.to(torch.bfloat16)), kern_t
    x1, x2, x3 = split_bf16_3(x)
    return chunk_major(torch.cat([x1, x1, x2, x1, x2, x3], dim=-1)), kern_t


def fused_forward_operands(x, w, mu1, mu2, blur_filter, ks: int,
                           use_interpolation: bool = True):
    """K5's operands: (x_t, kern_t, filt). kern_t is K4's K operand
    (`aggregate_kernel_operand`) for x's dtype; filt the (kb, kb) blur
    filter in f32; x_t raw x chunk-major in its own dtype, (S8/8, N, H, W*8)
    (`chunk_major`), its channels stacked as kern_t's: S for bf16 x, six
    copies of x for f32 x, the channels past the stack zero. The kernel
    blurs x_t in f32 and stages the blurred plane as K4's wrapper stages
    x_blur: rounded to bf16, or split in three and stacked as [x1, x1, x2,
    x1, x2, x3] against kern_t's [K1, K2, K1, K3, K2, K1]."""
    kern_t = aggregate_kernel_operand(w, mu1, mu2, ks, use_interpolation, x.dtype)
    xh = x.permute(0, 2, 3, 1)
    if x.dtype == torch.float32:
        xh = torch.cat([xh] * 6, dim=-1)
    return chunk_major(xh), kern_t, blur_filter.float().contiguous()


def dau_forward_fused(x, w, mu1, mu2, blur_filter, ks: int,
                      use_interpolation: bool = True):
    """Fully fused blur + aggregation. x: (N, S, H, W) -> (N, F, H, W).

    On a CUDA tensor this launches the sm_90a tensor-core kernel (one launch
    per call, counted in `dau_forward_fused.launches`; any odd ks and kb
    with a `fused_plan`, whose bands of tap rows take the tiers 33 and 65
    and whose column strips take planes of any width);
    on a CPU tensor it computes the plain twin. Other devices raise.
    """
    _check(x, w, mu1, mu2, blur_filter, ks)
    if x.device.type == "cpu":
        return dau_forward_fused_plain(x, w, mu1, mu2, blur_filter, ks,
                                       use_interpolation)
    if x.device.type != "cuda":
        raise RuntimeError(f"dau_forward_fused has no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")

    n, s, h, wd = x.shape
    f = w.shape[-1]
    kb = blur_filter.shape[-1]
    code = _DTYPE_CODE[x.dtype]
    plan = fused_plan(h, wd, ks, kb, x.dtype, n)  # raises, naming the limit, where none fits
    lib = _library("dau_forward_fused")
    if lib.dau_forward_fused_smem_bytes(h, wd, ks, kb, code) != plan["smem"]:
        raise RuntimeError("dau_forward_fused: the plan disagrees with the kernel's")
    x_t, kern_t, filt = fused_forward_operands(x, w, mu1, mu2, blur_filter, ks,
                                               use_interpolation)
    out = torch.empty((n, f, h, wd), dtype=x.dtype, device=x.device)
    csize = fused_cluster_size(f)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dau_forward_fused_launch(
            x_t.data_ptr(), filt.data_ptr(), kern_t.data_ptr(), out.data_ptr(), code, n, s, f,
            h, wd, ks, kb, kern_t.shape[-1], csize, stream)
    if err != 0:
        raise RuntimeError(f"dau_forward_fused launch failed: cudaError {err}")
    dau_forward_fused.launches += 1
    if csize == 1:
        dau_forward_fused.launches_clusterless += 1
    return out


dau_forward_fused.launches = 0
# the launches among them on the kernel's branch without a cluster
dau_forward_fused.launches_clusterless = 0


def fused_cluster_size(f: int) -> int:
    """Blocks per cluster of K5 for F output channels, which the wrapper
    passes to the launch (`csrc/dau_forward_fused.cu` takes it as given):
    pairs of 64-wide F tiles share their blur as a 2-block cluster where
    the tiles pair up, else each block blurs alone (an odd tile count:
    F = 64, 192, ...)."""
    return 2 if -(-f // 64) % 2 == 0 else 1


def aggregate_forward(x_blur, w, mu1, mu2, ks: int,
                      use_interpolation: bool = True):
    """DAU aggregation of a pre-blurred input (zero outside the image).
    x_blur: (N, S, H, W) -> (N, F, H, W) in x_blur's dtype.

    On a CUDA tensor this launches the sm_90a tensor-core kernel (one
    launch per call, counted in `aggregate_forward.launches`; any odd ks
    with an `aggregate_plan`, whose bands of tap rows take the tiers 33 and
    65 and whose column strips take planes of any width); on a CPU tensor
    it computes the plain twin. Other devices raise.
    """
    _check(x_blur, w, mu1, mu2, None, ks)
    if x_blur.device.type == "cpu":
        return aggregate_forward_plain(x_blur, w, mu1, mu2, ks, use_interpolation)
    if x_blur.device.type != "cuda":
        raise RuntimeError(f"aggregate_forward has no kernel for device {x_blur.device}")

    n, _, h, wd = x_blur.shape
    f = w.shape[-1]
    plan = aggregate_plan(h, wd, ks, n)  # raises, naming the limit, where none fits
    lib = _library("dau_aggregate")
    if lib.dau_aggregate_smem_bytes(h, wd, ks) != plan["smem"]:
        raise RuntimeError("aggregate_forward: the plan disagrees with the kernel's")
    xb_t, kern_t = aggregate_forward_operands(x_blur, w, mu1, mu2, ks, use_interpolation)
    out = torch.empty((n, f, h, wd), dtype=x_blur.dtype, device=x_blur.device)
    with torch.cuda.device(x_blur.device):
        stream = torch.cuda.current_stream(x_blur.device).cuda_stream
        err = lib.dau_aggregate_launch(
            xb_t.data_ptr(), kern_t.data_ptr(), out.data_ptr(), _DTYPE_CODE[x_blur.dtype], n,
            kern_t.shape[-1], f, h, wd, ks, stream)
    if err != 0:
        raise RuntimeError(f"aggregate_forward launch failed: cudaError {err}")
    aggregate_forward.launches += 1
    return out


aggregate_forward.launches = 0


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    """The built kernel library `name` with every C signature declared."""
    lib = load_library(name)
    c_int, c_ptr, c_ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    if name == "dau_forward_fused":
        lib.dau_forward_fused_smem_bytes.argtypes = [c_int] * 5
        lib.dau_forward_fused_smem_bytes.restype = c_ll
        lib.dau_forward_fused_launch.argtypes = [c_ptr] * 4 + [c_int] * 10 + [c_ptr]
        lib.dau_forward_fused_launch.restype = c_int
    else:
        lib.dau_aggregate_smem_bytes.argtypes = [c_int] * 3
        lib.dau_aggregate_smem_bytes.restype = c_ll
        lib.dau_aggregate_launch.argtypes = [c_ptr] * 3 + [c_int] * 7 + [c_ptr]
        lib.dau_aggregate_launch.restype = c_int
    return lib
