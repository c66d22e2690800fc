"""DAU forward kernels for Hopper and their plain twins.

Counterpart of `dau_convnet_tpu/kernels/forward.py`:
- `dau_forward_fused` (K5, `dau_forward_fused_pallas`): y = aggregate(blur(x))
  with the blur valid only inside the image; CUDA source
  `csrc/dau_forward_fused.cu`, twin `dau_forward_fused_plain`;
- `aggregate_forward` (K4, `aggregate_forward_pallas`): the same aggregation
  on an input blurred beforehand; CUDA source `csrc/dau_aggregate.cu`, twin
  `aggregate_forward_plain`.
Both kernels share `csrc/dau_forward.cuh`. Each wrapper launches its kernel
on a CUDA tensor and calls its twin on a CPU tensor. There is no fallback:
on a CUDA tensor the kernel runs or the call raises.

Both work in f32 (bf16 input is widened) and return the input's dtype. The
synthesized aggregation kernel K is built with plain torch ops outside the
kernel, in w's dtype, and widened to f32 only afterwards, as the JAX
wrappers do.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..ops import xla_engine
from ..ops.gaussian import depthwise_blur
from ._build import load_library

__all__ = ["dau_forward_fused", "dau_forward_fused_plain",
           "aggregate_forward", "aggregate_forward_plain"]

_F_TILE = 32        # output channels per block (a multiple of the 8 per thread)
_COLS_PER_THREAD = 4
_MAX_PIXEL_GROUPS = 64  # rows * column groups per block: 4 * 64 = 256 threads
_MAX_SMEM = 227 * 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_SIZES = (3, 5, 7, 9, 11, 13, 15, 17)


def split_bf16(t):
    """(hi, lo) bf16 with hi + lo = t to about 2**-16 relative: hi is t
    rounded to bf16, lo the rest rounded to bf16. The bf16 tensor-core
    kernels (K6, K7) take f32 operands x, y as three products, xh*yh + xl*yh
    + xh*yl: x's parts stacked [hi, lo, hi] against y's [hi, hi, lo]."""
    hi = t.to(torch.bfloat16)
    return hi, (t.float() - hi).to(torch.bfloat16)  # hi widens exactly in the f32 sub


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


def _launch_plan(h: int, w: int):
    """(rows per block, column groups, threads) for an H x W output plane:
    each thread covers 8 channels x 4 consecutive columns of one row."""
    cg = -(-w // _COLS_PER_THREAD)
    if cg > _MAX_PIXEL_GROUPS:
        raise ValueError(f"width {w} exceeds the kernel's "
                         f"{_MAX_PIXEL_GROUPS * _COLS_PER_THREAD} columns")
    rt = min(h, _MAX_PIXEL_GROUPS // cg)
    threads = (_F_TILE // 8) * rt * cg
    return rt, cg, -(-threads // 32) * 32


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


def _check_cuda(name: str, x, ks: int):
    """Raise unless x is a contiguous CUDA tensor and ks has an instance."""
    if x.device.type != "cuda":
        raise RuntimeError(f"{name} has no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if ks not in _KERNEL_SIZES:
        raise ValueError(f"ks={ks} has no kernel instance (built: {_KERNEL_SIZES})")


def _padded_kernel(w, mu1, mu2, ks: int, use_interpolation: bool):
    """K from `synthesize_kernel` in w's dtype, widened to f32 and laid out
    (S, ks*ks, fk) for the kernels, with F padded by zeros to fk, a whole
    number of F tiles."""
    s, _, f = w.shape
    kern = xla_engine.synthesize_kernel(w, mu1, mu2, ks, use_interpolation)
    fk = -(-f // _F_TILE) * _F_TILE
    kern = F.pad(kern.float().reshape(s, f, ks * ks).transpose(1, 2), (0, fk - f))
    return kern.contiguous(), fk


def dau_forward_fused(x, w, mu1, mu2, blur_filter, ks: int,
                      use_interpolation: bool = True):
    """Fully fused blur + aggregation. x: (N, S, H, W) -> (N, F, H, W).

    On a CUDA tensor this launches the sm_90a kernel (one launch per call,
    counted in `dau_forward_fused.launches`); on a CPU tensor it computes the
    plain twin. Other devices raise.
    """
    _check(x, w, mu1, mu2, blur_filter, ks)
    if x.device.type == "cpu":
        return dau_forward_fused_plain(x, w, mu1, mu2, blur_filter, ks,
                                       use_interpolation)
    _check_cuda("dau_forward_fused", x, ks)

    n, s, h, wd = x.shape
    f = w.shape[-1]
    kern, fk = _padded_kernel(w, mu1, mu2, ks, use_interpolation)
    filt = blur_filter.float().contiguous()
    kb = filt.shape[-1]
    out = torch.empty((n, f, h, wd), dtype=x.dtype, device=x.device)

    lib = _library("dau_forward_fused")
    rt, cg, threads = _launch_plan(h, wd)
    smem = lib.dau_forward_fused_smem_bytes(ks, kb, _F_TILE, rt, cg)
    if smem > _MAX_SMEM:
        raise ValueError(f"plan needs {smem} bytes of shared memory (> {_MAX_SMEM})")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dau_forward_fused_launch(
            x.data_ptr(), filt.data_ptr(), kern.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[x.dtype], n, s, f, fk, h, wd, kb, ks, _F_TILE, rt, cg,
            threads, smem, stream)
    if err != 0:
        raise RuntimeError(f"dau_forward_fused launch failed: cudaError {err}")
    dau_forward_fused.launches += 1
    return out


dau_forward_fused.launches = 0


def aggregate_forward(x_blur, w, mu1, mu2, ks: int,
                      use_interpolation: bool = True):
    """DAU aggregation of a pre-blurred input (zero outside the image).
    x_blur: (N, S, H, W) -> (N, F, H, W).

    On a CUDA tensor this launches the sm_90a kernel (one launch per call,
    counted in `aggregate_forward.launches`); on a CPU tensor it computes the
    plain twin. Other devices raise.
    """
    _check(x_blur, w, mu1, mu2, None, ks)
    if x_blur.device.type == "cpu":
        return aggregate_forward_plain(x_blur, w, mu1, mu2, ks, use_interpolation)
    _check_cuda("aggregate_forward", x_blur, ks)

    n, s, h, wd = x_blur.shape
    f = w.shape[-1]
    kern, fk = _padded_kernel(w, mu1, mu2, ks, use_interpolation)
    out = torch.empty((n, f, h, wd), dtype=x_blur.dtype, device=x_blur.device)

    lib = _library("dau_aggregate")
    rt, cg, threads = _launch_plan(h, wd)
    smem = lib.dau_aggregate_smem_bytes(ks, _F_TILE, rt, cg)
    if smem > _MAX_SMEM:
        raise ValueError(f"plan needs {smem} bytes of shared memory (> {_MAX_SMEM})")
    with torch.cuda.device(x_blur.device):
        stream = torch.cuda.current_stream(x_blur.device).cuda_stream
        err = lib.dau_aggregate_launch(
            x_blur.data_ptr(), kern.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[x_blur.dtype], n, s, f, fk, h, wd, ks, _F_TILE, rt, cg,
            threads, smem, stream)
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
        lib.dau_forward_fused_launch.argtypes = (
            [c_ptr] * 4 + [c_int] * 13 + [c_ll, c_ptr])
        lib.dau_forward_fused_launch.restype = c_int
    else:
        lib.dau_aggregate_smem_bytes.argtypes = [c_int] * 4
        lib.dau_aggregate_smem_bytes.restype = c_ll
        lib.dau_aggregate_launch.argtypes = (
            [c_ptr] * 3 + [c_int] * 12 + [c_ll, c_ptr])
        lib.dau_aggregate_launch.restype = c_int
    return lib
