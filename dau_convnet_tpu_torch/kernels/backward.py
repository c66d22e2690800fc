"""DAU backward kernel for Hopper, the grad-table kernel (K6), and its plain twin.

Counterpart of `dau_convnet_tpu/kernels/backward.py::grad_tables_pallas`.
`grad_tables` launches the hand-written CUDA kernel `csrc/dau_grad_tables.cu`
on a CUDA tensor and calls the plain PyTorch twin `grad_tables_plain` on a
CPU tensor. There is no fallback: on a CUDA tensor the kernel runs or the
call raises.

Both compute, in f32 (bf16 input is widened),

    table[m,s,f,ky,kx] = sum_n sum_{i,j} xb[m,n,s,i+ky-c,j+kx-c] * err[n,f,i,j]

with xb zero outside the image, and return the (M, S, F, ks, ks) table in
f32, the contract of `ops.xla_engine.grad_tables`. The op reads the unit
gradients out of it with `xla_engine.tap_gather`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import xla_engine
from ._build import load_library
from .forward import _DTYPE_CODE, _KERNEL_SIZES, _MAX_SMEM

__all__ = ["grad_tables", "grad_tables_plain"]

_ROWS_PER_STAGE = 13  # err rows staged per pass, at most


def grad_tables_plain(x_blur_k, err, ks: int):
    """Plain PyTorch twin: `xla_engine.grad_tables` on the inputs widened to
    f32. x_blur_k: (M, N, S, H, W); err: (N, F, H, W). Returns (M, S, F, ks,
    ks) f32."""
    return xla_engine.grad_tables(x_blur_k.float(), err.float(), ks)


def _check(x_blur_k, err, ks):
    if x_blur_k.dim() != 5 or err.dim() != 4:
        raise ValueError(f"expected xb (M, N, S, H, W) and err (N, F, H, W), got "
                         f"{tuple(x_blur_k.shape)} and {tuple(err.shape)}")
    m, n, s, h, w = x_blur_k.shape
    if err.shape[0] != n or err.shape[2:] != (h, w):
        raise ValueError(f"err {tuple(err.shape)} does not match xb {tuple(x_blur_k.shape)}")
    for name, t in (("xb", x_blur_k), ("err", err)):
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if err.dtype != x_blur_k.dtype:
        raise TypeError(f"err is {err.dtype}, xb is {x_blur_k.dtype}")
    if err.device != x_blur_k.device:
        raise ValueError(f"err is on {err.device}, xb on {x_blur_k.device}")
    if ks % 2 != 1:
        raise ValueError(f"ks must be odd, got {ks}")


def _rows_per_stage(h: int) -> int:
    """Err rows per stage: the fewest equal stages of at most
    `_ROWS_PER_STAGE` rows (27 rows -> 3 stages of 9)."""
    stages = -(-h // _ROWS_PER_STAGE)
    return -(-h // stages)


def grad_tables(x_blur_k, err, ks: int):
    """Position table of the parameter gradients. x_blur_k: (M, N, S, H, W)
    with its rows contiguous (any strides over m, n, s); err: (N, F, H, W).
    Returns (M, S, F, ks, ks) f32.

    On a CUDA tensor this launches the sm_90a kernel (one launch per call,
    counted in `grad_tables.launches`); on a CPU tensor it computes the
    plain twin. Other devices raise.
    """
    _check(x_blur_k, err, ks)
    if x_blur_k.device.type == "cpu":
        return grad_tables_plain(x_blur_k, err, ks)
    if x_blur_k.device.type != "cuda":
        raise RuntimeError(f"grad_tables has no kernel for device {x_blur_k.device}")
    if ks not in _KERNEL_SIZES:
        raise ValueError(f"ks={ks} has no kernel instance (built: {_KERNEL_SIZES})")
    m, n, s, h, w = x_blur_k.shape
    if x_blur_k.stride(4) != 1 or x_blur_k.stride(3) != w:
        raise ValueError("xb must have contiguous rows (strides W, 1 over H, W)")
    f = err.shape[1]
    err_t = err.permute(0, 2, 3, 1).contiguous()  # (N, H, W, F): f fastest
    table = torch.empty((m * s, f, ks, ks), dtype=torch.float32, device=err.device)

    lib = _library()
    rt = _rows_per_stage(h)
    smem = lib.dau_grad_tables_smem_bytes(ks, rt, w)
    if smem > _MAX_SMEM:
        raise ValueError(f"plan needs {smem} bytes of shared memory (> {_MAX_SMEM})")
    sm, sn, ss = x_blur_k.stride(0), x_blur_k.stride(1), x_blur_k.stride(2)
    with torch.cuda.device(err.device):
        stream = torch.cuda.current_stream(err.device).cuda_stream
        code = lib.dau_grad_tables_launch(
            x_blur_k.data_ptr(), err_t.data_ptr(), table.data_ptr(),
            _DTYPE_CODE[err.dtype], m, n, s, f, h, w, sm, sn, ss, ks, rt, smem, stream)
    if code != 0:
        raise RuntimeError(f"grad_tables launch failed: cudaError {code}")
    grad_tables.launches += 1
    return table.reshape(m, s, f, ks, ks)


grad_tables.launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with every C signature declared."""
    lib = load_library("dau_grad_tables")
    c_int, c_ptr, c_ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    lib.dau_grad_tables_smem_bytes.argtypes = [c_int] * 3
    lib.dau_grad_tables_smem_bytes.restype = c_ll
    lib.dau_grad_tables_launch.argtypes = (
        [c_ptr] * 3 + [c_int] * 7 + [c_ll] * 3 + [c_int] * 2 + [c_ll, c_ptr])
    lib.dau_grad_tables_launch.restype = c_int
    return lib
