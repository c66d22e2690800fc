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

The kernel multiplies bf16 operands on the tensor cores with f32 sums and
writes the table position-major, (ks*ks, F, M*S); `grad_tables` returns the
(M, S, F, ks, ks) view of it. `grad_tables_operands` prepares the operands
in torch: channels last, chunk-major (see `chunk_major`), and f32 input
split in three bf16 parts (`split_bf16_3`) whose six products of orders up
to 3 the same bf16 products sum over a batch of 6N images, each f32
product held to about 2**-24. The kernel folds its wgmma sums, which round
toward zero, into sums rounded to nearest every `FOLD_F32` stages for f32
input and every `FOLD_BF16` for bf16. (Two parts, three products
and one wgmma chain per tap moved the f32 gradients of a conv before a
train-mode BatchNorm, whose sums cancel, by up to 2.7e-3 of max|grad| from
the f32 twin's.)
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import xla_engine
from ._build import load_library
from .forward import _DTYPE_CODE, _TMA_BOX_MAX, chunk_major, split_bf16_3

__all__ = ["grad_tables", "grad_tables_plain", "grad_tables_operands", "chunk_major",
           "table_view", "check_kernel_limits"]

# the kernel's own limits (csrc/dau_grad_tables.cu): a block takes TAPS
# kernel columns of one kernel row, so the grid is ks * ceil(ks / TAPS) deep;
# its TMA boxes (chunk_map) are (KC + TAPS - 1) * 8 bf16 columns wide
_TAPS = 3
_KC = 16
_GRID_Z_MAX = 65535
_TMA_COORD_MAX = 2 ** 31
_TMA_DIM_MAX = 2 ** 32
_TMA_STRIDE_MAX = 2 ** 40
# stages of R = 4 image rows (4 k16 steps a tap) per wgmma chain for f32
# and for bf16 input, as csrc/dau_grad_tables.cu sets them: the chain's f32
# sums round toward zero, so the kernel folds them into sums rounded to
# nearest this often. Kept here for the CPU emulation of the fold
# (tests/test_torch_gemm_operands.py), which also reads them from the source
FOLD_F32 = 4
FOLD_BF16 = 32


def check_kernel_limits(ks: int, n: int, h: int, w: int) -> None:
    """Raise ValueError, naming the limit, where the K6 kernel cannot take
    kernel size ks on N images of H x W: ks odd and >= 1, the grid's depth
    ks * ceil(ks / 3) <= 65535, and every TMA coordinate, dimension, stride
    and box of its chunk-major maps within the hardware's ranges."""
    if ks < 1 or ks % 2 != 1:
        raise ValueError(f"ks must be odd and >= 1, got {ks}")
    depth = ks * -(-ks // _TAPS)
    if depth > _GRID_Z_MAX:
        raise ValueError(f"ks={ks}: the grid's z extent ks*ceil(ks/{_TAPS}) = {depth} exceeds "
                         f"{_GRID_Z_MAX}")
    box = (_KC + _TAPS - 1) * 8
    if box > _TMA_BOX_MAX:
        raise ValueError(f"the TMA box of {box} columns exceeds {_TMA_BOX_MAX}")
    # the column coordinate runs from -(ks // 2) * 8 to (W + TAPS) * 8
    if 8 * (w + ks + _KC) >= _TMA_COORD_MAX:
        raise ValueError(f"ks={ks}, W={w}: a TMA column coordinate exceeds the int32 range")
    if 8 * w >= _TMA_DIM_MAX or 16 * n * h * w >= _TMA_STRIDE_MAX:
        raise ValueError(f"N={n}, H={h}, W={w}: a TMA dimension or stride exceeds its range")


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


def grad_tables_operands(x_blur_k, err):
    """The kernel's operands: (err_t, xb_t), chunk-major bf16 copies of err
    as (N, H, W, F) and of xb as (N, H, W, M*S) with ms = m*S + s. f32
    input is split in three (`split_bf16_3`) and concatenated along N, xb
    as [x1, x1, x2, x1, x2, x3] against err as [e1, e2, e1, e3, e2, e1]."""
    m, n, s, h, w = x_blur_k.shape
    x = x_blur_k.permute(1, 3, 4, 0, 2).reshape(n, h, w, m * s)
    e = err.permute(0, 2, 3, 1)
    if x.dtype == torch.float32:
        x1, x2, x3 = split_bf16_3(x)
        e1, e2, e3 = split_bf16_3(e)
        x, e = torch.cat([x1, x1, x2, x1, x2, x3]), torch.cat([e1, e2, e1, e3, e2, e1])
    return chunk_major(e.to(torch.bfloat16)), chunk_major(x.to(torch.bfloat16))


def table_view(table, m: int, s: int, ks: int):
    """The (M, S, F, ks, ks) view of a position-major (ks*ks, F, M*S) table."""
    f = table.shape[1]
    return table.reshape(ks, ks, f, m, s).permute(3, 4, 2, 0, 1)


def grad_tables(x_blur_k, err, ks: int):
    """Position table of the parameter gradients. x_blur_k: (M, N, S, H, W)
    (any strides); err: (N, F, H, W). Returns (M, S, F, ks, ks) f32: on the
    card, the view of the position-major table the kernel writes.

    On a CUDA tensor this launches the sm_90a kernel (one launch per call,
    counted in `grad_tables.launches`); on a CPU tensor it computes the
    plain twin. Other devices raise.
    """
    _check(x_blur_k, err, ks)
    if x_blur_k.device.type == "cpu":
        return grad_tables_plain(x_blur_k, err, ks)
    if x_blur_k.device.type != "cuda":
        raise RuntimeError(f"grad_tables has no kernel for device {x_blur_k.device}")
    m, n, s, h, w = x_blur_k.shape
    check_kernel_limits(ks, 6 * n if x_blur_k.dtype == torch.float32 else n, h, w)
    f = err.shape[1]
    err_t, xb_t = grad_tables_operands(x_blur_k, err)
    table = torch.empty((ks * ks, f, m * s), dtype=torch.float32, device=err.device)
    with torch.cuda.device(err.device):
        stream = torch.cuda.current_stream(err.device).cuda_stream
        code = _library().dau_grad_tables_launch(
            err_t.data_ptr(), xb_t.data_ptr(), table.data_ptr(), f, m * s, err_t.shape[1], h,
            w, ks, _DTYPE_CODE[x_blur_k.dtype], stream)
    if code != 0:
        raise RuntimeError(f"grad_tables launch failed: cudaError {code}")
    grad_tables.launches += 1
    return table_view(table, m, s, ks)


grad_tables.launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with every C signature declared."""
    lib = load_library("dau_grad_tables")
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    lib.dau_grad_tables_launch.argtypes = [c_ptr] * 3 + [c_int] * 7 + [c_ptr]
    lib.dau_grad_tables_launch.restype = c_int
    return lib
