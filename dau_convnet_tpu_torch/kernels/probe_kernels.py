"""The probes' kernels for Hopper, and their plain twins.

Counterparts of the Pallas kernels of `benchmarks/mosaic_probe.py` (P1-P7)
and `benchmarks/pallas_ladder.py::run_copy` (P8); P9, `run_dot`, is K7's
kernel (`spectral.partial_idft`). Each wrapper launches its hand-written
CUDA kernel on a CUDA tensor (counted in its `.launches`) and calls its
plain PyTorch twin `<name>_plain` on a CPU tensor; any other device raises.
There is no fallback: on a CUDA tensor the kernel runs or the call raises.

- `probe_gemm` (`csrc/dau_probe_gemm.cu`; P1, P2, P5, P6): out[z] =
  op(a[z]) @ b[z], bf16 operands, f32 sums and out, on the tensor cores
  (TMA + `wgmma`). op(a) is a, or its transpose with `trans_a` (A stored
  M-major: P2's T[a] is (K, M)). A 2-D operand is one matrix shared by
  every z. TMA reads rows whose byte stride is a multiple of 16, so
  `gemm_operand` pads rows of 153 or 81 bf16 values to a multiple of 8 (a
  copy, timed apart by the probes) and hands over the others as they are.
- `probe_gather` (`csrc/dau_probe_gather.cu`; P7): the one-hot tap
  gather out[m,s,g,f] = sum_p [tgt[s,g,f] == p] iw[s,g,f] tab[p,m,s,f].
  P7's Pallas body does not trace as written (`mosaic_probe.py:209`
  broadcasts a (1, S, G, 1, F) mask against an (M, S, 1, F) slab); the
  function it means is its own reference (:222-224), which this computes.
- `scale_colsum`, `add_one`, `copy_tiles` (`csrc/dau_probe_stream.cu`; P3,
  P4, P8): sum_i 2 x[i, :] through a scratch in device memory; x + 1 in
  bf16 split over `blocks` blocks; a copy in tiles of `ch` columns.
- `device_limits`: the dynamic shared memory a block can opt into, the L2
  size and the SM count (P3's question on the card).

Nothing here builds or loads a library at import.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import load_library

__all__ = ["probe_gemm", "probe_gemm_plain", "gemm_operand", "gemm_layout", "probe_gather",
           "probe_gather_plain", "scale_colsum", "scale_colsum_plain", "add_one",
           "add_one_plain", "copy_tiles", "copy_tiles_plain", "device_limits"]

_PARTS = 256  # scale_colsum's bands of rows summed apart, then in order


def _device_kind(name: str, t: torch.Tensor) -> str:
    """'cpu' or 'cuda' for the tensor's device; other devices raise."""
    if t.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name} has no kernel for device {t.device}")
    return t.device.type


def _same_device(name: str, *tensors):
    for t in tensors[1:]:
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors on {tensors[0].device} and {t.device}")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


# ------------------------------------------------------------ the probe GEMM


def probe_gemm_plain(a, b, trans_a: bool = False):
    """Plain PyTorch twin of the probe GEMM: op(a) @ b in f32 on the bf16
    values (the products are exact in f32; only the order of the sums
    differs from the kernel's)."""
    a = a.float()
    return torch.matmul(a.transpose(-1, -2) if trans_a else a, b.float())


def _gemm_dims(a, b, trans_a):
    """(batch, M, N, K) of op(a) @ b; raises on what the kernel does not take."""
    if a.dim() not in (2, 3) or b.dim() not in (2, 3):
        raise ValueError(f"a, b must be 2-D or 3-D, got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"a, b must be bfloat16, got {a.dtype}, {b.dtype}")
    m, k = (a.shape[-1], a.shape[-2]) if trans_a else (a.shape[-2], a.shape[-1])
    if b.shape[-2] != k:
        raise ValueError(f"op(a) is ({m}, {k}) but b has {b.shape[-2]} rows")
    za = a.shape[0] if a.dim() == 3 else 1
    zb = b.shape[0] if b.dim() == 3 else 1
    if za != zb and 1 not in (za, zb):
        raise ValueError(f"batches {za} and {zb} differ")
    if 0 in (m, k, b.shape[-1], za, zb):
        raise ValueError("empty operand")
    _same_device("probe_gemm", a, b)
    return max(za, zb), m, b.shape[-1], k


def _tma_ready(t: torch.Tensor) -> bool:
    """Whether TMA can read t as it lies: unit stride along the last dim,
    the other strides multiples of 8 values (16 bytes), rows no shorter
    than their width, 16-byte aligned."""
    strides = t.stride()
    # a batch dim of size 1 is never stepped over; the row stride always is
    outer_ok = all(s % 8 == 0 for d, s in enumerate(strides[:-1])
                   if t.shape[d] > 1 or d == t.dim() - 2)
    return (strides[-1] == 1 and outer_ok and strides[-2] >= t.shape[-1]
            and t.data_ptr() % 16 == 0)


def gemm_operand(t: torch.Tensor) -> torch.Tensor:
    """t itself where TMA can read it; else a copy whose rows are padded
    with zeros to a multiple of 8 values, returned as a view of t's shape
    (P1's D rows of 153 and P2's D rows of 81 values)."""
    if _tma_ready(t):
        return t
    width = t.shape[-1]
    padded = (F.pad(t, (0, -width % 8)) if width % 8
              else t.clone(memory_format=torch.contiguous_format))
    return padded[..., :width]


def gemm_layout(a, b, trans_a: bool = False):
    """What the kernel is handed: (a3, b3, (lda, a_bstride, ldb, b_bstride,
    batch, M, N, K)). a3, b3: the operands as 3-D tensors TMA can read
    (`gemm_operand`); the kernel reads A[z, m, k] at a3's first element +
    z*a_bstride + m*lda + k (with trans_a: + k*lda + m) and B[z, k, n] at
    b3's + z*b_bstride + k*ldb + n, in elements; a batch stride of 0 shares
    one matrix over every z."""
    batch, m, n, k = _gemm_dims(a, b, trans_a)
    a3, b3 = (gemm_operand(t if t.dim() == 3 else t.unsqueeze(0)) for t in (a, b))
    return a3, b3, (a3.stride(1), a3.stride(0) if a3.shape[0] > 1 else 0, b3.stride(1),
                    b3.stride(0) if b3.shape[0] > 1 else 0, batch, m, n, k)


def probe_gemm(a, b, trans_a: bool = False):
    """op(a) @ b in f32: (batch, M, N), or (M, N) where a and b are both
    2-D. a: bf16 (batch or 1, M, K), or (batch or 1, K, M) with trans_a; b:
    bf16 (batch or 1, K, N); a 2-D operand is shared by every batch. On a
    CUDA tensor this launches the sm_90a kernel once (counted in
    `probe_gemm.launches`), padding rows TMA cannot read (`gemm_operand`);
    on a CPU tensor it computes the plain twin. Other devices raise."""
    _gemm_dims(a, b, trans_a)
    if _device_kind("probe_gemm", a) == "cpu":
        return probe_gemm_plain(a, b, trans_a)
    a3, b3, (lda, a_bstride, ldb, b_bstride, batch, m, n, k) = gemm_layout(a, b, trans_a)
    out = torch.empty((batch, m, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _gemm_library().dau_probe_gemm_launch(
            a3.data_ptr(), int(trans_a), lda, a_bstride, b3.data_ptr(), ldb, b_bstride,
            out.data_ptr(), batch, m, n, k, _stream(a))
    _raise_on(err, "probe_gemm")
    probe_gemm.launches += 1
    return out if 3 in (a.dim(), b.dim()) else out[0]


probe_gemm.launches = 0


@functools.lru_cache(maxsize=None)
def _gemm_library() -> ctypes.CDLL:
    lib = load_library("dau_probe_gemm")
    c_int, c_ll, c_ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    lib.dau_probe_gemm_launch.argtypes = [c_ptr, c_int, c_ll, c_ll, c_ptr, c_ll, c_ll, c_ptr,
                                          c_int, c_int, c_int, c_int, c_ptr]
    lib.dau_probe_gemm_launch.restype = c_int
    return lib


# ---------------------------------------------------------------- the gather


def probe_gather_plain(tab, tgt, iw):
    """Plain PyTorch twin of the gather: for each (s, g, f) whose target is
    an integer p in [0, P), iw * tab[p, :, s, f]; 0 elsewhere."""
    p_count, _, s, f = tab.shape
    hit = (tgt >= 0) & (tgt < p_count) & (tgt == torch.floor(tgt))
    p = torch.where(hit, tgt, torch.zeros_like(tgt)).long()
    s_idx = torch.arange(s, device=tab.device)[:, None, None]
    f_idx = torch.arange(f, device=tab.device)[None, None, :]
    vals = tab[p, :, s_idx, f_idx].permute(3, 0, 1, 2)  # (S, G, F, M) -> (M, S, G, F)
    return torch.where(hit, iw * vals, torch.zeros((), dtype=vals.dtype, device=tab.device))


def probe_gather(tab, tgt, iw):
    """out[m, s, g, f] = sum_p [tgt[s, g, f] == p] * iw[s, g, f] * tab[p, m, s, f],
    (M, S, G, F) f32. tab: (P, M, S, F) f32; tgt, iw: (S, G, F) f32. On a
    CUDA tensor this launches the kernel once (counted in
    `probe_gather.launches`); on a CPU tensor it computes the plain twin.
    Other devices raise."""
    if tab.dim() != 4 or tgt.dim() != 3 or tgt.shape != iw.shape or (
            tgt.shape[0], tgt.shape[2]) != (tab.shape[2], tab.shape[3]):
        raise ValueError(f"tab must be (P, M, S, F) and tgt, iw (S, G, F), got "
                         f"{tuple(tab.shape)}, {tuple(tgt.shape)}, {tuple(iw.shape)}")
    if any(t.dtype != torch.float32 for t in (tab, tgt, iw)):
        raise TypeError("tab, tgt and iw must be float32")
    _same_device("probe_gather", tab, tgt, iw)
    if _device_kind("probe_gather", tab) == "cpu":
        return probe_gather_plain(tab, tgt, iw)
    p, m, s, f = tab.shape
    g = tgt.shape[1]
    tab, tgt, iw = tab.contiguous(), tgt.contiguous(), iw.contiguous()
    out = torch.empty((m, s, g, f), dtype=torch.float32, device=tab.device)
    with torch.cuda.device(tab.device):
        err = _gather_library().dau_probe_gather_launch(
            tab.data_ptr(), tgt.data_ptr(), iw.data_ptr(), out.data_ptr(), p, m, s, g, f,
            _stream(tab))
    _raise_on(err, "probe_gather")
    probe_gather.launches += 1
    return out


probe_gather.launches = 0


@functools.lru_cache(maxsize=None)
def _gather_library() -> ctypes.CDLL:
    lib = load_library("dau_probe_gather")
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    lib.dau_probe_gather_launch.argtypes = [c_ptr] * 4 + [c_int] * 5 + [c_ptr]
    lib.dau_probe_gather_launch.restype = c_int
    return lib


# ------------------------------------------------------------ the stream kernels


def scale_colsum_plain(x):
    """Plain PyTorch twin of P3: (1, cols) column sums of 2x."""
    return (2 * x).sum(dim=0, keepdim=True)


def scale_colsum(x):
    """(1, cols) f32: sum_i 2 * x[i, :], through a (rows, cols) scratch of 2x
    in device memory. x: (rows, cols) f32, cols a multiple of 4. On a CUDA
    tensor this runs the kernel's three launches (2x, per-band sums, their
    sum in order; counted once in `scale_colsum.launches`); on a CPU tensor
    it computes the plain twin. Other devices raise."""
    if x.dim() != 2 or x.shape[1] % 4 != 0 or 0 in x.shape:
        raise ValueError(f"x must be (rows, cols) with cols a multiple of 4, got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if _device_kind("scale_colsum", x) == "cpu":
        return scale_colsum_plain(x)
    rows, cols = x.shape
    parts = min(rows, _PARTS)
    x = x.contiguous()
    scratch = torch.empty_like(x)
    partial = torch.empty((parts, cols), dtype=torch.float32, device=x.device)
    out = torch.empty((1, cols), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _stream_library().dau_probe_scale_colsum_launch(
            x.data_ptr(), scratch.data_ptr(), partial.data_ptr(), out.data_ptr(), rows, cols,
            parts, _stream(x))
    _raise_on(err, "scale_colsum")
    scale_colsum.launches += 1
    return out


scale_colsum.launches = 0


def add_one_plain(x, out=None):
    """Plain PyTorch twin of P4: x + 1 in x's dtype (into out if given)."""
    y = x + 1
    return y if out is None else out.copy_(y)


def add_one(x, out=None, blocks: int | None = None):
    """x + 1 in bf16, into `out` if given (same shape, contiguous). x: bf16,
    contiguous, numel a multiple of 8. blocks: the launch's blocks, each
    the next contiguous share of x (default: one per 8,192 values). On a
    CUDA tensor this launches the kernel once (counted in
    `add_one.launches`); on a CPU tensor it computes the plain twin. Other
    devices raise."""
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.numel() % 8 or not x.numel():
        raise ValueError(f"x must be contiguous bf16 with a multiple of 8 values, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if out is not None:
        if out.shape != x.shape or out.dtype != x.dtype or not out.is_contiguous():
            raise ValueError("out must be a contiguous tensor of x's shape and dtype")
        _same_device("add_one", x, out)
    if _device_kind("add_one", x) == "cpu":
        return add_one_plain(x, out)
    out = torch.empty_like(x) if out is None else out
    blocks = max(1, -(-x.numel() // 8192)) if blocks is None else blocks
    with torch.cuda.device(x.device):
        err = _stream_library().dau_probe_add_one_launch(
            x.data_ptr(), out.data_ptr(), x.numel(), blocks, _stream(x))
    _raise_on(err, "add_one")
    add_one.launches += 1
    return out


add_one.launches = 0


def copy_tiles_plain(x, ch: int):
    """Plain PyTorch twin of P8: a copy of x."""
    return x.clone()


def copy_tiles(x, ch: int):
    """A copy of x: (rows, cols) bf16 contiguous, cols and ch multiples of 8,
    one block per tile of ch columns. On a CUDA tensor this launches the
    kernel once (counted in `copy_tiles.launches`); on a CPU tensor it
    computes the plain twin. Other devices raise."""
    if x.dim() != 2 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-D bf16 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.shape[1] % 8 or ch % 8 or ch <= 0 or 0 in x.shape:
        raise ValueError(f"cols ({x.shape[1]}) and ch ({ch}) must be positive multiples of 8")
    if _device_kind("copy_tiles", x) == "cpu":
        return copy_tiles_plain(x, ch)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _stream_library().dau_probe_copy_tiles_launch(
            x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], ch, _stream(x))
    _raise_on(err, "copy_tiles")
    copy_tiles.launches += 1
    return out


copy_tiles.launches = 0


def device_limits(device=None) -> dict:
    """The card's limits P3 asks about: `smem_optin` (bytes of dynamic
    shared memory one block can opt into), `l2_bytes`, `sms`."""
    vals = [ctypes.c_int() for _ in range(3)]
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        _raise_on(_stream_library().dau_probe_device_limits(*map(ctypes.byref, vals)),
                  "device_limits")
    return dict(zip(("smem_optin", "l2_bytes", "sms"), (v.value for v in vals)))


@functools.lru_cache(maxsize=None)
def _stream_library() -> ctypes.CDLL:
    lib = load_library("dau_probe_stream")
    c_int, c_ll, c_ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    lib.dau_probe_scale_colsum_launch.argtypes = [c_ptr] * 4 + [c_int] * 3 + [c_ptr]
    lib.dau_probe_add_one_launch.argtypes = [c_ptr, c_ptr, c_ll, c_int, c_ptr]
    lib.dau_probe_copy_tiles_launch.argtypes = [c_ptr, c_ptr, c_int, c_ll, c_int, c_ptr]
    lib.dau_probe_device_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    for fn in (lib.dau_probe_scale_colsum_launch, lib.dau_probe_add_one_launch,
               lib.dau_probe_copy_tiles_launch, lib.dau_probe_device_limits):
        fn.restype = c_int
    return lib
