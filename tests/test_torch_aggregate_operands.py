"""Port vs JAX: the operands the tensor-core aggregation kernel K4 is handed,
on the CPU.

K4 runs only on the card, but what its wrapper prepares is plain torch and
runs here: `aggregate_forward_operands` synthesizes K and lays it out as
(ks*ks, F, S8) bf16, and lays xb out chunk-major, f32 input split into
three bf16 parts whose six products are stacked along the channels. The kernel reads each tap
(ky, kx) as the flat padded plane (row stride Wp = W + ks - 1) shifted by
ky*Wp + kx pixels; `_aggregate_from_operands` does the same in float64 (the
tensor cores sum exact bf16 products) and crops the dead columns. That must
equal the JAX Pallas kernel `aggregate_forward_pallas` (interpret mode)
within 2e-5 * max|reference| (the file's rule for the tensor-core
operands): f32 input keeps each product to about 2**-24; bf16 input gives
exact products summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dau_convnet_tpu.kernels.forward import aggregate_forward_pallas
from dau_convnet_tpu_torch.kernels import forward as tkf

BOUND = 2e-5


def _aggregate_from_operands(xb_t, kern_t, f, h, w, ks):
    """What the kernel sums over the prepared operands, in float64: per tap
    p = (ky, kx), K_p (F x S8) against the chunk-major plane read as the
    flat zero-padded plane shifted by ky*Wp + kx; (N, F, H, W)."""
    cc, n = xb_t.shape[:2]
    s8 = cc * 8
    x = xb_t.double().reshape(cc, n, h, w, 8).permute(1, 0, 4, 2, 3).reshape(n, s8, h, w)
    c, wp = ks // 2, w + ks - 1
    flat = F.pad(x, (c, c, c, c + 1)).reshape(n, s8, -1)  # one more zero row: the last tap
    length = h * wp
    kern = kern_t.double()[:, :f]
    y = sum(torch.einsum("fs,nsq->nfq", kern[ky * ks + kx],
                         flat[:, :, ky * wp + kx:ky * wp + kx + length])
            for ky in range(ks) for kx in range(ks))
    return y.reshape(n, f, h, wp)[..., :w]


def _inputs(shape, dtype, seed=0):
    n, s, g, f, h, ks, _ = shape
    rng = np.random.default_rng(seed)
    bound = ks // 2 - 0.01
    arrays = [rng.random((n, s, h, h)), rng.standard_normal((s, g, f)) * 0.1,
              *rng.uniform(-bound, bound, (2, s, g, f))]
    return [torch.tensor(a.astype(np.float32)).to(getattr(torch, dtype)) for a in arrays]


# (N, S, G, F, H=W, ks, use_interpolation): S and F ragged (not multiples of
# 8) or F above the 64-channel tile, 6x6 and 13x13 planes, ks 3 and 9
AGG_SHAPES = {
    "s5_f7_6px_ks3": (2, 5, 2, 7, 6, 3, True),
    "s16_f96_13px_ks9": (1, 16, 2, 96, 13, 9, True),
    "s5_f7_13px_ks9_nointerp": (2, 5, 2, 7, 13, 9, False),
    "s16_f96_6px_ks3_nointerp": (1, 16, 1, 96, 6, 3, False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(AGG_SHAPES))
def test_aggregate_operands_match_jax_kernel(name, dtype):
    n, s, g, f, h, ks, interp = AGG_SHAPES[name]
    x, w, mu1, mu2 = _inputs(AGG_SHAPES[name], dtype)
    jdt = getattr(jnp, dtype)
    # the JAX kernel widens bf16 x_blur to f32 and rounds its f32 sums to
    # x_blur's dtype at the end; handed the same bf16 values as f32 (and w,
    # mu1, mu2 in bf16, so K is synthesized in bf16) it returns those sums
    ref = jax.jit(lambda *a: aggregate_forward_pallas(*a, ks, interp, interpret=True))(
        jnp.asarray(x.float().numpy()), *(jnp.asarray(t.float().numpy(), jdt)
                                          for t in (w, mu1, mu2)))
    xb_t, kern_t = tkf.aggregate_forward_operands(x, w, mu1, mu2, ks, interp)
    s_stacked = 6 * s if dtype == "float32" else s
    s8 = -(-s_stacked // 8) * 8
    assert xb_t.dtype == kern_t.dtype == torch.bfloat16
    assert xb_t.shape == (s8 // 8, n, h, h * 8) and kern_t.shape == (ks * ks, f, s8)
    assert kern_t.is_contiguous() and xb_t.is_contiguous()
    got = _aggregate_from_operands(xb_t, kern_t, f, h, h, ks).numpy()
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape == (n, f, h, h)
    err = float(np.abs(got - ref).max())
    assert err <= BOUND * float(np.abs(ref).max()), f"{name} {dtype}: max|err| {err}"


def test_aggregate_operands_stack_the_f32_split_along_s():
    x, w, mu1, mu2 = _inputs((2, 5, 2, 7, 6, 3, True), "float32")
    xb_t, kern_t = tkf.aggregate_forward_operands(x, w, mu1, mu2, 3)
    x1, x2, x3 = tkf.split_bf16_3(x.permute(0, 2, 3, 1))
    assert torch.equal(xb_t, tkf.chunk_major(torch.cat([x1, x1, x2, x1, x2, x3], dim=-1)))
    kern = tkf.xla_engine.synthesize_kernel(w, mu1, mu2, 3)  # (S, F, ks, ks)
    k1, k2, k3 = tkf.split_bf16_3(kern.permute(2, 3, 1, 0).reshape(9, 7, 5))
    assert kern_t.shape == (9, 7, 32)  # 6 * 5 = 30 stacked channels, padded to 32
    assert torch.equal(kern_t[..., :30], torch.cat([k1, k2, k1, k3, k2, k1], dim=-1))
    assert not kern_t[..., 30:].any()
    # bf16 input: no split, K rounded to bf16 (exact: w is bf16 too)
    b16 = [t.bfloat16() for t in (x, w, mu1, mu2)]
    xb16, kern16 = tkf.aggregate_forward_operands(*b16, 3)
    assert xb16.shape == (1, 2, 6, 48) and kern16.shape == (9, 7, 8)
    kern_b = tkf.xla_engine.synthesize_kernel(*b16[1:], 3)
    assert torch.equal(kern16[..., :5], kern_b.permute(2, 3, 1, 0).reshape(9, 7, 5))


# (S, G, F, ks, use_interpolation, offset reach): G = 3 and 4, offsets
# past the kernel's reach (their taps are dropped), interpolation off, and
# ks 19, whose positions past 256 bf16 offsets round
SYNTH_CASES = {"ks3": (5, 2, 7, 3, True, 1.7), "g3_ks9": (16, 3, 9, 9, True, 4.7),
               "nointerp": (7, 2, 5, 9, False, 4.7), "g4_ks5": (6, 4, 3, 5, True, 2.0),
               "ks19": (3, 2, 4, 19, True, 8.99)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(SYNTH_CASES))
def test_synthesize_kernel_pfs_is_synthesize_kernel_bit_for_bit(name, dtype):
    s, g, f, ks, interp, reach = SYNTH_CASES[name]
    rng = np.random.default_rng(len(name))
    dt = getattr(torch, dtype)
    w = torch.tensor(rng.standard_normal((s, g, f)).astype(np.float32)).to(dt)
    mu1, mu2 = (torch.tensor(a.astype(np.float32)).to(dt)
                for a in rng.uniform(-reach, reach, (2, s, g, f)))
    mu1[0, :, 0], mu2[0, :, 0] = 1.0, -1.0  # integer offsets: a tap of weight 0
    want = tkf.xla_engine.synthesize_kernel(w, mu1, mu2, ks, interp)
    got = tkf.synthesize_kernel_pfs(w, mu1, mu2, ks, interp, s_out=s + 3)
    assert got.dtype == dt and got.shape == (ks * ks, f, s + 3) and got.is_contiguous()
    assert torch.equal(got[..., :s], want.permute(2, 3, 1, 0).reshape(ks * ks, f, s))
    assert not got[..., s:].any()


@pytest.mark.parametrize("scale", [1e-3, 1.0, 3e4])
def test_split_bf16_3_keeps_twenty_four_bits(scale):
    rng = np.random.default_rng(7)
    t = torch.tensor(rng.standard_normal(4096).astype(np.float32) * scale)
    parts = tkf.split_bf16_3(t)
    assert all(p.dtype == torch.bfloat16 for p in parts)
    assert torch.equal(parts[0], t.bfloat16())
    rest = (t.double() - sum(p.double() for p in parts)).abs()
    assert bool((rest <= 2.0 ** -24 * t.double().abs()).all())


def test_aggregate_operands_emulation_matches_the_twin():
    # a shape the JAX cases leave out: a wide plane (Wp > 64 pixels), S
    # above one 64-channel group of the kernel, ks 5
    n, s, g, f, h, ks = 1, 70, 2, 9, 5, 5
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.random((n, s, h, 67)).astype(np.float32)).bfloat16()
    w = torch.tensor(rng.standard_normal((s, g, f)).astype(np.float32) * 0.1).bfloat16()
    mu1, mu2 = (torch.tensor(a.astype(np.float32)).bfloat16()
                for a in rng.uniform(-1.99, 1.99, (2, s, g, f)))
    xb_t, kern_t = tkf.aggregate_forward_operands(x, w, mu1, mu2, ks)
    got = _aggregate_from_operands(xb_t, kern_t, f, h, 67, ks)
    want = tkf.aggregate_forward_plain(x.float(), w, mu1, mu2, ks).double()
    assert float((got - want).abs().max()) <= BOUND * float(want.abs().max())
