"""Port vs JAX: what the fused forward kernel K5 sums, on the CPU.

K5 runs only on the card, but its arithmetic is emulated here in float64
from the operands its wrapper builds (`fused_forward_operands`): the raw
input, chunk-major and stacked as K's channels (six copies of x for f32
x), blurred in f32 with the full kb x kb filter and zero outside the
image; each stacked channel of that plane rounded once to bf16 (bf16 x),
or replaced by the part of its three-way split (`split_bf16_3`) that its
place in the stack [x1, x1, x2, x1, x2, x3] asks for (f32 x), as the
kernel writes it lane by lane into its staged window; K4's K operand; and
the ks*ks shifted sums over the flat padded plane that K4's emulation
(`_aggregate_from_operands`) forms. That must equal the JAX
Pallas kernel `dau_forward_fused_pallas` (interpret mode) within 2e-5 *
max|reference| for f32 (six bf16 products keep each f32 product to about
2**-24) and 1e-2 * max|reference| for bf16 (the blurred plane rounded to
bf16 once here; JAX keeps it in f32 and rounds its output to bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dau_convnet_tpu.kernels import dau_forward_fused_pallas
from dau_convnet_tpu.ops.gaussian import gaussian_filters
from dau_convnet_tpu_torch.kernels import forward as tkf

from test_torch_aggregate_operands import _aggregate_from_operands

BOUNDS = {"float32": 2e-5, "bfloat16": 1e-2}
EDGE_MU = np.array([-3.99, 3.99, -3.0, 0.0, 1.0, 2.0, 3.0], np.float32)


PIECE = (0, 0, 1, 0, 1, 2)  # the split part at each place of the f32 stack


def _fused_from_operands(x_t, kern_t, filt, s, f, h, w, ks):
    """What K5 sums for its operands (S source channels, H x W planes), in
    float64: the masked f32 blur of every stacked channel, staged as the
    kernel stages it, then K4's sums."""
    cc, n = x_t.shape[:2]
    x = x_t.float().reshape(cc, n, h, w, 8).permute(1, 0, 4, 2, 3).reshape(n, cc * 8, h, w)
    kb = filt.shape[-1]
    # zero padding kb//2 and an output only inside the image: the mask
    xb = F.conv2d(x, filt.expand(cc * 8, 1, kb, kb), padding=kb // 2, groups=cc * 8)
    if x_t.dtype == torch.float32:
        parts = tkf.split_bf16_3(xb)
        staged = torch.stack([parts[PIECE[sc // s]][:, sc] if sc < 6 * s else xb[:, sc] * 0
                              for sc in range(cc * 8)], dim=1)
    else:
        staged = xb.to(torch.bfloat16)
    xb_t = tkf.chunk_major(staged.to(torch.bfloat16).permute(0, 2, 3, 1))
    return _aggregate_from_operands(xb_t, kern_t, f, h, w, ks)


def _params(rng, s, g, f, reach, mu_kind):
    w = rng.standard_normal((s, g, f)).astype(np.float32) * 0.1
    if mu_kind == "edges":
        mu1, mu2 = rng.choice(EDGE_MU, (2, s, g, f))
    else:
        mu1, mu2 = rng.uniform(-reach, reach, (2, s, g, f)).astype(np.float32)
    return w, mu1, mu2


# (N, S, G, F, H, W, ks, kb, blur, mu kind, use_interpolation, transposed):
# S and F ragged (not multiples of 8; S past one 8-channel chunk, so the f32
# stack straddles chunks), a plane wider than one 272-position tile, kb !=
# ks both ways, the mirrored "error" filter at a transposed (dx) shape with
# negated offsets, and mu at +-max_offset and at integers
CASES = {
    "s5_f7_9x11": (2, 5, 2, 7, 9, 11, 9, 9, "w", "random", True, False),
    "s13_f20_wide": (1, 13, 2, 20, 5, 70, 9, 9, "w", "random", True, False),
    "kb5_ks9": (1, 6, 2, 9, 8, 8, 9, 5, "w", "random", False, False),
    "kb9_ks5": (2, 11, 1, 5, 7, 9, 5, 9, "w", "random", True, False),
    "error_transposed": (1, 12, 2, 5, 9, 10, 9, 9, "error", "random", True, True),
    "edge_mu": (1, 9, 2, 6, 8, 9, 9, 9, "w", "edges", True, False),
}


def _case(name, dtype):
    n, s, g, f, h, w, ks, kb, blur, mu_kind, interp, transposed = CASES[name]
    rng = np.random.default_rng(len(name))
    reach = ks // 2 - 0.01
    wt, mu1, mu2 = _params(rng, s, g, f, reach, mu_kind)
    if transposed:  # the dx pass: F channels in, S out, offsets negated
        wt, mu1, mu2 = (a.transpose(2, 1, 0) for a in (wt, -mu1, -mu2))
    x = rng.random((n, wt.shape[0], h, w)).astype(np.float32)
    filt = np.asarray(gaussian_filters(jnp.float32(0.5), size=kb)[blur], np.float32)
    dt = getattr(torch, dtype)
    tensors = [torch.tensor(np.ascontiguousarray(a)).to(dt) for a in (x, wt, mu1, mu2)]
    return tensors, torch.tensor(filt), ks, interp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_operands_match_jax_kernel(name, dtype):
    (x, w, mu1, mu2), filt, ks, interp = _case(name, dtype)
    jdt = getattr(jnp, dtype)
    ref = jax.jit(lambda *a: dau_forward_fused_pallas(*a, jnp.asarray(filt.numpy()), ks, interp,
                                                      interpret=True))(
        *(jnp.asarray(t.float().numpy(), jdt) for t in (x, w, mu1, mu2)))
    x_t, kern_t, filt_t = tkf.fused_forward_operands(x, w, mu1, mu2, filt, ks, interp)
    assert filt_t.dtype == torch.float32 and kern_t.dtype == torch.bfloat16
    assert x_t.dtype == x.dtype and x_t.shape[0] * 8 == kern_t.shape[-1]
    n, s, h, wd = x.shape
    got = _fused_from_operands(x_t, kern_t, filt_t, s, w.shape[-1], h, wd, ks).numpy()
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape == (x.shape[0], w.shape[-1], *x.shape[2:])
    err = float(np.abs(got - ref).max())
    assert err <= BOUNDS[dtype] * float(np.abs(ref).max()), f"{name} {dtype}: max|err| {err}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_operands_are_k4s_k_and_the_stacked_raw_input(name, dtype):
    (x, w, mu1, mu2), filt, ks, interp = _case(name, dtype)
    x_t, kern_t, _ = tkf.fused_forward_operands(x, w, mu1, mu2, filt, ks, interp)
    _, kern4 = tkf.aggregate_forward_operands(x, w, mu1, mu2, ks, interp)
    assert kern_t.dtype == kern4.dtype and torch.equal(kern_t, kern4)
    copies = 6 if dtype == "float32" else 1
    assert torch.equal(x_t, tkf.chunk_major(torch.cat([x.permute(0, 2, 3, 1)] * copies, -1)))


def test_fused_emulation_matches_the_twin_on_a_27px_plane():
    # conv2's plane (27x27: four tiles of the flat plane), S past one
    # 64-channel group, f32: the emulation against the port's own twin
    rng = np.random.default_rng(11)
    w, mu1, mu2 = (torch.tensor(a) for a in _params(rng, 70, 2, 9, 3.99, "random"))
    x = torch.tensor(rng.random((1, 70, 27, 27)).astype(np.float32))
    filt = torch.tensor(np.asarray(gaussian_filters(jnp.float32(0.5), size=9)["w"]))
    x_t, kern_t, filt_t = tkf.fused_forward_operands(x, w, mu1, mu2, filt, 9)
    got = _fused_from_operands(x_t, kern_t, filt_t, 70, 9, 27, 27, 9)
    want = tkf.dau_forward_fused_plain(x, w, mu1, mu2, filt, 9).double()
    assert float((got - want).abs().max()) <= 2e-5 * float(want.abs().max())
