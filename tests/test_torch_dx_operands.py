"""Port vs JAX: the operands of K2's dx kernel, the spectral input-gradient
contraction on the tensor cores, on the CPU.

The dx kernel runs only on the card; what its operands are is plain torch
and runs here. `fused_bwd.dx_operands` builds, as K1's operand kernel does
beside K1's operands, the GEMM's B, the interleaved error copy (row 2f =
[Ere | Eim], row 2f+1 = [Eim | -Ere], 16 f per step, f32 split in three and
stacked per step), and each unit's compact tap record. `_dx_from_operands`
does in float64 what the kernel sums from them: per bin, each unit's phase
factor from the table quads and its two taps per axis, V = sum_g w * phiU
rounded to bf16 once (f32: split in three, stacked along K as [V1, V1, V2,
V1, V2, V3] against the error's [e1, e2, e1, e3, e2, e1]), and the product
A . B whose columns n < N hold dXre and N + n dXim. That must equal the JAX
Pallas kernel `fused_spectral_grads_call(esb=..., wg=...)` in interpret
mode, under either gather (the dx spectra are the same function), within
the card tests' bounds: 1e-4 * max|reference| for f32 (six products keep
each f32 product to about 2**-24; f32 sums in another order) and 1e-2 *
max|reference| for bf16 (V is rounded to bf16 once here, where the Pallas
kernel rounds each unit's w * phiU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dau_convnet_tpu.kernels.fused_bwd import fused_spectral_grads_call
from dau_convnet_tpu.ops import fourier_engine as jfe
from dau_convnet_tpu_torch.kernels import forward as tkf
from dau_convnet_tpu_torch.kernels import fused_bwd as tfb

BOUNDS = {"float32": 1e-4, "bfloat16": 1e-2}
EDGE_MU = np.array([-3.99, 3.99, -3.0, 0.0, 2.0, 3.0, -0.5, -2.25, -1.75, 1.5],
                   np.float32)
X_PARTS = (0, 0, 1, 0, 1, 2)  # A's part per stacked segment: [V1, V1, V2, V1, V2, V3]


def _inputs(seed, n, s, f, g, hw, m=3):
    """Numpy operands of the fused call with dx, as
    `fourier_unit_grads_fused2` makes them."""
    rng = np.random.default_rng(seed)
    p1, p2, rb = jfe.plan_bins(hw, hw, 9)
    b, span = p1 * rb, 5
    mu1 = rng.choice(EDGE_MU, (s, g, f))
    mu2 = rng.uniform(-3.99, 3.99, (s, g, f)).astype(np.float32)
    w2 = np.full(rb, 2.0)
    w2[0] = 1.0
    if p2 % 2 == 0:
        w2[-1] = 1.0
    t2 = jfe._phase_table_host(p2, rb, span) * (np.concatenate([w2, w2])[:, None] / (p1 * p2))
    ops = dict(
        xs=rng.standard_normal((b, m, 2 * n, s)), es=rng.standard_normal((b, 2 * n, f)),
        t1=jfe._phase_table_host(p1, p1, span), t2=t2,
        a1=np.transpose(np.asarray(jfe._phase_onehot(jnp.asarray(mu1), span, True)), (0, 2, 1, 3)),
        a2=np.transpose(np.asarray(jfe._phase_onehot(jnp.asarray(mu2), span, True)), (0, 2, 1, 3)),
        esb=rng.standard_normal((b, 2 * n, f)), wg=rng.standard_normal((g, s, f)) * 0.1)
    return {k: np.asarray(v, np.float32) for k, v in ops.items()}, dict(n_img=n, p1b=p1, rbb=rb)


def _port(ops, dtype):
    dt = getattr(torch, dtype)
    spectra = ("xs", "es", "esb", "wg")
    return {k: torch.tensor(v).to(dt if k in spectra else torch.float32) for k, v in ops.items()}


def _f32(bits):
    return bits.view(torch.float32).double()


def _unpack(rec, f32):
    """(j1, j2, a0, a1, b0, b1, w) of each unit from its record, (G, F, S)."""
    if f32:
        j = rec[0]
        return (j & 0xFFFF, (j >> 16) & 0xFFFF, *(_f32(p) for p in rec[1:]))
    hi = lambda v: _f32(v & -65536)  # noqa: E731 (the upper bf16 of a word)
    lo = lambda v: _f32(torch.bitwise_left_shift(v, 16))  # noqa: E731
    return ((rec[0] >> 16) & 0xFF, (rec[0] >> 24) & 0xFF, lo(rec[1]), hi(rec[1]),
            lo(rec[2]), hi(rec[2]), lo(rec[0]))


def _dx_from_operands(t, kw):
    """What the dx kernel sums, in float64, over the operands its operand
    kernel builds (`t`: the port's tensors in the spectra's dtype): dxs
    (B, 2N, S)."""
    cdt = t["xs"].dtype
    f32 = cdt == torch.float32
    n, p1, rb = kw["n_img"], kw["p1b"], kw["rbb"]
    b, n2, f = t["esb"].shape
    s = t["wg"].shape[1]
    eb_t, rec = tfb.dx_operands(t["esb"], t["wg"], t["a1"], t["a2"], n)
    j1, j2, a0, a1, b0, b1, w = _unpack(rec, f32)
    ty = tfb.spectral_table_quads(t["t1"].to(cdt).float(), p1).double()   # (P1, nj-1, 4)
    tx = tfb.spectral_table_quads(t["t2"].to(cdt).float(), rb).double()   # (rb, nj-1, 4)
    y, x = ty[:, j2.long()], tx[:, j1.long()]               # (P1 | rb, G, F, S, 4)
    pyre, pyim = y[..., 1] * b1 + y[..., 0] * b0, y[..., 3] * b1 + y[..., 2] * b0
    pxre, pxim = x[..., 1] * a1 + x[..., 0] * a0, x[..., 3] * a1 + x[..., 2] * a0
    vr = (w * (pyre[:, None] * pxre[None] - pyim[:, None] * pxim[None])).sum(2)
    vi = (w * (pyre[:, None] * pxim[None] + pyim[:, None] * pxre[None])).sum(2)
    v = torch.stack([vr, vi], dim=-1).reshape(b, f, s, 2).float()   # (B, F, S, re/im)
    parts = tkf.split_bf16_3(v) if f32 else (v.to(torch.bfloat16),)
    a = torch.stack([parts[p] for p in (X_PARTS if f32 else (0,))], dim=1).double()
    f16 = -(-f // 16) * 16
    a = torch.nn.functional.pad(a, (0, 0, 0, 0, 0, f16 - f))     # (B, segs, F16, S, 2)
    a = a.reshape(b, a.shape[1], f16 // 16, 16, s, 2).permute(0, 4, 2, 1, 3, 5)
    d = torch.bmm(a.reshape(b, s, -1), eb_t.double())            # (B, S, NC)
    return d[..., :n2].transpose(1, 2)


# (N, S, F, G, H=W): a ragged N (2N = 10 columns of the 64) and F off the
# 16-f step, G = 4, 13x13's 153 bins (JAX's interpret mode takes S and F in
# multiples of 8)
CASES = {
    "n2_g2_9px": (2, 8, 16, 2, 9),
    "ragged_n5_f24": (5, 24, 24, 2, 9),
    "g4_13px": (2, 8, 16, 4, 13),
}


@pytest.mark.parametrize("gather", ["phi", "factored"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_dx_operands_match_jax_kernel(name, dtype, gather):
    n, s, f, g, hw = CASES[name]
    ops, kw = _inputs(len(name) + len(gather), n, s, f, g, hw)
    spectra = ("xs", "es", "esb", "wg")
    jops = {k: jnp.asarray(v, dtype if k in spectra else "float32") for k, v in ops.items()}
    ref = jax.jit(lambda o: fused_spectral_grads_call(**o, **kw, interpret=True,
                                                      gather=gather))(jops)[1]
    ref = np.asarray(ref, np.float64)
    got = _dx_from_operands(_port(ops, dtype), kw).numpy()
    assert got.shape == ref.shape == (kw["p1b"] * kw["rbb"], 2 * n, s)
    err = float(np.abs(got - ref).max())
    assert err <= BOUNDS[dtype] * float(np.abs(ref).max()), f"{name} {dtype}: max|err| {err}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_interleaved_error_copy_holds_the_rows(dtype):
    n, f, b = 3, 21, 4
    rng = np.random.default_rng(21)
    dt = getattr(torch, dtype)
    esb = torch.tensor(rng.standard_normal((b, 2 * n, f)).astype(np.float32)).to(dt)
    wg = torch.zeros((1, 2, f), dtype=dt)
    a = torch.zeros((12, 1, 2, f))
    eb_t, _ = tfb.dx_operands(esb, wg, a, a, n)
    segs = 6 if dtype == "float32" else 1
    assert eb_t.dtype == torch.bfloat16 and eb_t.shape == (b, 2 * segs * 32, 8)
    e = eb_t.reshape(b, 2, segs, 16, 2, 8).double()      # (B, step, segment, f', h, column)
    assert not e[..., 2 * n:].any()                        # columns past 2N
    assert not e.reshape(b, 2, segs, 32, 8)[:, 1, :, 2 * (f - 16):].any()  # rows past F
    ere, eim = esb[:, :n].double(), esb[:, n:].double()
    # the segments' parts sum to the f32 value within the split's 2**-24
    got = e[:, :, (0, 1, 3) if segs == 6 else (0,)].sum(2)  # e1 + e2 + e3
    got = got.reshape(b, 32, 2, 8)[:, :f]                   # (B, f, h, column)
    tol = 1e-6 if dtype == "float32" else 0.0
    for h, want in ((0, torch.cat([ere, eim], 1)), (1, torch.cat([eim, -ere], 1))):
        assert float((got[:, :, h, :2 * n] - want.transpose(1, 2)).abs().max()) <= tol * 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tap_records_hold_the_units_taps_and_weights(dtype):
    n, s, f, g, hw = 2, 8, 16, 3, 9
    ops, kw = _inputs(31, n, s, f, g, hw)
    t = _port(ops, dtype)
    cdt = t["xs"].dtype
    _, rec = tfb.dx_operands(t["esb"], t["wg"], t["a1"], t["a2"], n)
    assert rec.dtype == torch.int32 and rec.shape == (6 if dtype == "float32" else 3, g, f, s)
    j1, j2, a0, a1, b0, b1, w = _unpack(rec, dtype == "float32")
    for (j, lo, hi), got in ((tfb._taps(t["a1"], cdt), (j1, a0, a1)),
                             (tfb._taps(t["a2"], cdt), (j2, b0, b1))):
        assert torch.equal(got[0].int(), j.transpose(1, 2))
        assert torch.equal(got[1], lo.double().transpose(1, 2))
        assert torch.equal(got[2], hi.double().transpose(1, 2))
    assert torch.equal(w, t["wg"].to(cdt).double().transpose(1, 2))
