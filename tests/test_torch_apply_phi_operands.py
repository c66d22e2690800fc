"""Port vs JAX: the operands of K3's products kernel, the fused apply-phi
on the tensor cores, on the CPU.

The products kernel runs only on the card; what its operands are is plain
torch and runs here. `fused_fwd.apply_phi_operands` builds, as K3's operand
kernel does, the GEMM's B, the interleaved copy of xs (row 2ci = [Xre |
Xim], row 2ci+1 = [-Xim | Xre], 16 ci per step, f32 split in three and
stacked per step), and each unit's compact tap record. `_y_from_operands`
does in float64 what the kernel sums from them: per bin, each unit's phase
factor from the table quads and its two taps per axis, rounded to the
operand dtype, the sum over the units rounded after every unit (K3's Phi;
f32: split in three, stacked along K as [P1, P1, P2, P1, P2, P3] against
xs's [x1, x2, x1, x3, x2, x1]), and the product A . B whose columns n < N
hold Yre and N + n Yim; `_closed` then splits Y's f32 sums in bf16 hi/lo
parts, as the closing launch does, and applies the partial iDFT.
That must equal the JAX Pallas kernel `fused_apply_phi_call` in interpret
mode, in both directions, within the card tests' bounds: 1e-4 *
max|reference| for f32 (six products keep each f32 product to about 2**-24,
the hi/lo parts Y to about 2**-17; f32 sums in another order) and 1e-2 *
max|reference| for bf16 (Phi is rounded to bf16 in both; a sum on the other
side of a rounding boundary moves one term by a bf16 ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dau_convnet_tpu.kernels.fused_fwd import fused_apply_phi_call
from dau_convnet_tpu.ops import fourier_engine as jfe
from dau_convnet_tpu_torch.kernels import forward as tkf
from dau_convnet_tpu_torch.kernels import fused_bwd as tfb
from dau_convnet_tpu_torch.kernels import fused_fwd as tff

BOUNDS = {"float32": 1e-4, "bfloat16": 1e-2}
X_PARTS = (0, 0, 1, 0, 1, 2)  # A's part per stacked segment: [P1, P1, P2, P1, P2, P3]


def _inputs(seed, n, s, g, f, hw, ks, contract_f):
    """Numpy operands of the fused call as `fourier_apply_phi_fused` makes
    them (contract_f: CI = F, CO = S, sin-negated tables); mu1 on quarter
    steps (integers and the clamp's edges among them), mu2 anywhere within
    the kernel size's reach."""
    rng = np.random.default_rng(seed)
    p1, p2, rb = jfe.plan_bins(hw, hw, ks)
    span = ks // 2 + 1
    lim = ks // 2 - 0.01
    mu1 = np.clip(np.round(rng.uniform(-lim, lim, (s, g, f)) * 4) / 4, -lim, lim)
    mu2 = rng.uniform(-lim, lim, (s, g, f))
    w = rng.standard_normal((s, g, f)) * 0.1
    t1 = jfe._phase_table_host(p1, p1, span)
    t2 = jfe._phase_table_host(p2, rb, span)
    if contract_f:
        t1[p1:], t2[rb:] = -t1[p1:], -t2[rb:]
    aw = np.asarray(jfe._phase_onehot(jnp.asarray(mu2, jnp.float32), span, True)) * w[None]
    a1 = np.asarray(jfe._phase_onehot(jnp.asarray(mu1, jnp.float32), span, True))
    order = (0, 2, 3, 1) if contract_f else (0, 2, 1, 3)
    dct, dst, _ = jfe._fused_idft_mats(p1, p2, rb, hw, hw)
    ops = dict(xs=rng.standard_normal((p1 * rb, 2 * n, f if contract_f else s)), t1=t1, t2=t2,
               aw=np.transpose(aw, order), a=np.transpose(a1, order), dct=dct, dst=dst)
    return {k: np.asarray(v, np.float32) for k, v in ops.items()}, dict(n_img=n, p1b=p1, rbb=rb)


def _port(ops, dtype):
    dt = getattr(torch, dtype)
    return {k: torch.tensor(v).to(dt if k in ("xs", "aw", "a") else torch.float32)
            for k, v in ops.items()}


def _f32(bits):
    return bits.view(torch.float32).double()


def _unpack(rec, f32):
    """(j1, j2, a0, a1, b0, b1) of each unit from its record, (G, CI, CO)."""
    if f32:
        j = rec[0]
        return (j & 0xFFFF, (j >> 16) & 0xFFFF, *(_f32(p) for p in rec[1:]))
    hi = lambda v: _f32(v & -65536)  # noqa: E731 (the upper bf16 of a word)
    lo = lambda v: _f32(torch.bitwise_left_shift(v, 16))  # noqa: E731
    return ((rec[0] >> 16) & 0xFF, (rec[0] >> 24) & 0xFF, lo(rec[1]), hi(rec[1]), lo(rec[2]),
            hi(rec[2]))


def _y_from_operands(t, kw):
    """What K3's products kernel sums, in float64, over the operands its
    operand kernel builds (`t`: the port's tensors): Y (B, 2N, CO), [Yre;
    Yim] rows."""
    cdt = t["xs"].dtype
    f32 = cdt == torch.float32
    n, p1, rb = kw["n_img"], kw["p1b"], kw["rbb"]
    b, n2, ci = t["xs"].shape
    g, co = t["aw"].shape[1], t["aw"].shape[3]
    b_t, rec = tff.apply_phi_operands(t["xs"], t["aw"], t["a"], n)
    j1, j2, a0, a1, b0, b1 = _unpack(rec, f32)
    ty = tfb.spectral_table_quads(t["t1"].to(cdt).float(), p1).double()   # (P1, nj-1, 4)
    tx = tfb.spectral_table_quads(t["t2"].to(cdt).float(), rb).double()   # (rb, nj-1, 4)
    y, x = ty[:, j2.long()], tx[:, j1.long()]               # (P1 | rb, G, CI, CO, 4)
    pyre, pyim = y[..., 1] * b1 + y[..., 0] * b0, y[..., 3] * b1 + y[..., 2] * b0
    pxre, pxim = x[..., 1] * a1 + x[..., 0] * a0, x[..., 3] * a1 + x[..., 2] * a0
    ure = pyre[:, None] * pxre[None] - pyim[:, None] * pxim[None]   # (P1, rb, G, CI, CO)
    uim = pyre[:, None] * pxim[None] + pyim[:, None] * pxre[None]

    def rnd(v):  # a value rounded to the operand dtype (through f32, as the kernel)
        return v if f32 else v.float().to(cdt).double()

    phr = phm = 0.0
    for gi in range(g):  # each unit's product and each partial sum rounded
        phr = rnd(phr + rnd(ure[:, :, gi]))
        phm = rnd(phm + rnd(uim[:, :, gi]))
    phi = torch.stack([phr, phm], dim=-1).reshape(b, ci, co, 2).float()   # (B, CI, CO, re/im)
    parts = tkf.split_bf16_3(phi) if f32 else (phi.to(torch.bfloat16),)
    a = torch.stack([parts[p] for p in (X_PARTS if f32 else (0,))], dim=1).double()
    c16 = -(-ci // 16) * 16
    a = torch.nn.functional.pad(a, (0, 0, 0, 0, 0, c16 - ci))     # (B, segs, CI16, CO, 2)
    a = a.reshape(b, a.shape[1], c16 // 16, 16, co, 2).permute(0, 4, 2, 1, 3, 5)
    d = torch.bmm(a.reshape(b, co, -1), b_t.double())             # (B, CO, NC)
    return d[..., :n2].transpose(1, 2)


def _closed(y, t, kw):
    """The closing launch in float64: Y's f32 sums as the bf16 hi/lo parts
    it multiplies, against the iDFT matrices rounded to xs's dtype: (HWp, N,
    CO)."""
    cdt = t["xs"].dtype
    n = kw["n_img"]
    b, _, co = y.shape
    hi, lo = tkf.split_bf16(y.float())
    yv = hi.double() + lo.double()
    out = (t["dct"].to(cdt).double() @ yv[:, :n].reshape(b, -1)
           - t["dst"].to(cdt).double() @ yv[:, n:].reshape(b, -1))
    return out.reshape(-1, n, co)


# (N, S, G, F, H=W, ks): N = 33 (2N = 66 columns, past one 64-column tile)
# with CI and CO off the 16-ci step and the 64-co tile in both directions,
# G = 1 and 3, and the ks-65 tier (nj = 68) on a 5x5 plane (JAX's interpret
# mode takes CI and CO in multiples of 8)
CASES = {
    "n33_ragged_g1": (33, 24, 1, 40, 9, 9),
    "g3_9px": (2, 16, 3, 8, 9, 9),
    "ks65_5px": (1, 8, 2, 8, 5, 65),
}


@pytest.mark.parametrize("contract_f", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_apply_phi_operands_match_jax_kernel(name, dtype, contract_f):
    n, s, g, f, hw, ks = CASES[name]
    ops, kw = _inputs(len(name) + 2 * contract_f, n, s, g, f, hw, ks, contract_f)
    jops = {k: jnp.asarray(v, dtype if k in ("xs", "aw", "a") else "float32")
            for k, v in ops.items()}
    ref = jax.jit(lambda o: fused_apply_phi_call(**o, **kw, interpret=True))(jops)
    ref = np.asarray(ref, np.float64)
    t = _port(ops, dtype)
    got = _closed(_y_from_operands(t, kw), t, kw).numpy()
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= BOUNDS[dtype] * float(np.abs(ref).max()), f"{name} {dtype}: max|err| {err}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_interleaved_xs_copy_holds_the_rows(dtype):
    n, ci, b = 3, 21, 4
    rng = np.random.default_rng(22)
    dt = getattr(torch, dtype)
    xs = torch.tensor(rng.standard_normal((b, 2 * n, ci)).astype(np.float32)).to(dt)
    a = torch.zeros((12, 1, ci, 2))
    b_t, _ = tff.apply_phi_operands(xs, a, a, n)
    segs = 6 if dtype == "float32" else 1
    assert b_t.dtype == torch.bfloat16 and b_t.shape == (b, 2 * segs * 32, 8)
    e = b_t.reshape(b, 2, segs, 16, 2, 8).double()        # (B, step, segment, ci', h, column)
    assert not e[..., 2 * n:].any()                        # columns past 2N
    assert not e.reshape(b, 2, segs, 32, 8)[:, 1, :, 2 * (ci - 16):].any()  # rows past CI
    # the parts of each segment sum to the rows: [x1, x2, x1, x3, x2, x1]
    rows = e[..., :2 * n].permute(0, 2, 1, 3, 4, 5).reshape(b, segs, 32, 2, 2 * n)[:, :, :ci]
    whole = rows[:, 0] + (rows[:, 1] + rows[:, 3] if segs == 6 else 0)
    xre, xim = xs[:, :n].double().transpose(1, 2), xs[:, n:].double().transpose(1, 2)
    want = torch.stack([torch.cat([xre, xim], -1), torch.cat([-xim, xre], -1)], dim=2)
    tol = 2.0 ** -20 if dtype == "float32" else 0.0
    assert float((whole - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nj", [12, 68, 200])
def test_records_hold_the_taps(nj, dtype):
    # j up to nj - 2 in the records, past 127 too (the bf16 record keeps j
    # in 8 bits, the top one of a signed word); weights rounded to dtype
    rng = np.random.default_rng(nj)
    g, ci, co = 2, 5, 7
    dt = getattr(torch, dtype)

    def onehot():
        j = rng.integers(0, nj - 1, (g, ci, co))
        frac = rng.random((g, ci, co)) * rng.standard_normal((g, ci, co))
        hot = np.zeros((nj, g, ci, co), np.float32)
        np.put_along_axis(hot, j[None], (1 - frac)[None], 0)
        np.put_along_axis(hot, j[None] + 1, frac[None], 0)
        return torch.tensor(hot)

    aw, a = onehot(), onehot()
    xs = torch.zeros((2, 2, ci), dtype=dt)
    _, rec = tff.apply_phi_operands(xs, aw.permute(0, 1, 3, 2).contiguous().permute(0, 1, 3, 2),
                                    a, 1)
    assert rec.dtype == torch.int32 and rec.shape == (5 if dtype == "float32" else 3, g, ci, co)
    got = _unpack(rec, dtype == "float32")
    want = (*tfb._taps(a, dt), *tfb._taps(aw, dt))
    for x, y in zip(got, (want[0], want[3], want[1], want[2], want[4], want[5])):
        assert torch.equal(x.double(), y.double())
    assert int(got[1].max()) > 127 or nj < 130


def test_plan_takes_up_to_256_exponents():
    for dtype in (torch.float32, torch.bfloat16):
        plans = [tff.apply_phi_plan(nj=nj, dtype=dtype) for nj in (2, 12, 68, 72, 256)]
        assert all(p is not None and p["smem"] <= 227 * 1024 for p in plans)
        assert tff.apply_phi_plan(nj=257, dtype=dtype) is None
        assert tff.apply_phi_plan(nj=1, dtype=dtype) is None
    # the dx kernel's gate (K1's operand kernel) keeps its own 64
    assert tfb.spectral_plan(m=3, g=2, nj=68, p1b=17, rbb=9) is None

