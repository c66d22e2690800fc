"""Port vs JAX: the operands the tensor-core spectral-gradient kernel K1 is
handed, on the CPU.

K1 runs only on the card, but what its wrapper prepares is plain torch and
runs here: `spectral_operands` hands the kernel xs as an (B, M, K, S8) bf16
operand and es interleaved, ES (B, K, 2F) with column 2f = [Ere; Eim] and
2f+1 = [-Eim; Ere], chunk-major; f32 spectra are split in three bf16 parts
stacked along K = 12N (the six products of K4). `spectral_table_quads` packs
the phase tables, `bin_ranges` cuts the bins. `_grads_from_operands` does
in float64 what the kernel sums: per bin, T = X^T . ES (the tensor cores sum
exact bf16 products), T rounded to the spectra's dtype, the gather with each
unit's phase factor from the quads and its two taps per axis, the partial
sums per bin range, and their sum. That must equal the JAX Pallas kernel
`fused_spectral_grads_call` (interpret mode) within the card tests' bounds:
1e-4 * max|reference| for f32 (six products keep each f32 product to about
2**-24; f32 sums in another order) and 1e-2 * max|reference| for bf16 (T is
rounded to bf16 in both, and a sum on the other side of a rounding boundary
moves one term by a bf16 ulp).
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


def _inputs(seed, n, s, f, g, hw, m=3):
    """Numpy operands of the fused call, as `fourier_unit_grads_fused2`
    makes them (tables from the JAX package's host builder)."""
    rng = np.random.default_rng(seed)
    p1, p2, rb = jfe.plan_bins(hw, hw, 9)
    b, span = p1 * rb, 5
    mu1 = rng.choice(EDGE_MU, (s, g, f))
    mu2 = rng.uniform(-3.99, 3.99, (s, g, f)).astype(np.float32)
    t1 = jfe._phase_table_host(p1, p1, span)
    w2 = np.full(rb, 2.0)
    w2[0] = 1.0
    if p2 % 2 == 0:
        w2[-1] = 1.0
    t2 = jfe._phase_table_host(p2, rb, span) * (np.concatenate([w2, w2])[:, None] / (p1 * p2))
    ops = dict(
        xs=rng.standard_normal((b, m, 2 * n, s)).astype(np.float32),
        es=rng.standard_normal((b, 2 * n, f)).astype(np.float32),
        t1=t1.astype(np.float32), t2=t2.astype(np.float32),
        a1=np.transpose(np.asarray(jfe._phase_onehot(jnp.asarray(mu1), span, True)), (0, 2, 1, 3)),
        a2=np.transpose(np.asarray(jfe._phase_onehot(jnp.asarray(mu2), span, True)), (0, 2, 1, 3)))
    return ops, dict(n_img=n, p1b=p1, rbb=rb)


def _port(ops, dtype):
    dt = getattr(torch, dtype)
    return {k: torch.tensor(np.asarray(v, np.float32)).to(dt if k in ("xs", "es") else torch.float32)
            for k, v in ops.items()}


def _cross_from_operands(xs_t, es_t, s, f):
    """(tre, tim), each (B, M, S, F) float64: X^T . ES per bin, read back
    from the interleaved columns 2f and 2f+1."""
    b, c8, k, _ = es_t.shape
    es = es_t.double().transpose(1, 2).reshape(b, k, c8 * 8)[..., :2 * f]
    t = torch.einsum("bmks,bkc->bmsc", xs_t.double(), es)[:, :, :s]
    return t[..., 0::2], t[..., 1::2]


def _grads_from_operands(t, kw, ranges):
    """What K1 sums, in float64, over the operands its wrapper prepares
    (`t`: the port's tensors in the spectra's dtype): (M, S, G, F)."""
    xs, es, t1, t2, a1, a2 = (t[k] for k in ("xs", "es", "t1", "t2", "a1", "a2"))
    cdt = xs.dtype
    b, m, _, s = xs.shape
    f = es.shape[2]
    p1, rb = kw["p1b"], kw["rbb"]
    xs_t, es_t = tfb.spectral_operands(xs, es, kw["n_img"])
    tre, tim = _cross_from_operands(xs_t, es_t, s, f)
    # the kernel rounds its f32 sums to the spectra's dtype
    tre, tim = (v.float().to(cdt).double() for v in (tre, tim))
    # the wrapper's tables and taps, rounded to cdt
    ty = tfb.spectral_table_quads(t1.to(cdt).float(), p1).double()   # (P1, nj-1, 4)
    tx = tfb.spectral_table_quads(t2.to(cdt).float(), rb).double()   # (rb, nj-1, 4)
    j1, a0, a1w = (v.double() if v.is_floating_point() else v.long()
                   for v in tfb._taps(a1, cdt))
    j2, b0, b1w = (v.double() if v.is_floating_point() else v.long()
                   for v in tfb._taps(a2, cdt))
    partials = []
    for begin, end in ranges:
        acc = torch.zeros((m,) + tuple(j1.shape), dtype=torch.float64)  # (M, G, S, F)
        for k in range(begin, end):
            y, x = ty[k // rb][j2], tx[k % rb][j1]                       # (G, S, F, 4)
            pyre = y[..., 1] * b1w + y[..., 0] * b0
            pyim = y[..., 3] * b1w + y[..., 2] * b0
            pxre = x[..., 1] * a1w + x[..., 0] * a0
            pxim = x[..., 3] * a1w + x[..., 2] * a0
            phre = pyre * pxre - pyim * pxim
            phim = pyre * pxim + pyim * pxre
            acc += phre[None] * tre[k][:, None] - phim[None] * tim[k][:, None]
        partials.append(acc)
    return sum(partials).transpose(1, 2)


# (N, S, F, G, H=W, bin ranges): a ragged N (2N = 10 rows, not a multiple of
# the k16 step) with F off the 16-f tile, G = 4 (the FT = 8 instance at
# M = 3), 13x13's 153 bins cut in ranges (JAX's kernel takes S and F in
# multiples of 8; S off the 8-channel chunk is below and on the card)
CASES = {
    "n2_g2_9px": (2, 8, 16, 2, 9, 1),
    "ragged_n5_f24": (5, 24, 24, 2, 9, 3),
    "g4_13px": (2, 8, 16, 4, 13, 5),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_spectral_operands_match_jax_kernel(name, dtype):
    n, s, f, g, hw, r = CASES[name]
    ops, kw = _inputs(len(name), n, s, f, g, hw)
    jops = {k: jnp.asarray(v, dtype if k in ("xs", "es") else "float32") for k, v in ops.items()}
    ref = jax.jit(lambda o: fused_spectral_grads_call(**o, **kw, interpret=True))(jops)
    ref = np.asarray(ref, np.float64)
    b = kw["p1b"] * kw["rbb"]
    ranges = tfb.bin_ranges(b, r)
    got = _grads_from_operands(_port(ops, dtype), kw, ranges).numpy()
    assert got.shape == ref.shape == (3, s, g, f)
    err = float(np.abs(got - ref).max())
    assert err <= BOUNDS[dtype] * float(np.abs(ref).max()), f"{name} {dtype}: max|err| {err}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_interleaved_columns_hold_tre_and_tim(dtype):
    n, s, f = 3, 5, 7
    rng = np.random.default_rng(11)
    dt = getattr(torch, dtype)
    xs = torch.tensor(rng.standard_normal((4, 2, 2 * n, s)).astype(np.float32)).to(dt)
    es = torch.tensor(rng.standard_normal((4, 2 * n, f)).astype(np.float32)).to(dt)
    xs_t, es_t = tfb.spectral_operands(xs, es, n)
    k = 2 * n if dtype == "bfloat16" else 12 * n
    assert xs_t.dtype == es_t.dtype == torch.bfloat16
    assert xs_t.shape == (4, 2, k, 8) and es_t.shape == (4, 2, k, 8)  # S8 = 8, C8 = ceil(14/8)
    assert not xs_t[..., s:].any() and not es_t.transpose(1, 2).reshape(4, k, 16)[..., 14:].any()
    tre, tim = _cross_from_operands(xs_t, es_t, s, f)
    x, e = xs.double(), es.double()
    want_re = (torch.einsum("bmns,bnf->bmsf", x[:, :, :n], e[:, :n])
               + torch.einsum("bmns,bnf->bmsf", x[:, :, n:], e[:, n:]))
    want_im = (torch.einsum("bmns,bnf->bmsf", x[:, :, n:], e[:, :n])
               - torch.einsum("bmns,bnf->bmsf", x[:, :, :n], e[:, n:]))
    # bf16 spectra: exact products of the same values; f32: the split's six
    # products keep each to about 2**-24
    tol = 0.0 if dtype == "bfloat16" else 1e-6
    for got, want in ((tre, want_re), (tim, want_im)):
        assert float((got - want).abs().max()) <= tol * float(want.abs().max()) + 1e-12


def test_f32_spectra_stack_the_three_way_split_along_k():
    n, s, f = 2, 16, 4
    rng = np.random.default_rng(12)
    xs = torch.tensor(rng.standard_normal((3, 3, 2 * n, s)).astype(np.float32))
    es = torch.tensor(rng.standard_normal((3, 2 * n, f)).astype(np.float32))
    xs_t, es_t = tfb.spectral_operands(xs, es, n)
    x1, x2, x3 = tkf.split_bf16_3(xs)
    assert torch.equal(xs_t, torch.cat([x1, x1, x2, x1, x2, x3], dim=2))
    e1, e2, e3 = tkf.split_bf16_3(es)
    es_i = es_t.transpose(1, 2).reshape(3, 12 * n, 8)
    want = tfb._interleave(torch.cat([e1, e2, e1, e3, e2, e1], dim=1), n)
    assert torch.equal(es_i, want)
    # bf16 spectra at S a multiple of 8: xs is handed over as it is
    xb = xs.bfloat16()
    assert torch.equal(tfb.spectral_operands(xb, es.bfloat16(), n)[0], xb)


def test_table_quads_pair_each_tap_with_the_next():
    t = torch.arange(2 * 3 * 5, dtype=torch.float32).reshape(6, 5)
    q = tfb.spectral_table_quads(t, 3)
    assert q.shape == (3, 4, 4)
    for k in range(3):
        for j in range(4):
            assert q[k, j].tolist() == [t[k, j], t[k, j + 1], t[3 + k, j], t[3 + k, j + 1]]


@pytest.mark.parametrize("b,r", [(153, 1), (153, 7), (496, 8), (5, 8), (9, 4)])
def test_bin_ranges_cover_every_bin_once(b, r):
    ranges = tfb.bin_ranges(b, r)
    assert 1 <= len(ranges) <= min(b, r)
    assert ranges[0][0] == 0 and ranges[-1][1] == b
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == c[0] for a, c in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("m", [3, 4])
@pytest.mark.parametrize("g", [1, 2, 3, 4])
def test_plan_takes_every_instance_and_fits(m, g):
    plan = tfb.spectral_plan(m=m, g=g, nj=12, p1b=31, rbb=16)
    assert plan is not None and plan["smem"] <= 227 * 1024
    # the table rows are streamed per bin: the plan does not grow with the bins
    assert tfb.spectral_plan(m=m, g=g, nj=12, p1b=600, rbb=300) == plan
    assert tfb.spectral_plan(m=m, g=g, nj=64, p1b=17, rbb=9) is not None


def test_k1_variant_edits_apply_to_the_kernel_source():
    # `tools/k1_variants.py` times K1 with one part of its source changed by
    # a text edit; each edit must still find its text in the kernel's source
    # (a variant that no longer applies would fail only on the card)
    from dau_convnet_tpu_torch.tools import k1_variants

    source = k1_variants._variant_source([])
    for name, edits in k1_variants.VARIANTS.items():
        changed = k1_variants._variant_source(edits)
        assert (changed == source) == (not edits), name


def test_dx_variant_edits_apply_to_the_kernel_source():
    # `tools/k1_variants.py --dx` times the dx kernel with one part of its
    # source (or of its mainloop's header) changed by a text edit; each edit
    # must still find its text
    from dau_convnet_tpu_torch.tools import k1_variants

    source = k1_variants._variant_source([])
    for name, edits in k1_variants.DX_VARIANTS.items():
        changed = k1_variants._variant_source(edits)
        assert (changed == source) == (not edits), name
