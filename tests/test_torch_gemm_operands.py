"""Port vs JAX: the operands the tensor-core kernels K6 and K7 are handed, on
the CPU.

The kernels run only on the card, but what their wrappers prepare is plain
torch and runs here: the bf16 splits of f32 input (`kernels/forward.py`:
K6's in three parts, K7's hi/lo), K6's chunk-major channels-last copies,
its position-major table and the view back (`kernels/backward.py`), and
K7's cached [C^T, -S^T] matrix, its spectra and segments
(`kernels/spectral.py`). A product over the prepared operands, in float64
as the tensor cores sum exact bf16 products, must equal the JAX Pallas
kernels (interpret mode): within 2e-5 * max|reference| (f32 input: K7's
split keeps about 16 bits of each factor and drops lo * lo, ~3 * 2**-16 of
each product at worst, K6's six products ~2**-24; bf16 input: exact
products, f32 sums in another order).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dau_convnet_tpu.kernels import grad_tables_pallas
from dau_convnet_tpu.kernels.spectral import partial_idft as jax_partial_idft
from dau_convnet_tpu.ops import fourier_engine as jfe
from dau_convnet_tpu_torch.kernels import backward as tkb
from dau_convnet_tpu_torch.kernels import forward as tkf
from dau_convnet_tpu_torch.kernels import spectral as tsp
from dau_convnet_tpu_torch.ops import fourier_engine as tfe

BOUND = 2e-5


def _close(got, ref, name):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, f"{name}: {got.shape} vs {ref.shape}"
    err = float(np.abs(got - ref).max())
    assert err <= BOUND * float(np.abs(ref).max()), f"{name}: max|err| {err}"


@pytest.mark.parametrize("c", [1, 8, 13, 37])
def test_chunk_major_layout(c):
    rng = np.random.default_rng(c)
    t = torch.tensor(rng.standard_normal((2, 3, 5, c)).astype(np.float32))
    out = tkb.chunk_major(t)
    cc = -(-c // 8)
    assert out.shape == (cc, 2, 3, 5 * 8) and out.is_contiguous() and out.dtype == t.dtype
    lanes = out.reshape(cc, 2, 3, 5, 8).permute(1, 2, 3, 0, 4).reshape(2, 3, 5, cc * 8)
    assert torch.equal(lanes[..., :c], t)
    assert not lanes[..., c:].any()


@pytest.mark.parametrize("scale", [1e-3, 1.0, 3e4])
def test_split_bf16_keeps_sixteen_bits(scale):
    rng = np.random.default_rng(5)
    t = torch.tensor(rng.standard_normal(4096).astype(np.float32) * scale)
    hi, lo = tkf.split_bf16(t)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, t.bfloat16())
    rest = (t.double() - hi.double() - lo.double()).abs()
    assert bool((rest <= 2.0 ** -16 * t.double().abs()).all())


def _operands(shape, dtype, seed=0):
    m, n, s, f, h, w, _ = shape
    rng = np.random.default_rng(seed)
    xb = rng.standard_normal((m, n, s, h, w)).astype(np.float32)
    err = rng.standard_normal((n, f, h, w)).astype(np.float32)
    if dtype == "bfloat16":  # the same bf16 values on both sides
        xb = torch.tensor(xb).bfloat16().float().numpy()
        err = torch.tensor(err).bfloat16().float().numpy()
    return xb, err


def test_grad_tables_operands_split_along_the_batch():
    xb, err = _operands((3, 2, 3, 5, 4, 6, 3), "float32")
    x, e = torch.tensor(xb), torch.tensor(err)
    err_t, xb_t = tkb.grad_tables_operands(x, e)
    assert err_t.dtype == xb_t.dtype == torch.bfloat16
    assert err_t.shape == (1, 12, 4, 6 * 8) and xb_t.shape == (2, 12, 4, 6 * 8)
    x1, x2, x3 = tkf.split_bf16_3(x.permute(1, 3, 4, 0, 2).reshape(2, 4, 6, 9))
    e1, e2, e3 = tkf.split_bf16_3(e.permute(0, 2, 3, 1))
    # the six products of orders up to 3, stacked along the batch
    assert torch.equal(xb_t, tkb.chunk_major(torch.cat([x1, x1, x2, x1, x2, x3])))
    assert torch.equal(err_t, tkb.chunk_major(torch.cat([e1, e2, e1, e3, e2, e1])))
    bf_err, bf_xb = tkb.grad_tables_operands(x.bfloat16(), e.bfloat16())
    assert bf_err.shape[1] == bf_xb.shape[1] == 2  # no split: N images


@pytest.mark.parametrize("ks", [9, 17, 33, 65])
def test_grad_tables_take_every_tier_kernel_size(ks):
    # the JAX tiers (utils/tiers.py): K6 takes ks at run time, so its wrapper
    # accepts every odd ks within the kernel's grid and TMA limits
    tkb.check_kernel_limits(ks, 96, 27, 27)


@pytest.mark.parametrize("ks,limit", [(8, "odd"), (0, "odd"), (443, "z extent")])
def test_grad_tables_refuse_a_kernel_size_past_the_limits(ks, limit):
    # 441 * ceil(441 / 3) = 64,827 blocks deep fits; 443 * 148 = 65,564 does not
    tkb.check_kernel_limits(441, 2, 13, 13)
    with pytest.raises(ValueError, match=limit):
        tkb.check_kernel_limits(ks, 2, 13, 13)


def test_table_view_is_the_position_major_table():
    m, s, f, ks = 2, 3, 5, 3
    table = torch.arange(ks * ks * f * m * s, dtype=torch.float32).reshape(ks * ks, f, m * s)
    view = tkb.table_view(table, m, s, ks)
    assert view.shape == (m, s, f, ks, ks) and view.data_ptr() == table.data_ptr()
    for mi, si, fi, ky, kx in [(0, 0, 0, 0, 0), (1, 2, 4, 2, 1), (1, 0, 3, 0, 2)]:
        assert view[mi, si, fi, ky, kx] == table[ky * ks + kx, fi, mi * s + si]


def _unchunk(t, c):
    """(CC, N, H, W*8) -> (N, H, W, c) float64."""
    cc, n, h, w8 = t.shape
    return (t.double().reshape(cc, n, h, w8 // 8, 8).permute(1, 2, 3, 0, 4)
            .reshape(n, h, w8 // 8, cc * 8)[..., :c])


def _tables_from_operands(err_t, xb_t, f, m, s, ks):
    """What the kernel sums, per tap, over the prepared operands: (ks*ks, F,
    M*S) in float64, then its (M, S, F, ks, ks) view."""
    e = _unchunk(err_t, f)
    x = _unchunk(xb_t, m * s)
    h, w = e.shape[1:3]
    c = ks // 2
    xp = torch.nn.functional.pad(x, (0, 0, c, c, c, c))
    table = torch.stack([torch.einsum("nijf,nijq->fq", e, xp[:, ky:ky + h, kx:kx + w])
                         for ky in range(ks) for kx in range(ks)])
    return tkb.table_view(table, m, s, ks)


# (M, N, S, F, H, W, ks): M*S and F not multiples of 8, an image wider than
# the 16 columns of a stage (two chunks per row), ks in {3, 9, 17}
TABLE_SHAPES = {"ks3": (3, 2, 3, 5, 7, 9, 3), "ks9_wide": (3, 2, 4, 37, 6, 19, 9),
                "ks17": (2, 1, 5, 9, 9, 11, 17)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(TABLE_SHAPES))
def test_grad_tables_operands_match_jax_kernel(name, dtype):
    m, n, s, f, h, w, ks = TABLE_SHAPES[name]
    xb, err = _operands(TABLE_SHAPES[name], dtype)
    ref = jax.jit(lambda a, b: grad_tables_pallas(a, b, ks))(
        jnp.asarray(xb, getattr(jnp, dtype)), jnp.asarray(err, getattr(jnp, dtype)))
    x, e = torch.tensor(xb).to(getattr(torch, dtype)), torch.tensor(err).to(getattr(torch, dtype))
    err_t, xb_t = tkb.grad_tables_operands(x, e)
    assert err_t.shape[1] == (6 * n if dtype == "float32" else n)
    got = _tables_from_operands(err_t, xb_t, f, m, s, ks)
    _close(got.numpy(), np.asarray(ref, np.float32), f"{name} {dtype}")


def test_grad_tables_f32_operands_hold_a_cancelling_table():
    """K6's f32 products where the table's sums cancel, as before a
    train-mode BatchNorm (the error has zero mean per channel and no part
    along its input): the products of the prepared operands, summed exactly,
    stay within 1e-6 * max|table| of the float64 table of the f32 inputs
    (4.7e-8 here). Two bf16 parts and three products (the split K6 took
    before, ~2**-17 of each product) miss it (1.2e-5 here)."""
    m, n, s, f, h, w, ks = 1, 16, 3, 6, 8, 8, 3
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.standard_normal((m, n, s, h, w)).astype(np.float32) + 3.0)
    e = torch.tensor(rng.standard_normal((n, f, h, w)))
    e = e - e.mean(dim=(0, 2, 3), keepdim=True)
    ref = _tables_from_operands(tkb.chunk_major(e.permute(0, 2, 3, 1)),
                                tkb.chunk_major(x.double().permute(1, 3, 4, 0, 2)
                                                .reshape(n, h, w, m * s)), f, m, s, ks)
    e = e.float()
    got = _tables_from_operands(*tkb.grad_tables_operands(x, e), f, m, s, ks)
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-6 * scale
    xh, xl = tkf.split_bf16(x.permute(1, 3, 4, 0, 2).reshape(n, h, w, m * s))
    eh, el = tkf.split_bf16(e.permute(0, 2, 3, 1))
    old = _tables_from_operands(tkb.chunk_major(torch.cat([eh, eh, el])),
                                tkb.chunk_major(torch.cat([xh, xl, xh])), f, m, s, ks)
    assert float((old - ref).abs().max()) > 1e-6 * scale


def _toward_zero(v):
    """float64 -> float32 rounded toward zero, as the tensor cores round
    their f32 sums."""
    r = v.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(v)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _k6_sums(steps, fold):
    """K6's f32 sums of table entries from the exact sums of each k16 step
    ((K, E) float64): each added into its wgmma chain, rounded toward zero;
    every `fold` stages of 4 steps (0: never) the chain is added into the
    folded sum, rounded to nearest, and restarts."""
    acc = np.zeros(steps.shape[1], np.float32)
    total = np.zeros_like(acc)
    for k, part in enumerate(steps):
        acc = _toward_zero(acc.astype(np.float64) + part)
        if (fold and (k + 1) % (4 * fold) == 0) or k + 1 == len(steps):
            total = (total.astype(np.float64) + acc).astype(np.float32)
            acc[:] = 0
    return total


def test_grad_tables_f32_folds_its_wgmma_sums():
    """The kernel folds its wgmma chain every FOLD_F32 stages for f32 input
    and every FOLD_BF16 for bf16 (the periods the source sets): emulated on
    the sums of one tap over 8,192 k16 steps (the products of 128 images of
    32x32, as at CIFAR conv1) of a cancelling table, one chain rounded
    toward zero drifts by ~5e-4 of max|table| (the card showed 7e-4 for
    f32 input), the sums folded every 4 stages stay within 1e-5 and every
    32 within 2e-5 (9e-6 here)."""
    src = (Path(tkb.__file__).parent / "csrc" / "dau_grad_tables.cu").read_text()
    periods = dict(re.findall(r"constexpr int (FOLD_F32|FOLD_BF16) = (\d+);", src))
    assert periods == {"FOLD_F32": str(tkb.FOLD_F32), "FOLD_BF16": str(tkb.FOLD_BF16)}
    assert (tkb.FOLD_F32, tkb.FOLD_BF16) == (4, 32)
    rng = np.random.default_rng(0)
    e = rng.standard_normal((8192 * 16, 32)).astype(np.float32).astype(np.float64)
    e -= e.mean(axis=0)
    x = (3 + rng.standard_normal(e.shape)).astype(np.float32).astype(np.float64)
    steps = (x * e).reshape(8192, 16, -1).sum(axis=1)
    ref = steps.sum(axis=0)
    scale = np.abs(ref).max()
    assert np.abs(_k6_sums(steps, tkb.FOLD_F32) - ref).max() <= 1e-5 * scale
    assert np.abs(_k6_sums(steps, tkb.FOLD_BF16) - ref).max() <= 2e-5 * scale
    assert np.abs(_k6_sums(steps, 0) - ref).max() > 1e-4 * scale


def _idft_case(kind, h, c, seed):
    """(cmat, smat, tre, tim) f32 numpy: the (B, P) matrices of
    fourier_grad_tables (P = 81) or of the fused apply-phi's closing stage
    (P = H*W, padded to 8), and random spectra."""
    p1, p2, rb = jfe.plan_bins(h, h, 9)
    if kind == "tables":
        pos = np.arange(-4, 5)
        cmat, smat = (np.asarray(mat) for mat in tfe._idft_mats(p1, p2, rb, pos, pos,
                                                                 torch.float32))
    else:
        dct, dst, _ = tfe._fused_idft_mats(p1, p2, rb, h, h)
        cmat, smat = dct.t().numpy(), dst.t().numpy()
    rng = np.random.default_rng(seed)
    tre, tim = rng.standard_normal((2, p1 * rb, c)).astype(np.float32)
    return cmat, smat, tre, tim


# (kind, H, C): P = 81 (tables), 169 and 729 (the fused apply-phi's 13x13
# and 27x27 outputs); C not a multiple of 8 and of the 256-column tile; B =
# 153 and 496 bins, neither a multiple of the 64-bin stage
IDFT_CASES = {"p81": ("tables", 13, 300), "p169": ("fused", 13, 123), "p729": ("fused", 27, 40)}


def _product(a, spectra, segments, b, p, c):
    a = a.double()
    return sum(a[:p, col:col + b] @ spectra[i].double()[:, :c] for i, col in segments)


# (spectra dtype, what the matrices are rounded to): K7 rounds them to the
# spectra's dtype; K3 closes with f32 spectra and matrices rounded to its
# input's dtype
@pytest.mark.parametrize("dtype,mat_dtype", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                             ("float32", "bfloat16")])
@pytest.mark.parametrize("name", sorted(IDFT_CASES))
def test_idft_operands_match_jax_kernel(name, dtype, mat_dtype):
    kind, h, c = IDFT_CASES[name]
    cmat, smat, tre, tim = _idft_case(kind, h, c, seed=len(name))
    tdt, mdt = getattr(torch, dtype), getattr(torch, mat_dtype)
    tre_t, tim_t = torch.tensor(tre).to(tdt), torch.tensor(tim).to(tdt)
    # JAX rounds the matrices to the spectra's dtype: hand it them rounded
    # to mat_dtype beforehand, as K3 does with its f32 spectra
    cm, sm = (torch.tensor(mat).to(mdt).float().numpy() for mat in (cmat, smat))
    ref = jax.jit(lambda *a: jax_partial_idft(*a, interpret=True))(
        jnp.asarray(cm), jnp.asarray(sm), jnp.asarray(tre_t.float().numpy(), getattr(jnp, dtype)),
        jnp.asarray(tim_t.float().numpy(), getattr(jnp, dtype)))
    a, spectra, segments, bp = tsp.idft_operands(torch.tensor(cmat), torch.tensor(smat), tre_t,
                                                 tim_t, mat_dtype=mdt)
    b, p = cmat.shape
    assert a.dtype == torch.bfloat16 and a.shape[0] % 128 == 0 and bp % 64 == 0
    assert all(t.dtype == torch.bfloat16 and t.shape[1] % 8 == 0 for t in spectra)
    n_seg = {("bfloat16", "bfloat16"): 2, ("float32", "bfloat16"): 4,
             ("float32", "float32"): 6}[dtype, mat_dtype]
    assert len(segments) == n_seg
    _close(_product(a, spectra, segments, b, p, c).numpy(), np.asarray(ref), name)


def test_a_matrix_is_cached_per_matrices_and_rounding():
    cmat, smat, _, _ = _idft_case("tables", 13, 8, seed=0)
    cm, sm = torch.tensor(cmat), torch.tensor(smat)
    a = tsp._a_matrix(cm, sm, torch.bfloat16)
    assert tsp._a_matrix(cm, sm, torch.bfloat16) is a
    b, p = cm.shape
    bp = -(-b // 64) * 64
    assert a.shape == (128, 2 * bp)
    assert torch.equal(a[:p, :b], cm.t().bfloat16())
    assert torch.equal(a[:p, bp:bp + b], (-sm).t().bfloat16())
    assert not a[p:].any() and not a[:, b:bp].any() and not a[:, bp + b:].any()
    a32 = tsp._a_matrix(cm, sm, torch.float32)
    assert a32 is not a and a32.shape == (128, 4 * bp)  # [Ch, Cl, Sh, Sl]
    cm.mul_(2.0)  # a new version of the same storage: a new A
    assert not torch.equal(tsp._a_matrix(cm, sm, torch.bfloat16), a)
