"""Port vs JAX: the Fourier engine's pieces and the fused spectral kernel's
twin (K1/K2), on the CPU.

The same numpy inputs go through each JAX function and its port. The JAX
side's Pallas kernel (`fused_spectral_grads_call`) runs in interpret mode,
as tests/test_pallas.py runs it. Tolerances: f32, rtol 1e-5 with an
absolute floor of 1e-6 * max|reference| (the same sums in another order);
sums over many bins (the gathers, the kernel) rtol 1e-4, floor 1e-5. bf16:
2e-2 * max|reference|, about two bf16 roundings of the largest entry (XLA
and torch round bf16 intermediates at other places). Integer tables,
one-hots and plans are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dau_convnet_tpu.kernels.fused_bwd import fused_spectral_grads_call
from dau_convnet_tpu.ops import fourier_engine as jfe
from dau_convnet_tpu.ops import gaussian as jg
from dau_convnet_tpu_torch.kernels import fused_bwd as tfb
from dau_convnet_tpu_torch.nn import layers as tl
from dau_convnet_tpu_torch.ops import fourier_engine as tfe
from dau_convnet_tpu_torch.ops import gaussian as tg
from dau_convnet_tpu_torch.ops import xla_engine as txe

EDGE_MU = np.array([-3.99, 3.99, -3.0, 0.0, 2.0, 3.0, -0.5, -2.25, -1.75, 1.5],
                   np.float32)
DTYPES = ["float32", "bfloat16"]
HIGHEST = jax.lax.Precision.HIGHEST


def _t(a, dtype="float32"):
    return torch.tensor(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(np.asarray(a, np.float32), getattr(jnp, dtype))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, ref, name, dtype="float32", rtol=1e-5, floor=1e-6):
    got, ref = np.asarray(_np(got), np.float64), np.asarray(_np(ref), np.float64)
    assert got.shape == ref.shape, f"{name}: {got.shape} vs {ref.shape}"
    if dtype == "bfloat16":
        rtol, floor = 0.0, 2e-2
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=floor * float(np.abs(ref).max()),
                               err_msg=name)


def _mus(rng, shape):
    mu1 = rng.choice(EDGE_MU, shape)
    mu2 = rng.uniform(-3.99, 3.99, shape).astype(np.float32)
    return mu1, mu2


# ---- separable blur -----------------------------------------------------

FILTER_MODES = {
    "unit": dict(),
    "square": dict(square_unit_normalization=True),
    "none": dict(unit_normalization=False),
    "single_dim": dict(single_dim_kernel=True),
    "causal": dict(forbid_positive_dim1=True),
}


@pytest.mark.parametrize("mode", sorted(FILTER_MODES))
def test_gaussian_factor_filters_match_jax(mode):
    kw = FILTER_MODES[mode]
    vref, tref = jg.gaussian_factor_filters(jnp.float32(0.7), size=11, **kw)
    vecs, terms = tg.gaussian_factor_filters(torch.tensor(0.7), size=11, **kw)
    assert terms == tref
    assert set(vecs) == set(vref)
    for name in vref:
        _close(vecs[name], vref[name], f"{mode} {name}", rtol=1e-6, floor=1e-6)
    # the terms rebuild the dense filters
    dense = tg.gaussian_filters(torch.tensor(0.7), size=11, **kw)
    for name, pairs in terms.items():
        rebuilt = sum(torch.outer(vecs[r], vecs[c]) for r, c in pairs)
        _close(rebuilt, dense[name], f"{mode} {name} dense", rtol=1e-5, floor=1e-6)


@pytest.mark.parametrize("n", [5, 9, 14])
def test_band_matrix_matches_jax(n):
    vec = np.random.default_rng(n).standard_normal(9).astype(np.float32)
    np.testing.assert_array_equal(tg._band_matrix(_t(vec), n).numpy(),
                                  np.asarray(jg._band_matrix(jnp.asarray(vec), n)))


@pytest.mark.parametrize("name", ["w", "dmu1", "dsigma", "error"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rank1_blur_matches_jax(name, dtype):
    x = np.random.default_rng(1).standard_normal((2, 3, 9, 11)).astype(np.float32)
    vref, tref = jg.gaussian_factor_filters(jnp.float32(0.5), size=9)
    vecs, terms = tg.gaussian_factor_filters(torch.tensor(0.5), size=9)
    ref = jg.rank1_blur(_j(x, dtype), vref, tref[name])
    got = tg.rank1_blur(_t(x, dtype), vecs, terms[name])
    assert got.dtype == getattr(torch, dtype)
    _close(got, ref, name, dtype)
    # the same correlation as the depthwise blur
    dense = tg.gaussian_filters(torch.tensor(0.5), size=9)[name]
    _close(tg.rank1_blur(_t(x), vecs, terms[name]), tg.depthwise_blur(_t(x), dense),
           f"{name} vs depthwise", rtol=1e-5, floor=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rank1_blur_stack_matches_jax(dtype):
    x = np.random.default_rng(2).standard_normal((2, 4, 8, 7)).astype(np.float32)
    names = ["w", "dmu1", "dmu2", "dsigma"]
    vref, tref = jg.gaussian_factor_filters(jnp.float32(0.9), size=11)
    vecs, terms = tg.gaussian_factor_filters(torch.tensor(0.9), size=11)
    ref = jg.rank1_blur_stack(_j(x, dtype), vref, tref, names)
    got = tg.rank1_blur_stack(_t(x, dtype), vecs, terms, names)
    assert tuple(got.shape) == ref.shape == (4, 2, 4, 8, 7)
    _close(got, ref, "stack", dtype)


# ---- transforms and tables ----------------------------------------------

@pytest.mark.parametrize("h,w,ks", [(9, 9, 9), (13, 13, 9), (27, 27, 9), (7, 12, 5)])
def test_plan_bins_match_jax(h, w, ks):
    assert tfe.plan_bins(h, w, ks) == jfe.plan_bins(h, w, ks)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dft_and_idft_mats_match_jax(dtype):
    for got, ref in zip(tfe._dft_mats(9, 13, 7, getattr(torch, dtype)),
                        jfe._dft_mats(9, 13, 7, getattr(jnp, dtype))):
        np.testing.assert_array_equal(_np(got), np.asarray(ref, np.float32))
    for coef in (True, False):
        ref = jfe._idft_mats(13, 13, 7, np.arange(-2, 3), np.arange(9), getattr(jnp, dtype),
                             apply_coef=coef)
        got = tfe._idft_mats(13, 13, 7, np.arange(-2, 3), np.arange(9), getattr(torch, dtype),
                             apply_coef=coef)
        for g_, r_ in zip(got, ref):
            _close(g_, r_, f"idft coef={coef}", dtype, rtol=1e-7, floor=1e-7)
    # cached on the device: the same tensor each call
    assert tfe._dft_mats(9, 13, 7, torch.float32)[0] is tfe._dft_mats(9, 13, 7, torch.float32)[0]


@pytest.mark.parametrize("dtype", DTYPES)
def test_rdft2_matches_jax(dtype):
    x = np.random.default_rng(3).standard_normal((2, 3, 9, 10)).astype(np.float32)
    p1, p2, rb = jfe.plan_bins(9, 10, 9)
    ref = jfe._rdft2(_j(x, dtype), p1, p2, rb, HIGHEST)
    got = tfe._rdft2(_t(x, dtype), p1, p2, rb)
    for g_, r_, part in zip(got, ref, ("re", "im")):
        assert g_.dtype == getattr(torch, dtype)
        _close(g_, r_, part, dtype)


@pytest.mark.parametrize("interp", [True, False])
def test_tap_phase_and_onehot_match_jax(interp):
    mu = np.random.default_rng(4).choice(EDGE_MU, (3, 2, 4))
    for lead in (False, True):
        ref = jfe._tap_phase(jnp.asarray(mu), 13, 7, interp, jnp.float32, bin_leading=lead)
        got = tfe._tap_phase(_t(mu), 13, 7, interp, torch.float32, bin_leading=lead)
        for g_, r_ in zip(got, ref):
            _close(g_, r_, f"tap phase lead={lead}", rtol=1e-5, floor=1e-6)
    np.testing.assert_array_equal(tfe._phase_onehot(_t(mu), 5, interp).numpy(),
                                  np.asarray(jfe._phase_onehot(jnp.asarray(mu), 5, interp)))
    np.testing.assert_array_equal(tfe._phase_table_host(13, 7, 5),
                                  jfe._phase_table_host(13, 7, 5))


@pytest.mark.parametrize("dtype", DTYPES)
def test_tap_phase_tables_match_jax(dtype):
    mu = np.random.default_rng(5).uniform(-3.99, 3.99, (3, 2, 4)).astype(np.float32)
    ref = jfe._tap_phase_tables(_j(mu, dtype), 17, 9, True, getattr(jnp, dtype), 5, HIGHEST)
    got = tfe._tap_phase_tables(_t(mu, dtype), 17, 9, True, getattr(torch, dtype), 5)
    for g_, r_ in zip(got, ref):
        assert g_.dtype == getattr(torch, dtype) and tuple(g_.shape) == (9, 3, 2, 4)
        _close(g_, r_, "phase tables", dtype)
    # the tables equal the runtime trig to table roundoff
    trig = tfe._tap_phase(_t(mu), 17, 9, True, torch.float32, bin_leading=True)
    for g_, r_ in zip(tfe._tap_phase_tables(_t(mu), 17, 9, True, torch.float32, 5), trig):
        _close(g_, r_, "tables vs trig", rtol=1e-5, floor=1e-5)


@pytest.mark.parametrize("span", [None, 5])
@pytest.mark.parametrize("dtype", DTYPES)
def test_build_phi_matches_jax(span, dtype):
    rng = np.random.default_rng(6)
    s, g, f = 3, 2, 5
    w = (rng.standard_normal((s, g, f)) * 0.1).astype(np.float32)
    mu1, mu2 = _mus(rng, (s, g, f))
    p1, p2, rb = jfe.plan_bins(9, 8, 9)
    ref = jfe.build_phi(_j(w, dtype), _j(mu1, dtype), _j(mu2, dtype), p1, p2, rb, True,
                        phase_span=span, precision=HIGHEST)
    got = tfe.build_phi(_t(w, dtype), _t(mu1, dtype), _t(mu2, dtype), p1, p2, rb, True,
                        phase_span=span)
    for g_, r_ in zip(got, ref):
        assert tuple(g_.shape) == (p1 * rb, s, f)
        _close(g_, r_, "phi", dtype)


@pytest.mark.parametrize("contract,conj", [((2, 1), False), ((2, 1), True), ((2, 2), True)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_bin_matmul_matches_jax(contract, conj, dtype):
    rng = np.random.default_rng(7)
    a = rng.standard_normal((2, 5, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, 5, 4, 4)).astype(np.float32)
    ref = jfe._bin_matmul(_j(a[0], dtype), _j(a[1], dtype), _j(b[0], dtype), _j(b[1], dtype),
                          HIGHEST, conj_b=conj, contract=contract)
    got = tfe._bin_matmul(_t(a[0], dtype), _t(a[1], dtype), _t(b[0], dtype), _t(b[1], dtype),
                          conj_b=conj, contract=contract)
    for g_, r_ in zip(got, ref):
        assert g_.dtype == torch.float32  # f32 sums of exact products
        _close(g_, r_, "bin matmul", rtol=1e-5, floor=1e-6)


def _phi_case(seed, s=3, g=2, f=5, h=9, w=10, dtype="float32"):
    rng = np.random.default_rng(seed)
    x = rng.random((2, s, h, w)).astype(np.float32)
    wt = (rng.standard_normal((s, g, f)) * 0.1).astype(np.float32)
    mu1, mu2 = _mus(rng, (s, g, f))
    p1, p2, rb = jfe.plan_bins(h, w, 9)
    jphi = jfe.build_phi(_j(wt, dtype), _j(mu1), _j(mu2), p1, p2, rb, True, 5, HIGHEST)
    tphi = tfe.build_phi(_t(wt, dtype), _t(mu1), _t(mu2), p1, p2, rb, True, 5)
    return x, wt, mu1, mu2, (p1, p2, rb), jphi, tphi


@pytest.mark.parametrize("contract_f,conj,stacked", [(False, False, False), (False, True, False),
                                                     (True, False, False), (False, False, True),
                                                     (True, True, True)])
def test_fourier_apply_phi_matches_jax(contract_f, conj, stacked):
    x, _, _, _, (p1, p2, rb), jphi, tphi = _phi_case(8)
    if contract_f:  # the error has F channels
        x = np.random.default_rng(9).random((2, 5, 9, 10)).astype(np.float32)
    ref = jfe.fourier_apply_phi(_j(x), *jphi, 9, 10, p1, p2, rb, HIGHEST,
                                contract_f=contract_f, conj_phi=conj, stacked=stacked)
    got = tfe.fourier_apply_phi(_t(x), *tphi, 9, 10, p1, p2, rb, contract_f=contract_f,
                                conj_phi=conj, stacked=stacked)
    _close(got, ref, "apply phi")


# (H, W) planes of the separable inverse: odd and even P2 (so with and
# without a Nyquist bin of weight 1); the (9, 10) cases are named by the
# flag alone
SPECTRA_HW = [((9, 10), coef, str(coef)) for coef in (True, False)] + [
    (hw, coef, f"{hw[0]}x{hw[1]}-{coef}")
    for hw in [(7, 7), (13, 13), (9, 9), (14, 9), (27, 27)] for coef in (True, False)]


@pytest.mark.parametrize("hw,coef", [pytest.param(hw, coef, id=i) for hw, coef, i in SPECTRA_HW])
def test_spectra_to_image_matches_jax(hw, coef):
    h, w = hw
    rng = np.random.default_rng(10)
    p1, p2, rb = jfe.plan_bins(h, w, 9)
    yre, yim = rng.standard_normal((2, p1 * rb, 2, 3)).astype(np.float32)
    ref = jfe._spectra_to_image(_j(yre), _j(yim), p1, p2, rb, h, w, HIGHEST, apply_coef=coef)
    got = tfe._spectra_to_image(_t(yre), _t(yim), p1, p2, rb, h, w, apply_coef=coef)
    assert got.dtype == torch.float32 and got.is_contiguous()
    _close(got, ref, "spectra to image")


@pytest.mark.parametrize("coef", [True, False])
def test_separable_spectra_to_image_is_the_dense_product(coef):
    """The two stages against the dense (P1*rb) x (H*W) product with
    `_idft_mats`, both in f64, at ResNet-18's 56x56 plane; the spectra are
    the halves of one (B, 2N, C) tensor, as the K2 dx closing passes them."""
    h = w = 56
    p1, p2, rb = tfe.plan_bins(h, w, 9)
    n, c = 2, 3
    gen = torch.Generator().manual_seed(12)
    ys = torch.randn((p1 * rb, 2 * n, c), generator=gen, dtype=torch.float64)
    yre, yim = ys[:, :n], ys[:, n:]
    assert not yre.is_contiguous()
    got = tfe._spectra_to_image(yre, yim, p1, p2, rb, h, w, apply_coef=coef,
                                out_dtype=torch.float64)
    cmat, smat = tfe._idft_mats(p1, p2, rb, range(h), range(w), torch.float64,
                                apply_coef=coef)
    flat = (p1 * rb, n * c)
    ref = (yre.reshape(flat).t() @ cmat - yim.reshape(flat).t() @ smat).reshape(n, c, h, w)
    assert got.dtype == torch.float64 and got.shape == (n, c, h, w) and got.is_contiguous()
    assert float((got - ref).abs().max()) <= 1e-10 * float(ref.abs().max())


def test_fourier_layer_takes_the_separable_inverse_once_a_pass():
    layer = tl.DAUConv2d(3, 4, (2, 1), 9, engine="fourier", fused_dx="off", device="cpu")
    x = torch.randn((2, 3, 9, 10), requires_grad=True)
    before = tfe._spectra_to_image.calls
    y = layer(x)
    assert tfe._spectra_to_image.calls == before + 1
    y.square().sum().backward()
    assert tfe._spectra_to_image.calls == before + 2  # the forward and fourier_input_grad
    assert x.grad is not None


@pytest.mark.parametrize("dtype", DTYPES)
def test_fourier_forward_and_input_grad_match_jax(dtype):
    x, wt, mu1, mu2, _, jphi, tphi = _phi_case(11, dtype=dtype)
    ref = jfe.fourier_forward(_j(x, dtype), _j(wt, dtype), _j(mu1), _j(mu2), 9,
                              precision=HIGHEST)
    got = tfe.fourier_forward(_t(x, dtype), _t(wt, dtype), _t(mu1), _t(mu2), 9)
    assert got.dtype == getattr(torch, dtype)
    _close(got, ref, "forward", dtype)
    if dtype == "float32":  # the same function as the dense engine
        _close(got, txe.aggregate_forward(_t(x), _t(wt), _t(mu1), _t(mu2), 9), "vs dense",
               rtol=1e-4, floor=1e-5)
    err = np.random.default_rng(12).random((2, 5, 9, 10)).astype(np.float32)
    ref = jfe.fourier_input_grad(_j(err, dtype), jphi, 9, precision=HIGHEST)
    got = tfe.fourier_input_grad(_t(err, dtype), tphi, 9)
    assert tuple(got.shape) == (2, 3, 9, 10)
    _close(got, ref, "input grad", dtype)


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_spectra_match_jax(precision, dtype):
    rng = np.random.default_rng(13)
    xb = rng.standard_normal((3, 2, 4, 9, 9)).astype(np.float32)
    err = rng.standard_normal((2, 5, 9, 9)).astype(np.float32)
    jp = HIGHEST if precision == "highest" else jax.lax.Precision.DEFAULT
    *ref, plan = jfe.fourier_cross_spectra(_j(xb, dtype), _j(err, dtype), 9, jp)
    *got, tplan = tfe.fourier_cross_spectra(_t(xb, dtype), _t(err, dtype), 9, precision)
    assert tplan == plan
    for g_, r_ in zip(got, ref):
        assert g_.dtype == (torch.float32 if precision == "highest" else getattr(torch, dtype))
        _close(g_, r_, "cross spectra", dtype, rtol=1e-4, floor=1e-5)


@pytest.mark.parametrize("tables", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fourier_unit_grads_match_jax(tables, dtype):
    rng = np.random.default_rng(14)
    xb = rng.standard_normal((3, 2, 4, 9, 10)).astype(np.float32)
    err = rng.standard_normal((2, 5, 9, 10)).astype(np.float32)
    mu1, mu2 = _mus(rng, (4, 2, 5))
    prec = "highest" if dtype == "float32" else "default"
    ref = jfe.fourier_unit_grads(_j(xb, dtype), _j(err, dtype), _j(mu1, dtype), _j(mu2, dtype),
                                 9, precision=HIGHEST if prec == "highest" else
                                 jax.lax.Precision.DEFAULT, phase_tables=tables)
    got = tfe.fourier_unit_grads(_t(xb, dtype), _t(err, dtype), _t(mu1, dtype), _t(mu2, dtype),
                                 9, precision=prec, phase_tables=tables)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 4, 2, 5)
    _close(got, ref, "unit grads", dtype, rtol=1e-4, floor=1e-5)
    if dtype == "float32":  # the dense table + tap-gather gives the same
        dense = txe.tap_gather(txe.grad_tables(_t(xb), _t(err), 9), _t(mu1), _t(mu2), 9, True)
        _close(got, dense, "vs dense", rtol=1e-4, floor=1e-5)


# ---- K1/K2: the fused kernel's twin against the Pallas kernel ------------

def _kernel_inputs(seed, n, s, f, g, hw, dtype, with_dx):
    """The fused call's operands as `fourier_unit_grads_fused2` makes them."""
    rng = np.random.default_rng(seed)
    p1, p2, rb = jfe.plan_bins(hw, hw, 9)
    b, span = p1 * rb, 5
    xs = rng.standard_normal((b, 3, 2 * n, s)).astype(np.float32)
    es = rng.standard_normal((b, 2 * n, f)).astype(np.float32)
    mu1, mu2 = _mus(rng, (s, g, f))
    t1 = jfe._phase_table_host(p1, p1, span)
    w2 = np.full(rb, 2.0)
    w2[0] = 1.0
    if p2 % 2 == 0:
        w2[-1] = 1.0
    t2 = jfe._phase_table_host(p2, rb, span) * (np.concatenate([w2, w2])[:, None] / (p1 * p2))
    a1 = np.transpose(np.asarray(jfe._phase_onehot(jnp.asarray(mu1), span, True)), (0, 2, 1, 3))
    a2 = np.transpose(np.asarray(jfe._phase_onehot(jnp.asarray(mu2), span, True)), (0, 2, 1, 3))
    extra = {}
    if with_dx:
        extra = dict(esb=rng.standard_normal((b, 2 * n, f)).astype(np.float32),
                     wg=(rng.standard_normal((g, s, f)) * 0.1).astype(np.float32))
    ops = dict(xs=xs, es=es, t1=t1.astype(np.float32), t2=t2.astype(np.float32), a1=a1, a2=a2,
               **extra)
    kw = dict(n_img=n, p1b=p1, rbb=rb)
    jax_ops = {k: _j(v, dtype if k in ("xs", "es", "esb") else "float32")
               for k, v in ops.items()}
    port_ops = {k: _t(v, dtype if k in ("xs", "es", "esb") else "float32")
                for k, v in ops.items()}
    return jax_ops, port_ops, kw


@pytest.mark.parametrize("with_dx", [False, True])
@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("hw", [9, 13])
def test_fused_kernel_twin_matches_pallas(hw, g, with_dx):
    jops, tops, kw = _kernel_inputs(hw + g, 2, 8, 16, g, hw, "float32", with_dx)
    ref = jax.jit(lambda o: fused_spectral_grads_call(**o, **kw, interpret=True))(jops)
    before = (tfb.fused_spectral_grads.launches_k1, tfb.fused_spectral_grads.launches_k2)
    got = tfb.fused_spectral_grads(**tops, **kw)
    assert (tfb.fused_spectral_grads.launches_k1,
            tfb.fused_spectral_grads.launches_k2) == before  # the CPU computes the twin
    if not with_dx:
        got, ref = (got,), (ref,)
    assert got[0].dtype == torch.float32 and tuple(got[0].shape) == (3, 8, g, 16)
    for g_, r_, name in zip(got, ref, ("grads", "dx spectra")):
        _close(g_, r_, name, rtol=1e-4, floor=1e-5)


@pytest.mark.parametrize("with_dx", [False, True])
def test_fused_kernel_twin_bf16_matches_pallas(with_dx):
    jops, tops, kw = _kernel_inputs(3, 2, 8, 8, 2, 9, "bfloat16", with_dx)
    ref = jax.jit(lambda o: fused_spectral_grads_call(**o, **kw, interpret=True))(jops)
    got = tfb.fused_spectral_grads_plain(**tops, **kw)
    if not with_dx:
        got, ref = (got,), (ref,)
    for g_, r_, name in zip(got, ref, ("grads", "dx spectra")):
        assert g_.dtype == torch.float32
        _close(g_, r_, name, "bfloat16")


def test_onehot_taps_rebuild_the_onehot():
    mu = np.random.default_rng(15).choice(np.concatenate([EDGE_MU, [-4.5, 4.5]]), (2, 3, 4))
    for interp in (True, False):
        a = tfe._phase_onehot(_t(mu), 5, interp)
        j, lo, hi = tfb._taps(a, torch.float32)
        rebuilt = torch.zeros_like(a)
        rebuilt.scatter_add_(0, j.long()[None], lo[None])
        rebuilt.scatter_add_(0, j.long()[None] + 1, hi[None])
        torch.testing.assert_close(rebuilt, a, rtol=0, atol=0)


@pytest.mark.parametrize("h,s,f,g", [(27, 96, 256, 2), (13, 256, 384, 2), (13, 384, 384, 2),
                                     (13, 384, 256, 2), (13, 384, 384, 4)])
def test_alexnet_shapes_have_a_plan(h, s, f, g):
    p1, _, rb = tfe.plan_bins(h, h, 9)
    for m in (3, 4):
        plan = tfb.spectral_plan(m=m, g=g, nj=12, p1b=p1, rbb=rb)
        assert plan is not None and plan["smem"] <= 227 * 1024


def test_plan_names_what_the_kernel_cannot_take():
    assert tfb.spectral_plan(m=5, g=2, nj=12, p1b=17, rbb=9) is None
    assert tfb.spectral_plan(m=3, g=6, nj=12, p1b=17, rbb=9) is None
    assert tfb.spectral_plan(m=3, g=2, nj=70, p1b=17, rbb=9) is None


@pytest.mark.parametrize("with_dx", [False, True])
def test_unit_grads_fused2_match_jax(with_dx):
    rng = np.random.default_rng(16)
    n, s, g, f, h, w = 2, 8, 2, 8, 9, 11
    xb = rng.standard_normal((3, n, s, h, w)).astype(np.float32)
    err = rng.standard_normal((n, f, h, w)).astype(np.float32)
    mu1, mu2 = _mus(rng, (s, g, f))
    extra_j, extra_t = {}, {}
    if with_dx:
        eb = rng.standard_normal((n, f, h, w)).astype(np.float32)
        wu = (rng.standard_normal((s, g, f)) * 0.1).astype(np.float32)
        extra_j = dict(err_blur=_j(eb), w_units=_j(wu))
        extra_t = dict(err_blur=_t(eb), w_units=_t(wu))
    ref = jax.jit(lambda *a, **k: jfe.fourier_unit_grads_fused2(*a, 9, precision=HIGHEST, **k))(
        _j(xb), _j(err), _j(mu1), _j(mu2), **extra_j)
    got = tfe.fourier_unit_grads_fused2(_t(xb), _t(err), _t(mu1), _t(mu2), 9, **extra_t)
    if not with_dx:
        got, ref = (got,), (ref,)
    for g_, r_, name in zip(got, ref, ("grads", "dx")):
        _close(g_, r_, name, rtol=1e-4, floor=1e-5)
    # the fused and unfused forms agree in the port
    unfused = tfe.fourier_unit_grads(_t(xb), _t(err), _t(mu1), _t(mu2), 9, precision="highest")
    _close(got[0], unfused, "fused vs unfused", rtol=1e-4, floor=1e-5)
    if with_dx:
        p1, p2, rb = tfe.plan_bins(h, w, 9)
        phi = tfe.build_phi(_t(wu), _t(mu1), _t(mu2), p1, p2, rb, True, 5)
        _close(got[1], tfe.fourier_input_grad(_t(eb), phi, 9), "dx vs phi", rtol=1e-4,
               floor=1e-5)
