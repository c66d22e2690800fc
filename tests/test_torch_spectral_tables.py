"""Port vs JAX: the partial inverse DFT (K7) and the position-major grad
tables it builds, on the CPU.

The twin `partial_idft_plain` against the JAX Pallas kernel `partial_idft`
in interpret mode; `fourier_grad_tables` and `tap_gather(...,
table_layout='pmsf')` against the JAX package. Tolerances: f32, rtol 1e-4
with an absolute floor of 1e-5 * max|reference| (f32 sums over the bins in
another order); bf16, 2e-2 * max|reference| as in
tests/test_torch_fourier.py (the table is rounded to bf16 once, the
matrices and spectra are bf16 in both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dau_convnet_tpu.kernels.spectral import partial_idft as jax_partial_idft
from dau_convnet_tpu.ops import fourier_engine as jfe
from dau_convnet_tpu.ops import xla_engine as jxe
from dau_convnet_tpu_torch.kernels import spectral as tsp
from dau_convnet_tpu_torch.ops import fourier_engine as tfe
from dau_convnet_tpu_torch.ops import xla_engine as txe

EDGE_MU = np.array([-3.99, 3.99, -3.0, 0.0, 2.0, 3.0, -0.5, -2.25, -1.75, 1.5],
                   np.float32)
DTYPES = ["float32", "bfloat16"]
HIGHEST = jax.lax.Precision.HIGHEST


def _t(a, dtype="float32"):
    return torch.tensor(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(np.asarray(a, np.float32), getattr(jnp, dtype))


def _np(a):
    return np.asarray(a.detach().float().numpy() if isinstance(a, torch.Tensor) else a,
                      np.float64)


def _close(got, ref, name, dtype="float32", rtol=1e-4, floor=1e-5):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, f"{name}: {got.shape} vs {ref.shape}"
    if dtype == "bfloat16":
        rtol, floor = 0.0, 2e-2
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=floor * float(np.abs(ref).max()),
                               err_msg=name)


# (H, ks, C): bins of an H x H image, ks*ks positions, C columns (not a
# multiple of 128: the Pallas side pads them, the port masks them)
IDFT_CASES = {"9px": (9, 9, 3 * 8 * 5), "13px": (13, 9, 3 * 16 * 24), "ks5": (7, 5, 200)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(IDFT_CASES))
def test_partial_idft_twin_matches_pallas(case, dtype):
    h, ks, c = IDFT_CASES[case]
    p1, p2, rb = jfe.plan_bins(h, h, ks)
    pos = np.arange(-(ks // 2), ks // 2 + 1)
    cmat, smat = (np.asarray(m) for m in jfe._idft_mats(p1, p2, rb, pos, pos, jnp.float32))
    rng = np.random.default_rng(len(case))
    tre, tim = rng.standard_normal((2, p1 * rb, c)).astype(np.float32)
    ref = jax.jit(lambda *a: jax_partial_idft(*a, out_dtype=getattr(jnp, dtype),
                                              interpret=True))(
        _j(cmat), _j(smat), _j(tre, dtype), _j(tim, dtype))
    before = tsp.partial_idft.launches
    got = tsp.partial_idft(_t(cmat), _t(smat), _t(tre, dtype), _t(tim, dtype),
                           out_dtype=getattr(torch, dtype))
    assert tsp.partial_idft.launches == before  # the CPU computes the twin
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (ks * ks, c)
    _close(got, ref, f"{case} table", dtype)


def test_partial_idft_checks_its_arguments():
    cmat = torch.zeros((91, 81))
    tre = torch.zeros((91, 10))
    with pytest.raises(ValueError):
        tsp.partial_idft(cmat, cmat, tre[:90], tre[:90])
    with pytest.raises(TypeError):
        tsp.partial_idft(cmat, cmat, tre, tre.bfloat16())
    with pytest.raises(TypeError):
        tsp.partial_idft(cmat, cmat, tre, tre, out_dtype=torch.float16)


@pytest.mark.parametrize("precision,dtype", [("highest", "float32"), ("default", "float32"),
                                             ("default", "bfloat16")])
def test_fourier_grad_tables_match_jax(precision, dtype):
    rng = np.random.default_rng(21)
    xb = rng.standard_normal((3, 2, 4, 9, 10)).astype(np.float32)
    err = rng.standard_normal((2, 5, 9, 10)).astype(np.float32)
    jp = HIGHEST if precision == "highest" else jax.lax.Precision.DEFAULT
    ref = jax.jit(lambda a, b: jfe.fourier_grad_tables(a, b, 9, jp))(_j(xb, dtype),
                                                                     _j(err, dtype))
    got = tfe.fourier_grad_tables(_t(xb, dtype), _t(err, dtype), 9, precision)
    want = torch.float32 if precision == "highest" else getattr(torch, dtype)
    assert got.dtype == want and tuple(got.shape) == (81, 3, 4, 5)
    _close(got, ref, "pmsf table", dtype)
    if dtype == "float32":  # the dense table, position-major
        dense = txe.grad_tables(_t(xb), _t(err), 9)                 # (M, S, F, ks, ks)
        _close(got, dense.permute(3, 4, 0, 1, 2).reshape(81, 3, 4, 5), "vs dense")


@pytest.mark.parametrize("dtype", DTYPES)
def test_tap_gather_pmsf_matches_jax(dtype):
    rng = np.random.default_rng(22)
    table = rng.standard_normal((81, 3, 4, 5)).astype(np.float32)
    mu1 = rng.choice(EDGE_MU, (4, 2, 5))
    mu2 = rng.uniform(-3.99, 3.99, (4, 2, 5)).astype(np.float32)
    for interp in (True, False):
        ref = jxe.tap_gather(_j(table, dtype), _j(mu1, dtype), _j(mu2, dtype), 9, interp,
                             table_layout="pmsf")
        got = txe.tap_gather(_t(table, dtype), _t(mu1, dtype), _t(mu2, dtype), 9, interp,
                             table_layout="pmsf")
        assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (3, 4, 2, 5)
        _close(got, ref, f"pmsf gather interp={interp}", dtype)
        # the same gather as the (M, S, F, ks, ks) layout
        msfp = _t(table, dtype).reshape(9, 9, 3, 4, 5).permute(2, 3, 4, 0, 1)
        _close(got, txe.tap_gather(msfp, _t(mu1, dtype), _t(mu2, dtype), 9, interp),
               "pmsf vs msfp", dtype)
    with pytest.raises(ValueError, match="table_layout"):
        txe.tap_gather(_t(table), _t(mu1), _t(mu2), 9, table_layout="psfm")


def test_pmsf_tables_give_the_unit_grads():
    rng = np.random.default_rng(23)
    xb = rng.standard_normal((3, 2, 8, 13, 13)).astype(np.float32)
    err = rng.standard_normal((2, 16, 13, 13)).astype(np.float32)
    mu1 = rng.choice(EDGE_MU, (8, 2, 16))
    mu2 = rng.uniform(-3.99, 3.99, (8, 2, 16)).astype(np.float32)
    table = tfe.fourier_grad_tables(_t(xb), _t(err), 9, "highest")
    got = txe.tap_gather(table, _t(mu1), _t(mu2), 9, table_layout="pmsf")
    want = tfe.fourier_unit_grads(_t(xb), _t(err), _t(mu1), _t(mu2), 9, precision="highest")
    _close(got, want, "pmsf gather vs spectral gather")
