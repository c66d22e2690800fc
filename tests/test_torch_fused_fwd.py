"""Port vs JAX: the fused apply-phi (K3), on the CPU.

The twin `fused_apply_phi_plain` against the JAX Pallas kernel
`fused_apply_phi_call` in interpret mode, in the forward and the input
gradient's direction (contract_f: CI = F, CO = S, sin-negated tables); and
`fourier_apply_phi_fused` against the JAX package and against the port's
unfused `fourier_forward` / `fourier_input_grad`. Shapes stay small (JAX's
interpret mode needs CI and CO multiples of 8). Tolerances: f32, rtol 1e-4
with an absolute floor of 1e-5 * max|reference| (f32 sums over ci and bins
in another order); bf16, 2e-2 * max|reference| as in
tests/test_torch_fourier.py (Phi is summed over the units in bf16 in both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dau_convnet_tpu.kernels.fused_fwd import fused_apply_phi_call
from dau_convnet_tpu.ops import fourier_engine as jfe
from dau_convnet_tpu_torch.kernels import fused_fwd as tff
from dau_convnet_tpu_torch.ops import fourier_engine as tfe

EDGE_MU = np.array([-3.99, 3.99, -3.0, 0.0, 2.0, 3.0, -0.5, -2.25, -1.75, 1.5],
                   np.float32)
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


def _params(rng, s, g, f):
    w = (rng.standard_normal((s, g, f)) * 0.1).astype(np.float32)
    mu1 = rng.choice(EDGE_MU, (s, g, f))
    mu2 = rng.uniform(-3.99, 3.99, (s, g, f)).astype(np.float32)
    return w, mu1, mu2


def _kernel_inputs(seed, n, s, g, f, hw, contract_f, dtype):
    """The fused call's operands as `fourier_apply_phi_fused` makes them."""
    rng = np.random.default_rng(seed)
    p1, p2, rb = jfe.plan_bins(hw, hw, 9)
    span = 5
    w, mu1, mu2 = _params(rng, s, g, f)
    ci = f if contract_f else s
    t1 = jfe._phase_table_host(p1, p1, span)
    t2 = jfe._phase_table_host(p2, rb, span)
    if contract_f:
        t1[p1:], t2[rb:] = -t1[p1:], -t2[rb:]
    aw = np.asarray(jfe._phase_onehot(jnp.asarray(mu2), span, True)) * w[None]
    a1 = np.asarray(jfe._phase_onehot(jnp.asarray(mu1), span, True))
    order = (0, 2, 3, 1) if contract_f else (0, 2, 1, 3)
    dct, dst, _ = jfe._fused_idft_mats(p1, p2, rb, hw, hw)
    ops = dict(xs=rng.standard_normal((p1 * rb, 2 * n, ci)), t1=t1, t2=t2,
               aw=np.transpose(aw, order), a=np.transpose(a1, order), dct=dct, dst=dst)
    jax_ops = {k: _j(v, dtype if k in ("xs", "aw", "a") else "float32") for k, v in ops.items()}
    port_ops = {k: _t(v, dtype if k in ("xs", "aw", "a") else "float32")
                for k, v in ops.items()}
    return jax_ops, port_ops, dict(n_img=n, p1b=p1, rbb=rb)


@pytest.mark.parametrize("contract_f", [False, True])
@pytest.mark.parametrize("hw,g", [(9, 2), (13, 3)])
def test_fused_apply_phi_twin_matches_pallas(hw, g, contract_f):
    jops, tops, kw = _kernel_inputs(hw + g, 2, 8, g, 16, hw, contract_f, "float32")
    ref = jax.jit(lambda o: fused_apply_phi_call(**o, **kw, interpret=True))(jops)
    before = tff.fused_apply_phi.launches
    got = tff.fused_apply_phi(**tops, **kw)
    assert tff.fused_apply_phi.launches == before  # the CPU computes the twin
    co = 8 if contract_f else 16
    assert got.dtype == torch.float32 and tuple(got.shape) == (-(-hw * hw // 8) * 8, 2, co)
    _close(got, ref, "out")


@pytest.mark.parametrize("contract_f", [False, True])
def test_fused_apply_phi_twin_bf16_matches_pallas(contract_f):
    jops, tops, kw = _kernel_inputs(4, 2, 8, 2, 16, 9, contract_f, "bfloat16")
    ref = jax.jit(lambda o: fused_apply_phi_call(**o, **kw, interpret=True))(jops)
    _close(tff.fused_apply_phi_plain(**tops, **kw), ref, "out bf16", "bfloat16")


def test_fused_apply_phi_checks_its_arguments():
    _, tops, kw = _kernel_inputs(0, 1, 8, 2, 8, 9, False, "float32")
    with pytest.raises(ValueError):
        tff.fused_apply_phi(**dict(tops, xs=tops["xs"][:-1]), **kw)
    with pytest.raises(ValueError):
        tff.fused_apply_phi(**dict(tops, dct=tops["dct"][:, :-1]), **kw)


def test_fused_idft_mats_match_jax():
    p1, p2, rb = jfe.plan_bins(13, 11, 9)
    ref = jfe._fused_idft_mats(p1, p2, rb, 13, 11)
    got = tfe._fused_idft_mats(p1, p2, rb, 13, 11)
    assert got[2] == ref[2] == 144
    for g_, r_ in zip(got[:2], ref[:2]):
        _close(g_, r_, "idft mats", rtol=1e-6, floor=1e-7)


@pytest.mark.parametrize("contract_f,dtype", [(False, "float32"), (True, "float32"),
                                              (False, "bfloat16")])
def test_fourier_apply_phi_fused_matches_jax(contract_f, dtype):
    rng = np.random.default_rng(31)
    n, s, g, f, h, w_sp = 2, 8, 2, 16, 9, 10
    w, mu1, mu2 = _params(rng, s, g, f)
    x = rng.random((n, f if contract_f else s, h, w_sp)).astype(np.float32)
    ref = jax.jit(lambda *a: jfe.fourier_apply_phi_fused(
        *a, 9, precision=HIGHEST, contract_f=contract_f))(
        _j(x, dtype), _j(w, dtype), _j(mu1), _j(mu2))
    got = tfe.fourier_apply_phi_fused(_t(x, dtype), _t(w, dtype), _t(mu1), _t(mu2), 9,
                                      contract_f=contract_f)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (n, s if contract_f else f, h, w_sp)
    _close(got, ref, "apply phi fused", dtype)
    if dtype == "float32":  # the unfused chain gives the same
        if contract_f:
            p1, p2, rb = tfe.plan_bins(h, w_sp, 9)
            phi = tfe.build_phi(_t(w), _t(mu1), _t(mu2), p1, p2, rb, True, 5)
            want = tfe.fourier_input_grad(_t(x), phi, 9)
        else:
            want = tfe.fourier_forward(_t(x), _t(w), _t(mu1), _t(mu2), 9)
        _close(got, want, "fused vs unfused")
