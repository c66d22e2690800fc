"""Port vs JAX: the factored spectral gather (K8), on the CPU.

The twin `fused_factored_grads_plain` against the JAX Pallas kernel
`fused_spectral_grads_call(gather="factored")` in interpret mode, as
tests/test_pallas.py runs it; K8's plan and row ranges, and its sums emulated
in float64 from the operands K1's wrapper prepares (`_factored_from_operands`)
against the same Pallas kernel; `fourier_unit_grads_fused2(gather="factored")`;
and the op's Fourier backward with fused_bwd='on', fused_gather='factored'
(and fused_dx='on') against `jax.vjp` of the JAX op. Shapes stay small (HW 9
or 13, S <= 16, F <= 24): JAX's interpret mode needs S and F multiples of 8.
Tolerances: f32, rtol 1e-4 with an absolute floor of 1e-5 * max|reference|
(f32 sums over bins, taps and table exponents in another order); bf16,
2e-2 * max|reference| as in tests/test_torch_fourier.py (the twin rounds T,
P and Q to bf16 where the Pallas kernel does; a sum on the other side of a
rounding boundary moves one term by a bf16 ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dau_convnet_tpu.kernels.fused_bwd import fused_spectral_grads_call
from dau_convnet_tpu.ops import dau_conv as jdc
from dau_convnet_tpu.ops import fourier_engine as jfe
from dau_convnet_tpu_torch.kernels import fused_bwd as tfb
from dau_convnet_tpu_torch.models import AlexNetDAU
from dau_convnet_tpu_torch.nn import DAUConv2d
from dau_convnet_tpu_torch.ops import dau_conv as tdc
from dau_convnet_tpu_torch.ops import fourier_engine as tfe

EDGE_MU = np.array([-3.99, 3.99, -3.0, 0.0, 2.0, 3.0, -0.5, -2.25, -1.75, 1.5],
                   np.float32)
HIGHEST = jax.lax.Precision.HIGHEST
GRAD_NAMES = ("dx", "dw", "dmu1", "dmu2", "dsigma")


def _t(a, dtype="float32"):
    return torch.tensor(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(np.asarray(a, np.float32), getattr(jnp, dtype))


def _close(got, ref, name, dtype="float32", rtol=1e-4, floor=1e-5):
    got = np.asarray(got.detach().float().numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, f"{name}: {got.shape} vs {ref.shape}"
    if dtype == "bfloat16":
        rtol, floor = 0.0, 2e-2
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=floor * float(np.abs(ref).max()),
                               err_msg=name)


def _mus(rng, shape):
    return rng.choice(EDGE_MU, shape), rng.uniform(-3.99, 3.99, shape).astype(np.float32)


def _kernel_inputs(seed, n, s, f, g, hw, dtype, with_dx):
    """The fused call's operands as `fourier_unit_grads_fused2` makes them."""
    rng = np.random.default_rng(seed)
    p1, p2, rb = jfe.plan_bins(hw, hw, 9)
    b, span = p1 * rb, 5
    mu1, mu2 = _mus(rng, (s, g, f))
    w2 = np.full(rb, 2.0)
    w2[0] = 1.0
    if p2 % 2 == 0:
        w2[-1] = 1.0
    t2 = jfe._phase_table_host(p2, rb, span) * (np.concatenate([w2, w2])[:, None] / (p1 * p2))
    ops = dict(xs=rng.standard_normal((b, 3, 2 * n, s)), es=rng.standard_normal((b, 2 * n, f)),
               t1=jfe._phase_table_host(p1, p1, span), t2=t2,
               a1=np.transpose(np.asarray(jfe._phase_onehot(jnp.asarray(mu1), span, True)),
                               (0, 2, 1, 3)),
               a2=np.transpose(np.asarray(jfe._phase_onehot(jnp.asarray(mu2), span, True)),
                               (0, 2, 1, 3)))
    if with_dx:
        ops.update(esb=rng.standard_normal((b, 2 * n, f)),
                   wg=rng.standard_normal((g, s, f)) * 0.1)
    spectra = ("xs", "es", "esb")
    jax_ops = {k: _j(v, dtype if k in spectra else "float32") for k, v in ops.items()}
    port_ops = {k: _t(v, dtype if k in spectra else "float32") for k, v in ops.items()}
    return jax_ops, port_ops, dict(n_img=n, p1b=p1, rbb=rb)


def _pallas_factored(jops, kw):
    return jax.jit(lambda o: fused_spectral_grads_call(**o, **kw, interpret=True,
                                                       gather="factored"))(jops)


@pytest.mark.parametrize("with_dx", [False, True])
@pytest.mark.parametrize("hw,g", [(9, 4), (13, 2)])
def test_factored_twin_matches_pallas(hw, g, with_dx):
    jops, tops, kw = _kernel_inputs(hw + g, 2, 8, 16, g, hw, "float32", with_dx)
    ref = _pallas_factored(jops, kw)
    before = (tfb.fused_spectral_grads.launches_k8, tfb.fused_spectral_grads.launches_k8_dx)
    got = tfb.fused_spectral_grads(**tops, **kw, gather="factored")
    assert (tfb.fused_spectral_grads.launches_k8,
            tfb.fused_spectral_grads.launches_k8_dx) == before  # the CPU computes the twin
    if not with_dx:
        got, ref = (got,), (ref,)
    assert got[0].dtype == torch.float32 and tuple(got[0].shape) == (3, 8, g, 16)
    for g_, r_, name in zip(got, ref, ("grads", "dx spectra")):
        _close(g_, r_, name)
    # the same function as the phi gather's twin
    phi = tfb.fused_spectral_grads_plain(**tops, **kw)
    _close(got[0], phi[0] if with_dx else phi, "factored vs phi")


def test_factored_twin_bf16_matches_pallas():
    jops, tops, kw = _kernel_inputs(5, 2, 8, 16, 2, 13, "bfloat16", True)
    ref = _pallas_factored(jops, kw)
    got = tfb.fused_factored_grads_plain(**tops, **kw)
    for g_, r_, name in zip(got, ref, ("grads", "dx spectra")):
        assert g_.dtype == torch.float32
        _close(g_, r_, name, "bfloat16")


@pytest.mark.parametrize("h,s,f,g", [(27, 96, 256, 2), (13, 256, 384, 2), (13, 384, 384, 2),
                                     (13, 384, 256, 2), (13, 384, 384, 4)])
def test_alexnet_shapes_have_a_factored_plan(h, s, f, g):
    # conv2 (496 bins) included: under the factored gate it has no unfused
    # escape unless the plan refuses it. K8 is K1's kernel under the
    # factored gather: K1's layout (two ring stages of the X tile, the ES
    # tile and the bin's two table rows; the units' weights and taps) at
    # K8's f tile, no wider than K1's, whose P/Q sums take the registers K1
    # gives its wider tile; the table rows are streamed, so the bins do not
    # enter
    p1, _, rb = tfe.plan_bins(h, h, 9)
    for m in (3, 4):
        plan = tfb.factored_plan(m=m, g=g, nj=12, p1b=p1, rbb=rb)
        assert plan is not None and plan["smem"] <= 227 * 1024
        ft = tfb._k8_tile_f(m, g)
        assert ft in (4, 8, 16) and ft <= tfb._k1_tile_f(m, g)
        assert plan == tfb._tc_plan(m, g, 12, ft)
        assert tfb.factored_plan(m=m, g=g, nj=12, p1b=600, rbb=300) == plan
    # the AlexNet-DAU path (M = 3, G = 2): wgmma m64n16, two ring stages of
    # 24,576 bytes of X, 4,096 of ES and 512 of table rows; 40,960 bytes of
    # unit weights and taps
    if g == 2:
        assert tfb._k8_tile_f(3, 2) == 8
        assert tfb.factored_plan(m=3, g=2, nj=12, p1b=p1, rbb=rb)["smem"] == (
            1024 + 2 * (24576 + 4096 + 512) + 40960 + 32)


def test_factored_plan_names_what_the_kernel_cannot_take():
    assert tfb.factored_plan(m=5, g=2, nj=12, p1b=17, rbb=9) is None
    assert tfb.factored_plan(m=3, g=6, nj=12, p1b=17, rbb=9) is None
    assert tfb.factored_plan(m=3, g=2, nj=70, p1b=17, rbb=9) is None
    # every instance the kernel is built for has a plan
    for m in (3, 4):
        for g in (1, 2, 3, 4):
            assert tfb.factored_plan(m=m, g=g, nj=64, p1b=17, rbb=9) is not None
    with pytest.raises(ValueError, match="gather"):
        _, tops, kw = _kernel_inputs(0, 1, 8, 8, 2, 9, "float32", False)
        tfb.fused_spectral_grads(**tops, **kw, gather="rows")


@pytest.mark.parametrize("h", [9, 13, 27])
def test_factored_row_ranges_hold_whole_rows_and_every_bin_once(h):
    p1, _, rb = tfe.plan_bins(h, h, 9)
    for r in range(1, p1 + 1):
        ranges = tfb.row_ranges(p1, rb, r)
        assert 1 <= len(ranges) <= r
        assert ranges[0][0] == 0 and ranges[-1][1] == p1 * rb
        assert all(a[1] == c[0] for a, c in zip(ranges, ranges[1:]))
        assert all(lo < hi and lo % rb == 0 and hi % rb == 0 for lo, hi in ranges)


def _factored_from_operands(t, kw, ranges):
    """What K8 sums, in float64, over the operands K1's wrapper prepares
    (`t`: the port's tensors in the spectra's dtype): per bin, T = X^T . ES
    rounded to the dtype; P and Q at each unit's taps j, j+1 into t2 from
    the bin's t2 quad; at each k1 row's end P and Q rounded to the dtype and
    folded with the row's t1 quad at the unit's taps into t1; the partial
    sums per range of rows, and their sum. (M, S, G, F)."""
    xs, es, t1, t2, a1, a2 = (t[k] for k in ("xs", "es", "t1", "t2", "a1", "a2"))
    cdt = xs.dtype
    m, s, f = xs.shape[1], xs.shape[3], es.shape[2]
    rb = kw["rbb"]
    xs_t, es_t = tfb.spectral_operands(xs, es, kw["n_img"])
    e = es_t.double().transpose(1, 2).reshape(es_t.shape[0], es_t.shape[2], -1)[..., :2 * f]
    tt = torch.einsum("bmks,bkc->bmsc", xs_t.double(), e)[:, :, :s]
    tre, tim = (v.float().to(cdt).double() for v in (tt[..., 0::2], tt[..., 1::2]))
    ty = tfb.spectral_table_quads(t1.to(cdt).float(), kw["p1b"]).double()
    tx = tfb.spectral_table_quads(t2.to(cdt).float(), rb).double()
    j1, a0, a1w = (v.double() if v.is_floating_point() else v.long()
                   for v in tfb._taps(a1, cdt))
    j2, b0, b1w = (v.double() if v.is_floating_point() else v.long()
                   for v in tfb._taps(a2, cdt))

    def rnd(v):
        return v.float().to(cdt).double()

    total = 0
    for begin, end in ranges:
        acc = torch.zeros((m,) + tuple(j1.shape), dtype=torch.float64)  # (M, G, S, F)
        pq = torch.zeros((4, m) + tuple(j1.shape), dtype=torch.float64)
        for k in range(begin, end):
            x = tx[k % rb][j1]                                           # (G, S, F, 4)
            tr, ti = tre[k][:, None], tim[k][:, None]                    # (M, 1, S, F)
            pq[0] += x[..., 0] * tr - x[..., 2] * ti
            pq[1] += x[..., 1] * tr - x[..., 3] * ti
            pq[2] += x[..., 2] * tr + x[..., 0] * ti
            pq[3] += x[..., 3] * tr + x[..., 1] * ti
            if k % rb == rb - 1:
                y = ty[k // rb][j2]
                pyre = y[..., 1] * b1w + y[..., 0] * b0
                pyim = y[..., 3] * b1w + y[..., 2] * b0
                pw = rnd(pq[1]) * a1w + rnd(pq[0]) * a0
                qw = rnd(pq[3]) * a1w + rnd(pq[2]) * a0
                acc += pyre * pw - pyim * qw
                pq.zero_()
        total = total + acc
    return total.transpose(1, 2)


# (N, S, F, G, H=W, row ranges): 9x9's 6 x 5 bins and 13x13's 17 x 9 bins
# in one or several ranges of rows, G = 1, 2 and 4 (K8's three tile
# widths at M = 3), a ragged N
FACTORED_CASES = {
    "n2_g2_9px_one_range": (2, 8, 16, 2, 9, 1),
    "n3_g4_9px_rows": (3, 8, 16, 4, 9, 4),
    "n2_g1_13px_rows": (2, 16, 8, 1, 13, 6),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FACTORED_CASES))
def test_factored_sums_from_the_operands_match_pallas(name, dtype):
    # K8's algebra on K1's operands against the Pallas factored kernel, at
    # the bounds of the card tests (1e-4 / 1e-2 * max|reference|)
    n, s, f, g, hw, r = FACTORED_CASES[name]
    jops, tops, kw = _kernel_inputs(len(name), n, s, f, g, hw, dtype, False)
    ref = np.asarray(_pallas_factored(jops, kw), np.float64)
    ranges = tfb.row_ranges(kw["p1b"], kw["rbb"], r)
    got = _factored_from_operands(tops, kw, ranges).numpy()
    assert got.shape == ref.shape == (3, s, g, f)
    bound = 1e-4 if dtype == "float32" else 1e-2
    err = float(np.abs(got - ref).max())
    assert err <= bound * float(np.abs(ref).max()), f"{name} {dtype}: max|err| {err}"


def test_unit_grads_fused2_factored_match_jax():
    rng = np.random.default_rng(17)
    n, s, g, f, h, w = 2, 8, 2, 16, 9, 11
    xb = rng.standard_normal((3, n, s, h, w)).astype(np.float32)
    err = rng.standard_normal((n, f, h, w)).astype(np.float32)
    mu1, mu2 = _mus(rng, (s, g, f))
    eb = rng.standard_normal((n, f, h, w)).astype(np.float32)
    wu = (rng.standard_normal((s, g, f)) * 0.1).astype(np.float32)
    ref = jax.jit(lambda *a: jfe.fourier_unit_grads_fused2(
        *a[:4], 9, precision=HIGHEST, gather="factored", err_blur=a[4], w_units=a[5]))(
        *(_j(a) for a in (xb, err, mu1, mu2, eb, wu)))
    got = tfe.fourier_unit_grads_fused2(_t(xb), _t(err), _t(mu1), _t(mu2), 9, err_blur=_t(eb),
                                        w_units=_t(wu), gather="factored")
    for g_, r_, name in zip(got, ref, ("grads", "dx")):
        _close(g_, r_, name)
    unfused = tfe.fourier_unit_grads(_t(xb), _t(err), _t(mu1), _t(mu2), 9, precision="highest")
    _close(got[0], unfused, "factored vs unfused")
    # without the dx operands: the grads alone
    _close(tfe.fourier_unit_grads_fused2(_t(xb), _t(err), _t(mu1), _t(mu2), 9,
                                         gather="factored"), ref[0], "grads without dx")


def _op_inputs(shape, bound, seed):
    n, s, g, f, h, w = shape
    rng = np.random.default_rng(seed)
    x = rng.random((n, s, h, w)).astype(np.float32)
    wt = (rng.standard_normal((1, s, g, f)) * 0.1).astype(np.float32)
    mu1, mu2 = np.clip(rng.choice(EDGE_MU, (2, 1, s, g, f)), -bound, bound)
    sig = np.full((1, s, g, f), 0.5, np.float32)
    err = rng.standard_normal((n, f, h, w)).astype(np.float32)
    return [x, wt, mu1.astype(np.float32), mu2.astype(np.float32), sig], err


OP_CASES = {
    "factored": (dict(), (2, 8, 4, 16, 9, 10)),
    "factored_dx": (dict(fused_dx="on"), (2, 8, 2, 8, 9, 9)),
    "factored_g4_dummy": (dict(fused_dx="on", number_units_ignore=1, compute_sigma_grad=False),
                          (1, 8, 4, 8, 13, 13)),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_factored_op_matches_jax_vjp(case):
    kw, shape = OP_CASES[case]
    kw = dict(kw, engine="fourier", fused_bwd="on", fused_gather="factored")
    jcfg, tcfg = jdc.DAUConvSettings(**kw), tdc.DAUConvSettings(**kw)
    args, err = _op_inputs(shape, jcfg.max_offset, seed=len(case))

    @jax.jit
    def run(*a):
        y, vjp = jax.vjp(lambda *q: jdc.dau_conv2d_op(jcfg, *q), *a[:5])
        return y, vjp(a[5])

    y_ref, g_ref = run(*[jnp.asarray(a) for a in args], jnp.asarray(err))
    ts = [_t(a).requires_grad_() for a in args]
    y = tdc.dau_conv2d_op(tcfg, *ts)
    y.backward(_t(err))
    _close(y, y_ref, f"{case} y")
    for name, t, ref in zip(GRAD_NAMES, ts, g_ref):
        if not np.any(ref):
            assert not torch.any(t.grad), f"{case} {name} must be zero"
            continue
        _close(t.grad, ref, f"{case} {name}")


def test_factored_setting_routes_to_k8(monkeypatch):
    xb = torch.zeros((3, 1, 8, 27, 27))
    on = tdc.DAUConvSettings(engine="fourier", fused_bwd="on", fused_gather="factored")
    assert tdc._fused_route(on, xb, 2, 496) == "factored"
    assert tdc._resolve_gather(tdc.DAUConvSettings(fused_gather="auto"), 496) == "phi"
    # no plan (M=5): the unfused gather, decided before the call
    assert tdc._fused_route(on, torch.zeros((5, 1, 8, 9, 9)), 2, 153) is None
    # the layer and the model carry the setting to the op, which calls K8's
    # wrapper with gather='factored' (its twin here, on the CPU)
    calls = []
    wrapper = tfb.fused_spectral_grads

    def spy(*args, **kw):
        calls.append((kw.get("gather"), kw.get("esb") is not None))
        return wrapper(*args, **kw)

    monkeypatch.setattr(tfb, "fused_spectral_grads", spy)
    model = AlexNetDAU(engine="fourier", fused_bwd="on", fused_gather="factored",
                       fused_dx="on", image_size=67, device="cpu")
    assert {model.get_submodule(f"dau_conv{i}").cfg.fused_gather for i in range(2, 6)} == {
        "factored"}
    layer = DAUConv2d(8, 16, (2, 1), 9, engine="fourier", fused_bwd="on",
                      fused_gather="factored", fused_dx="on", device="cpu",
                      generator=torch.Generator().manual_seed(0))
    x = torch.rand((2, 8, 9, 9), generator=torch.Generator().manual_seed(1)).requires_grad_()
    layer(x).sum().backward()
    assert calls == [("factored", True)]
