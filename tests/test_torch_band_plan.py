"""K4's and K5's launch plans at every kernel tier, on the CPU.

K4 and K5 stage, per group of 64 input channels, a window of the flat
padded plane (row stride Wp = W + ks - 1) that their QB = 272 output
positions reach through the taps. At ks 33 and 65 no window of all ks tap
rows fits the 227 KB of shared memory at the AlexNet-DAU planes, so the
plan cuts the taps into bands of kyb tap rows, one window per (group,
band). `kernels/forward.py::aggregate_plan` and `fused_plan` mirror the
kernels' plans (the card tests hold them equal to the libraries' own);
`_aggregate_in_bands` sums K4's operands window by window as the kernel
does, in float64, and must equal the JAX Pallas kernel (interpret mode) and
the plain twin within 2e-5 * max|reference|, the bound of
tests/test_torch_aggregate_operands.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dau_convnet_tpu.kernels.forward import aggregate_forward_pallas
from dau_convnet_tpu.utils.tiers import KERNEL_TIERS
from dau_convnet_tpu_torch.kernels import forward as tkf

BOUND = 2e-5
SMEM = 227 * 1024
# (S, F, H=W) of the AlexNet-DAU DAU layers; the dx pass swaps S and F
LAYERS = {"conv2": (96, 256, 27), "conv3": (256, 384, 13), "conv4": (384, 384, 13),
          "conv5": (384, 256, 13)}
PLANS = {"K4": lambda h, ks: tkf.aggregate_plan(h, h, ks),
         "K5 f32": lambda h, ks: tkf.fused_plan(h, h, ks, 9, torch.float32),
         "K5 bf16": lambda h, ks: tkf.fused_plan(h, h, ks, 9, torch.bfloat16)}


def _covers_the_taps(p, ks):
    """Every tap row in exactly one band, and each window holds every pixel
    its tile's positions read through its band's taps."""
    kyb, bands, wp = p["kyb"], p["bands"], p["wp"]
    assert (bands - 1) * kyb < ks <= bands * kyb
    for t in range(p["tiles"]):
        off = t * 272 % wp
        assert off + 271 + (kyb - 1) * wp + ks - 1 < p["rows"] * wp


@pytest.mark.parametrize("way", ["forward", "dx"])
@pytest.mark.parametrize("layer", sorted(LAYERS))
@pytest.mark.parametrize("ks", KERNEL_TIERS)
@pytest.mark.parametrize("kernel", sorted(PLANS))
def test_every_tier_has_a_plan_at_the_alexnet_planes(kernel, ks, layer, way):
    # the dx pass runs the same kernels at the same planes, S and F swapped
    s, f, h = LAYERS[layer]
    if way == "dx":
        s, f = f, s
    p = PLANS[kernel](h, ks)
    assert 0 < p["smem"] <= SMEM and p["nxb"] in (1, 2)
    assert p["rows"] <= 256 and p["wp"] <= 256
    _covers_the_taps(p, ks)


@pytest.mark.parametrize("h", [13, 27])
@pytest.mark.parametrize("ks", [1, 3, 5, 7, 9, 11, 13, 15, 17])
@pytest.mark.parametrize("kernel", sorted(PLANS))
def test_one_band_up_to_ks17(kernel, ks, h):
    # kyb = ks is the plan of the one-window kernels: every ks <= 17 launch
    # keeps its geometry
    p = PLANS[kernel](h, ks)
    assert (p["kyb"], p["bands"]) == (ks, 1)
    wp = h + ks - 1
    rows = max((t * 272 % wp + 272 + (ks - 1) * (wp + 1) + wp - 1) // wp
               for t in range(p["tiles"]))
    assert p["rows"] == rows


def test_k4_plan_at_ks17_is_the_one_measured_on_the_card():
    # `dau_aggregate_smem_bytes(H, H, 17)` as the one-window K4 library
    # returned it on an NVIDIA H100 (planes 3, 7, 13 and 27): one band
    # keeps that plan
    card = {3: 205952, 7: 221056, 13: 150528, 27: 182400}
    assert {h: tkf.aggregate_plan(h, h, 17)["smem"] for h in card} == card


def test_tiers_past_17_take_bands():
    for h in (13, 27):
        for ks in (33, 65):
            for kernel, plan in PLANS.items():
                p = plan(h, ks)
                assert p["bands"] > 1 and p["kyb"] < ks, (kernel, h, ks)
                # the tallest band that fits: one row more does not
                assert p["kyb"] == max(k for k in range(1, ks + 1)
                                       if _fits(kernel, h, ks, k)), (kernel, h, ks)


def _fits(kernel, h, ks, kyb):
    w = tkf._window_plan(h, h, ks, kyb)
    if kernel == "K4":
        return w["rows"] <= 256 and tkf._smem_for(1, w["window"]) <= SMEM
    p = PLANS[kernel](h, ks)
    # K5's smallest buffers at this band: one window, one raw buffer of one chunk
    vr = max(min(t * 272 // w["wp"] - ks // 2 + b * kyb + w["rows"], h)
             - max(t * 272 // w["wp"] - ks // 2 + b * kyb, 0)
             for t in range(w["tiles"]) for b in range(w["bands"]))
    in_bytes = 4 if kernel == "K5 f32" else 2
    raw = (vr + 8) * p["rwp"] * 8 * in_bytes
    filt = -(-9 * 15 * 4 // 16) * 16
    return tkf._smem_for(1, w["window"]) + tkf._round128(raw) + filt + 32 <= SMEM


def _todays_plan(kernel, h, w, ks):
    """The one-strip plan of the kernels before column strips: the tallest
    band over the whole plane (row stride W + ks - 1) whose buffers fit."""
    for kyb in range(ks, 0, -1):
        p = tkf._window_plan(h, w, ks, kyb)
        if kernel == "K4":
            if p["rows"] > 256:
                continue
            for nxb in (2, 1):
                if tkf._smem_for(nxb, p["window"]) <= SMEM:
                    return dict(p, nxb=nxb, smem=tkf._smem_for(nxb, p["window"]))
            continue
        in_bytes = 4 if kernel == "K5 f32" else 2
        vr = max(min(t * 272 // p["wp"] - ks // 2 + b * kyb + p["rows"], h)
                 - max(t * 272 // p["wp"] - ks // 2 + b * kyb, 0)
                 for t in range(p["tiles"]) for b in range(p["bands"]))
        if vr + 8 > 256:
            continue
        rwp = (w + 8) | 1
        raw = (vr + 8) * rwp * 8 * in_bytes
        filt = -(-9 * 15 * 4 // 16) * 16
        for nxb in (2, 1):
            for nbuf in (2, 1):
                for rc in (8, 4, 2, 1):
                    smem = tkf._smem_for(nxb, p["window"]) + nbuf * tkf._round128(rc * raw) \
                        + filt + 32
                    if smem <= SMEM:
                        return dict(p, nxb=nxb, smem=smem, vr=vr, rr=vr + 8, rwp=rwp, rc=rc,
                                    nbuf=nbuf)
    return None


def _plan(kernel, h, w, ks):
    if kernel == "K4":
        return tkf.aggregate_plan(h, w, ks)
    return tkf.fused_plan(h, w, ks, 9, torch.float32 if kernel == "K5 f32" else torch.bfloat16)


@pytest.mark.parametrize("ks", [3, 9, 33])
@pytest.mark.parametrize("w", [300, 600, 1000])
@pytest.mark.parametrize("kernel", sorted(PLANS))
def test_a_row_wider_than_a_tma_box_takes_column_strips(kernel, w, ks):
    # the widest strip whose staged row fits a TMA box side: K4's padded
    # row wc + ks - 1, K5's raw row of the columns its window reaches and
    # the blur's halo, odd; the strips cover the row, the last one may be
    # narrower
    h = 4
    p = _plan(kernel, h, w, ks)
    wc, strips = p["wc"], p["strips"]
    assert strips > 1 and (strips - 1) * wc < w <= strips * wc
    assert p["wp"] == wc + ks - 1 and 0 < p["smem"] <= SMEM and p["rows"] <= 256
    if kernel == "K4":
        assert p["wp"] <= 256 < p["wp"] + 1  # the widest that fits
    else:
        assert p["rwp"] == (min(w, p["wp"]) + 8) | 1 <= 256
        assert (p["wp"] + 1 + 8) | 1 > 256
    assert p == dict(tkf._window_plan(h, wc, ks, p["kyb"]), **{
        k: v for k, v in p.items() if k not in ("wp", "tiles", "rows", "kyb", "bands", "window")})
    _covers_the_taps(p, ks)


@pytest.mark.parametrize("ks", [3, 9, 33])
@pytest.mark.parametrize("w", [13, 27, 200, 224, 248])
@pytest.mark.parametrize("kernel", sorted(PLANS))
def test_a_row_that_fits_keeps_one_strip_and_todays_plan(kernel, w, ks):
    # W + ks - 1 <= 256 (K4) or (W + kb - 1) | 1 <= 256 (K5): one strip,
    # wc = W, and every key of the plan before strips
    fits = w + ks - 1 <= 256 if kernel == "K4" else (w + 8) | 1 <= 256
    if not fits:
        assert _plan(kernel, 13, w, ks)["strips"] > 1
        return
    for h in (13, 27):
        p = _plan(kernel, h, w, ks)
        assert (p["wc"], p["strips"]) == (w, 1)
        assert p == dict(_todays_plan(kernel, h, w, ks), wc=w, strips=1)


@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_a_kernel_wider_than_a_tma_box_has_no_plan(kernel):
    # no strip of one column fits: a padded row of ks = 257 taps (K4), or a
    # raw row of ks + kb - 1 = 257 pixels (K5), exceeds a TMA box side
    with pytest.raises(ValueError, match="does not fit: a .* row of .* TMA box"):
        if kernel == "K4":
            tkf.aggregate_plan(4, 300, 257)
        else:
            tkf.fused_plan(4, 300, 249, 9, torch.bfloat16)


def test_k5_narrows_its_strips_where_the_widest_buffers_do_not_fit():
    # f32 at 24x300, ks 9: the widest strip's raw buffers (239 columns) fit
    # at no band; the plan takes the widest narrower strip that fits
    p = tkf.fused_plan(24, 300, 9, 9, torch.float32)
    assert tkf._fused_plan_at(24, 300, 239, 9, 9, 4) is None
    assert p["wc"] < 239 and tkf._fused_plan_at(24, 300, p["wc"] + 1, 9, 9, 4) is None
    assert p["strips"] == -(-300 // p["wc"]) and p["smem"] <= SMEM


def test_plans_refuse_a_grid_past_its_range():
    # the grid's y extent is a strip's tiles times the strips
    with pytest.raises(ValueError, match="grid"):
        tkf.aggregate_plan(20000, 1000, 3)
    with pytest.raises(ValueError, match="grid"):
        tkf.fused_plan(4, 300, 3, 9, torch.float32, n=70000)


def test_wrappers_refuse_without_a_plan_before_any_launch():
    # on a CPU tensor the wrappers compute the twin; the plan is the card's
    # refusal, so only the mirror is asked here
    with pytest.raises(ValueError, match="ks=4"):
        tkf.aggregate_plan(13, 13, 4)
    with pytest.raises(ValueError, match="kb=4"):
        tkf.fused_plan(13, 13, 9, 4, torch.float32)


def _aggregate_in_bands(xb_t, kern_t, f, h, w, ks, plan):
    """What K4 sums over the prepared operands, strip by strip and window by
    window as its plan stages them, in float64. A strip of wc columns from
    output column c0 (one strip of all W where the plan has no 'wc') is a
    flat plane of row stride Wp = wc + ks - 1 whose padded rows start at
    image column c0 - ks/2; per tile of 272 of its flat positions and band
    b, the plan's rows of it from padded row r0 + b*kyb (zeros outside the
    image, as TMA reads them), and per tap of the band that window read
    (ky - b*kyb)*Wp + kx pixels on from the tile's first position. Each
    strip stores its first min(wc, W - c0) columns."""
    cc, n = xb_t.shape[:2]
    s8 = cc * 8
    x = xb_t.double().reshape(cc, n, h, w, 8).permute(1, 0, 4, 2, 3).reshape(n, s8, h, w)
    c, wp, rows, kyb = ks // 2, plan["wp"], plan["rows"], plan["kyb"]
    wc = plan.get("wc", w)
    strips = -(-w // wc)
    # room for every window: the last tile's last band reads past the plane,
    # the last strip past the row
    deep = plan["tiles"] * 272 // wp + plan["bands"] * kyb + rows + 1
    padded = F.pad(x, (c, strips * wc + wp - w - c, c, deep - h - c))
    kern = kern_t.double()[:, :f]
    y = torch.zeros((n, f, h, w), dtype=torch.float64)
    for st in range(strips):
        c0 = st * wc
        plane = padded[..., c0:c0 + wp]  # image columns c0 - c .. c0 - c + wp - 1
        out = torch.zeros((n, f, plan["tiles"] * 272), dtype=torch.float64)
        for t in range(plan["tiles"]):
            q0 = t * 272
            r0, off = q0 // wp, q0 % wp
            for b in range(plan["bands"]):
                win = plane[:, :, r0 + b * kyb:r0 + b * kyb + rows].reshape(n, s8, rows * wp)
                for ky in range(b * kyb, min(ks, (b + 1) * kyb)):
                    for kx in range(ks):
                        at = off + (ky - b * kyb) * wp + kx
                        out[:, :, q0:q0 + 272] += torch.einsum(
                            "fs,nsq->nfq", kern[ky * ks + kx], win[:, :, at:at + 272])
        wv = min(wc, w - c0)
        y[..., c0:c0 + wv] = out[:, :, :h * wp].reshape(n, f, h, wp)[..., :wv]
    return y


def _inputs(n, s, g, f, h, w, ks, dtype, seed):
    rng = np.random.default_rng(seed)
    bound = ks // 2 - 0.01
    arrays = [rng.random((n, s, h, w)), rng.standard_normal((s, g, f)) * 0.1,
              *rng.uniform(-bound, bound, (2, s, g, f))]
    return [torch.tensor(a.astype(np.float32)).to(getattr(torch, dtype)) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_band_windows_at_ks33_match_jax_kernel(dtype):
    # 13x13 at ks 33: K4's plan takes two bands (25 and 8 tap rows)
    n, s, g, f, h, ks = 1, 5, 2, 7, 13, 33
    x, w, mu1, mu2 = _inputs(n, s, g, f, h, h, ks, dtype, seed=4)
    plan = tkf.aggregate_plan(h, h, ks)
    assert plan["bands"] == 2
    jdt = getattr(jnp, dtype)
    ref = jax.jit(lambda *a: aggregate_forward_pallas(*a, ks, interpret=True))(
        jnp.asarray(x.float().numpy()), *(jnp.asarray(t.float().numpy(), jdt)
                                          for t in (w, mu1, mu2)))
    xb_t, kern_t = tkf.aggregate_forward_operands(x, w, mu1, mu2, ks)
    got = _aggregate_in_bands(xb_t, kern_t, f, h, h, ks, plan).numpy()
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= BOUND * float(np.abs(ref).max())


@pytest.mark.parametrize("kyb", [1, 2, 4, 9])
def test_band_windows_of_any_height_sum_every_tap_once(kyb):
    # thin bands of a 27-column plane over three tiles: bands whose windows
    # reach past the image on both sides, and a last band shorter than kyb
    n, s, g, f, h, w, ks = 1, 9, 2, 5, 11, 27, 9
    x, wt, mu1, mu2 = _inputs(n, s, g, f, h, w, ks, "bfloat16", seed=kyb)
    plan = dict(tkf._window_plan(h, w, ks, kyb))
    xb_t, kern_t = tkf.aggregate_forward_operands(x, wt, mu1, mu2, ks)
    got = _aggregate_in_bands(xb_t, kern_t, f, h, w, ks, plan)
    want = tkf.aggregate_forward_plain(x.float(), wt, mu1, mu2, ks).double()
    assert float((got - want).abs().max()) <= BOUND * float(want.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ks", [3, 9])
def test_strip_windows_of_a_300_column_plane_match_jax_kernel(ks, dtype):
    # W = 300: a padded row wider than a TMA box, two strips (254 + 46
    # columns at ks 3, 248 + 52 at ks 9); the JAX Pallas kernel takes the
    # plane as it is
    n, s, g, f, h, w = 1, 5, 2, 7, 4, 300
    x, wt, mu1, mu2 = _inputs(n, s, g, f, h, w, ks, dtype, seed=ks)
    plan = tkf.aggregate_plan(h, w, ks)
    assert plan["strips"] == 2 and plan["wc"] == 257 - ks
    jdt = getattr(jnp, dtype)
    ref = jax.jit(lambda *a: aggregate_forward_pallas(*a, ks, interpret=True))(
        jnp.asarray(x.float().numpy()), *(jnp.asarray(t.float().numpy(), jdt)
                                          for t in (wt, mu1, mu2)))
    xb_t, kern_t = tkf.aggregate_forward_operands(x, wt, mu1, mu2, ks)
    got = _aggregate_in_bands(xb_t, kern_t, f, h, w, ks, plan).numpy()
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= BOUND * float(np.abs(ref).max())


@pytest.mark.parametrize("wc,kyb", [(7, 9), (16, 4), (23, 2), (40, 9)])
def test_strips_of_any_width_sum_every_pixel_once(wc, kyb):
    # strips of a 40-column plane: a last strip narrower than wc (40 = 5*7
    # + 5, 2*16 + 8, 23 + 17), strips whose windows reach past the image on
    # both sides, and bands; one strip (wc = 40) is the plane itself
    n, s, g, f, h, w, ks = 1, 9, 2, 5, 11, 40, 9
    x, wt, mu1, mu2 = _inputs(n, s, g, f, h, w, ks, "bfloat16", seed=wc)
    plan = dict(tkf._window_plan(h, wc, ks, kyb), wc=wc)
    xb_t, kern_t = tkf.aggregate_forward_operands(x, wt, mu1, mu2, ks)
    got = _aggregate_in_bands(xb_t, kern_t, f, h, w, ks, plan)
    want = tkf.aggregate_forward_plain(x.float(), wt, mu1, mu2, ks).double()
    assert float((got - want).abs().max()) <= BOUND * float(want.abs().max())


@pytest.mark.parametrize("f,csize", [(3, 1), (64, 1), (96, 2), (128, 2), (192, 1), (256, 2),
                                     (384, 2), (512, 2), (65, 2), (200, 2)])
def test_fused_cluster_size_pairs_f_tiles(f, csize):
    # K5 runs pairs of 64-wide F tiles as a 2-block cluster; an odd tile
    # count (the other models' F = 64 and 192, and dx into 3 channels)
    # takes the branch without one, which `launches_clusterless` counts
    assert tkf.fused_cluster_size(f) == csize
    assert -(-f // 64) % 2 == (csize == 1)
    assert all(tkf.fused_plan(hw, hw, 9, kb, torch.bfloat16) is not None
               for hw in (32, 16, 8, 56, 28, 14, 7) for kb in (9, 17))
