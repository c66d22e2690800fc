"""Card-only tests of the port: the CUDA kernels against their plain twins,
and the layer's backward through each kernel engine against engine 'xla'.

This file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Without a CUDA device every test here skips.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dau_convnet_tpu_torch.kernels import backward as tkb
from dau_convnet_tpu_torch.kernels import forward as tk
from dau_convnet_tpu_torch.kernels import fused_bwd as tfb
from dau_convnet_tpu_torch.kernels import fused_fwd as tff
from dau_convnet_tpu_torch.kernels import spectral as tsp
from dau_convnet_tpu_torch.nn import DAUConv2d
from dau_convnet_tpu_torch.ops import fourier_engine as tfe
from dau_convnet_tpu_torch.ops import xla_engine as tke
from dau_convnet_tpu_torch.ops.gaussian import depthwise_blur, gaussian_filters

KS = 9
EDGE_MU = np.array([-3.99, 3.99, -3.0, 0.0, 2.0, 3.0, -0.5, -2.25, -1.75, 1.5],
                   np.float32)

# (N, S, G, F, H, W, edge mu, use_interpolation): odd sizes, S and F not
# multiples of the 8-channel chunk or of the 64-channel tile, and an image
# spread over several tiles of the flat plane
SHAPES = {
    "small": (2, 3, 2, 4, 10, 12, False, True),
    "edges": (1, 5, 2, 37, 9, 8, True, True),
    "no_interp": (2, 6, 2, 40, 8, 9, False, False),
    "tall": (1, 7, 2, 33, 45, 30, True, True),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(name, device, seed=0):
    n, s, g, f, h, w, edges, interp = SHAPES[name]
    rng = np.random.default_rng(seed)
    x = rng.random((n, s, h, w)).astype(np.float32)
    wt = (rng.standard_normal((s, g, f)) * 0.1).astype(np.float32)
    if edges:
        mu1, mu2 = rng.choice(EDGE_MU, (2, s, g, f))
    else:
        mu1, mu2 = rng.uniform(-3.99, 3.99, (2, s, g, f)).astype(np.float32)
    return [torch.tensor(a, device=device) for a in (x, wt, mu1, mu2)], interp


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_fused_kernel_matches_twin(cuda_device, name):
    args, interp = _case(name, cuda_device)
    filt = gaussian_filters(0.5, size=9, device=cuda_device)["w"]
    before = tk.dau_forward_fused.launches
    y = tk.dau_forward_fused(*args, filt, KS, interp)
    torch.cuda.synchronize()
    assert tk.dau_forward_fused.launches == before + 1
    want = tk.dau_forward_fused_plain(*args, filt, KS, interp)
    assert float((y - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_fused_kernel_bf16_matches_twin(cuda_device, name):
    args, interp = _case(name, cuda_device)
    args = [a.bfloat16() for a in args]
    filt = gaussian_filters(0.5, size=9, device=cuda_device)["w"]
    y = tk.dau_forward_fused(*args, filt, KS, interp)
    want = tk.dau_forward_fused_plain(args[0].float(), *args[1:], filt, KS, interp)
    assert y.dtype == torch.bfloat16
    assert float((y.float() - want).abs().max()) <= 1e-2 * float(want.abs().max())


@pytest.mark.cuda
def test_fused_kernel_rejects_strided_input(cuda_device):
    args, interp = _case("small", cuda_device)
    filt = gaussian_filters(0.5, size=9, device=cuda_device)["w"]
    with pytest.raises(ValueError):
        tk.dau_forward_fused(args[0].transpose(2, 3), *args[1:], filt, KS, interp)


@pytest.mark.cuda
@pytest.mark.parametrize("data_format", ["channels_first", "channels_last"])
def test_layer_pallas_fused_matches_xla_engine(cuda_device, data_format):
    layers = [DAUConv2d(6, 40, (2, 1), 9, strides=2, data_format=data_format,
                        engine=engine, activation=F.relu, device=cuda_device,
                        generator=torch.Generator().manual_seed(0))
              for engine in ("pallas_fused", "xla")]
    x = torch.rand((2, 6, 11, 13), generator=torch.Generator().manual_seed(1))
    if data_format == "channels_last":
        x = x.permute(0, 2, 3, 1)
    x = x.to(cuda_device)
    with torch.inference_mode():
        y_kernel, y_plain = (layer(x) for layer in layers)
    assert float((y_kernel - y_plain).abs().max()) <= 1e-4 * float(y_plain.abs().max())


# f32 bounds: the kernels and the cuDNN twins sum up to N*H*W (K6) or
# S*ks^2 (K4, K5) products in other orders; 1e-4 * max|reference| holds that
# with margin. bf16: the twin runs in f32 on the same bf16 values, and the
# K4/K5 output is rounded once to bf16 (1e-2 * max|y|); K6 writes f32.


def _tables_case(name, device, m, seed=0):
    n, s, _, f, h, w, _, _ = SHAPES[name]
    rng = np.random.default_rng(seed)
    xb = torch.tensor(rng.standard_normal((n, s * m, h, w)).astype(np.float32), device=device)
    err = torch.tensor(rng.standard_normal((n, f, h, w)).astype(np.float32), device=device)
    # the (M, N, S, H, W) view of a stacked blur, as the op hands it over
    return xb.reshape(n, s, m, h, w).permute(2, 0, 1, 3, 4), err


@pytest.mark.cuda
@pytest.mark.parametrize("m", [3, 4])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_grad_tables_kernel_matches_twin(cuda_device, name, m):
    xb, err = _tables_case(name, cuda_device, m)
    for dtype in (torch.float32, torch.bfloat16):
        a, b = xb.to(dtype), err.to(dtype)
        before = tkb.grad_tables.launches
        got = tkb.grad_tables(a, b, KS)
        torch.cuda.synchronize()
        assert tkb.grad_tables.launches == before + 1
        want = tkb.grad_tables_plain(a, b, KS)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), dtype


# K6 at the edges of the tensor-core kernel's tiles: (N, S, F, H, W, ks) with
# M*S (M = 3) and F not multiples of 8 or of the 32-plane / 128-channel
# tile, a 27-wide image (two 16-column stages per row), ks in {3, 9, 17}
TABLES_TC = {"ks3_ragged": (2, 3, 37, 13, 13, 3), "ks9_27px": (2, 5, 130, 27, 27, 9),
             "ks17": (1, 11, 20, 9, 12, 17)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(TABLES_TC))
def test_grad_tables_kernel_edges_match_twin(cuda_device, name, dtype):
    n, s, f, h, w, ks = TABLES_TC[name]
    gen = torch.Generator().manual_seed(7)
    xb = torch.randn((n, s * 3, h, w), generator=gen).reshape(n, s, 3, h, w)
    err = torch.randn((n, f, h, w), generator=gen)
    a = xb.permute(2, 0, 1, 3, 4).to(cuda_device, dtype)  # the op's strided view
    b = err.to(cuda_device, dtype)
    before = tkb.grad_tables.launches
    got = tkb.grad_tables(a, b, ks)
    torch.cuda.synchronize()
    assert tkb.grad_tables.launches == before + 1
    want = tkb.grad_tables_plain(a, b, ks)
    assert got.dtype == torch.float32 and got.shape == want.shape == (3, s, f, ks, ks)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ks", [19, 33])
def test_grad_tables_kernel_past_ks17_matches_twin(cuda_device, ks, dtype):
    # kernel sizes the wrapper refused before it checked the kernel's own
    # limits: a grid 19*7 and 33*11 blocks deep, taps reaching past the image
    gen = torch.Generator().manual_seed(ks)
    xb = torch.randn((1, 5 * 3, 13, 11), generator=gen).reshape(1, 5, 3, 13, 11)
    err = torch.randn((1, 20, 13, 11), generator=gen)
    a = xb.permute(2, 0, 1, 3, 4).to(cuda_device, dtype)
    b = err.to(cuda_device, dtype)
    before = tkb.grad_tables.launches
    got = tkb.grad_tables(a, b, ks)
    torch.cuda.synchronize()
    assert tkb.grad_tables.launches == before + 1
    want = tkb.grad_tables_plain(a, b, ks)
    assert got.shape == want.shape == (3, 5, 20, ks, ks)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
def test_pallas_step_past_ks17_runs_k6(cuda_device):
    # one AlexNet-DAU SGD step on the 'pallas' engine at max_kernel_size=19
    # (synthesized ks 19, which K6's wrapper refused before): 4 K6 launches,
    # a finite loss and finite gradients
    from dau_convnet_tpu_torch.models import AlexNetDAU
    from dau_convnet_tpu_torch.parallel.train import make_train_step

    model = AlexNetDAU(num_classes=10, max_kernel_size=19, engine="pallas", image_size=67,
                       device=cuda_device, generator=torch.Generator().manual_seed(0))
    assert model.dau_conv3.cfg.synth_kernel_size == 19
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-4))
    x = torch.rand((2, 3, 67, 67), generator=torch.Generator().manual_seed(1)).to(cuda_device)
    before = tkb.grad_tables.launches
    loss = step(x, torch.tensor([1, 7], device=cuda_device))
    torch.cuda.synchronize()
    assert tkb.grad_tables.launches == before + 4
    assert bool(torch.isfinite(loss))
    for name, p in model.named_parameters():
        assert p.grad is None or bool(torch.isfinite(p.grad).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("engine,kernel,counter", [
    ("pallas", tk.aggregate_forward, "launches"),
    ("pallas_fused", tk.dau_forward_fused, "launches")])
def test_alexnet_step_at_ks33_runs_k4_and_k5(cuda_device, engine, kernel, counter):
    # one AlexNet-DAU SGD step at max_kernel_size=33 (synthesized ks 33, the
    # tier whose window takes bands of tap rows): 8 K4 or K5 launches (the
    # forward and the dx pass of four layers) and 4 K6, a finite loss and
    # finite gradients
    from dau_convnet_tpu_torch.models import AlexNetDAU
    from dau_convnet_tpu_torch.parallel.train import make_train_step

    model = AlexNetDAU(num_classes=10, max_kernel_size=33, engine=engine, image_size=67,
                       device=cuda_device, generator=torch.Generator().manual_seed(0))
    assert model.dau_conv2.cfg.synth_kernel_size == 33
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-4))
    x = torch.rand((2, 3, 67, 67), generator=torch.Generator().manual_seed(1)).to(cuda_device)
    before = (getattr(kernel, counter), tkb.grad_tables.launches)
    loss = step(x, torch.tensor([1, 7], device=cuda_device))
    torch.cuda.synchronize()
    assert (getattr(kernel, counter), tkb.grad_tables.launches) == (before[0] + 8,
                                                                     before[1] + 4)
    assert bool(torch.isfinite(loss))
    for name, p in model.named_parameters():
        assert p.grad is None or bool(torch.isfinite(p.grad).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_aggregate_kernel_matches_twin(cuda_device, name):
    args, interp = _case(name, cuda_device)
    before = tk.aggregate_forward.launches
    y = tk.aggregate_forward(*args, KS, interp)
    torch.cuda.synchronize()
    assert tk.aggregate_forward.launches == before + 1
    want = tk.aggregate_forward_plain(*args, KS, interp)
    assert float((y - want).abs().max()) <= 1e-4 * float(want.abs().max())
    args16 = [a.bfloat16() for a in args]
    y16 = tk.aggregate_forward(*args16, KS, interp)
    want16 = tk.aggregate_forward_plain(args16[0].float(), *args16[1:], KS, interp)
    assert y16.dtype == torch.bfloat16
    assert float((y16.float() - want16).abs().max()) <= 1e-2 * float(want16.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_fused_kernel_at_transposed_shape_with_error_filter(cuda_device, name):
    # the dx pass: S<->F transposed (strided) params, negated offsets, the
    # mirrored blur filter, on an error with F channels
    (x, w, mu1, mu2), interp = _case(name, cuda_device)
    n, _, h, wd = x.shape
    err = torch.rand((n, w.shape[-1], h, wd), generator=torch.Generator().manual_seed(3))
    err = err.to(cuda_device)
    params = (w.permute(2, 1, 0), -mu1.permute(2, 1, 0), -mu2.permute(2, 1, 0))
    filt = gaussian_filters(0.5, size=9, device=cuda_device)["error"]
    for dtype, bound in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        e = err.to(dtype)
        p = [t.to(dtype) for t in params]
        y = tk.dau_forward_fused(e, *p, filt, KS, interp)
        want = tk.dau_forward_fused_plain(e.float(), *p, filt, KS, interp)
        assert y.shape == (n, x.shape[1], h, wd)
        assert float((y.float() - want).abs().max()) <= bound * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["pallas", "pallas_fused"])
def test_layer_backward_matches_xla_engine(cuda_device, engine):
    grads = {}
    for eng in (engine, "xla"):
        layer = DAUConv2d(6, 40, (2, 1), 9, strides=2, engine=eng, activation=F.relu,
                          dau_sigma_trainable=True, device=cuda_device,
                          generator=torch.Generator().manual_seed(0))
        x = torch.rand((2, 6, 11, 13), generator=torch.Generator().manual_seed(1))
        x = x.to(cuda_device).requires_grad_()
        err = torch.randn((2, 40, 6, 7), generator=torch.Generator().manual_seed(2))
        (layer(x) * err.to(cuda_device)).sum().backward()
        grads[eng] = {"x": x.grad, **{k: p.grad for k, p in layer.named_parameters()}}
    for name, want in grads["xla"].items():
        got = grads[engine][name]
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), name


# K1/K2: (M, N, S, G, F, H): S and F not multiples of the 32 tile, N above
# the 16 (K1) and 32 (dx) images staged per pass, every instantiated G
SPECTRAL = {
    "small": (3, 2, 8, 2, 16, 9),
    "ragged": (4, 5, 37, 1, 41, 13),
    "many_images": (3, 35, 33, 3, 20, 9),
    "g4": (3, 4, 40, 4, 24, 13),
    "wide": (4, 2, 64, 2, 96, 27),
}


def _spectral_case(name, device, dtype, seed=0):
    m, n, s, g, f, h = SPECTRAL[name] if isinstance(name, str) else name
    gen = torch.Generator().manual_seed(seed)
    p1, p2, rb = tfe.plan_bins(h, h, KS)
    span = KS // 2 + 1
    b = p1 * rb
    xs = torch.randn((b, m, 2 * n, s), generator=gen).to(device, dtype)
    es = torch.randn((b, 2 * n, f), generator=gen).to(device, dtype)
    esb = torch.randn((b, 2 * n, f), generator=gen).to(device, dtype)
    wg = (torch.randn((g, s, f), generator=gen) * 0.1).to(device, dtype)
    mu1, mu2 = (torch.rand((2, s, g, f), generator=gen) * 7.98 - 3.99).to(device)
    a1 = tfe._phase_onehot(mu1, span, True).permute(0, 2, 1, 3)
    a2 = tfe._phase_onehot(mu2, span, True).permute(0, 2, 1, 3)
    t1 = tfe._phase_table(p1, p1, span, torch.float32, device)
    t2 = tfe._phase_table(p2, rb, span, torch.float32, device, coef_p1=p1)
    return (xs, es, t1, t2, a1, a2), dict(n_img=n, p1b=p1, rbb=rb), (esb, wg)


# bounds: f32 sums in another order, 1e-4 * max|reference|; bf16, the
# cross-spectra are rounded to bf16 before the gather in both, and a sum
# that lands on the other side of a rounding boundary moves one entry by a
# bf16 ulp: 1e-2 * max|reference|


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("name", sorted(SPECTRAL))
def test_spectral_grads_kernel_matches_twin(cuda_device, name, dtype, bound):
    args, kw, _ = _spectral_case(name, cuda_device, dtype)
    before = tfb.fused_spectral_grads.launches_k1
    got = tfb.fused_spectral_grads(*args, **kw)
    torch.cuda.synchronize()
    assert tfb.fused_spectral_grads.launches_k1 == before + 1
    want = tfb.fused_spectral_grads_plain(*args, **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got - want).abs().max()) <= bound * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("name", sorted(SPECTRAL))
def test_spectral_grads_dx_kernel_matches_twin(cuda_device, name, dtype, bound):
    args, kw, (esb, wg) = _spectral_case(name, cuda_device, dtype, seed=1)
    before = (tfb.fused_spectral_grads.launches_k1, tfb.fused_spectral_grads.launches_k2)
    got = tfb.fused_spectral_grads(*args, **kw, esb=esb, wg=wg)
    torch.cuda.synchronize()
    assert (tfb.fused_spectral_grads.launches_k1,
            tfb.fused_spectral_grads.launches_k2) == (before[0], before[1] + 1)
    want = tfb.fused_spectral_grads_plain(*args, **kw, esb=esb, wg=wg)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert float((g - w).abs().max()) <= bound * float(w.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spectral_grads_kernel_is_deterministic(cuda_device, dtype):
    # each output is summed by one block per bin range, in one order, and the
    # ranges by the wrapper: no atomics
    args, kw, _ = _spectral_case("wide", cuda_device, dtype, seed=3)
    first = tfb.fused_spectral_grads(*args, **kw)
    second = tfb.fused_spectral_grads(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 3, 4])
@pytest.mark.parametrize("m", [3, 4])
def test_spectral_grads_every_instance_matches_twin(cuda_device, m, g):
    # every (M, G) instance (16 f per block up to M*G = 8, else 8), S and F
    # over ragged tiles, N = 3 (6 of the 16 rows of a k16 step)
    for dtype, bound in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        args, kw, _ = _spectral_case((m, 3, 70, g, 40, 9), cuda_device, dtype, seed=m * g)
        before = tfb.fused_spectral_grads.launches_k1
        got = tfb.fused_spectral_grads(*args, **kw)
        torch.cuda.synchronize()
        assert tfb.fused_spectral_grads.launches_k1 == before + 1
        want = tfb.fused_spectral_grads_plain(*args, **kw)
        assert got.shape == want.shape == (m, 70, g, 40)
        assert float((got - want).abs().max()) <= bound * float(want.abs().max()), dtype


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["ragged", "wide"])
def test_spectral_operand_kernel_matches_the_torch_operands(cuda_device, name, dtype):
    # K1's operand kernel builds, bit for bit, what `spectral_operands`,
    # `spectral_table_quads` and `_taps` build in torch (the CPU tests hold
    # those against the JAX kernel); "ragged" pads S = 37 to 40
    (xs, es, t1, t2, a1, a2), kw, _ = _spectral_case(name, cuda_device, dtype, seed=4)
    n, p1, rb = kw["n_img"], kw["p1b"], kw["rbb"]
    lib = tfb._library("dau_spectral_grads")
    xs_t, es_t, tq, idx, wts = tfb._spectral_operands_cuda(lib, xs, es, a1, a2, t1, t2, n, p1,
                                                           rb)
    torch.cuda.synchronize()
    want_x, want_e = tfb.spectral_operands(xs, es, n)
    assert torch.equal(xs_t, want_x) and torch.equal(es_t, want_e)
    quads = [tfb.spectral_table_quads(t.to(dtype).float(), rows) for t, rows in ((t1, p1), (t2, rb))]
    assert torch.equal(tq, torch.cat(quads))
    (j1, a1lo, a1hi), (j2, a2lo, a2hi) = tfb._taps(a1, dtype), tfb._taps(a2, dtype)
    assert torch.equal(idx, torch.stack([j1, j2]))
    assert torch.equal(wts, torch.stack([a1lo, a1hi, a2lo, a2hi]))


# K2's dx kernel on the tensor cores: the four AlexNet-DAU layer shapes
# (M, N, S, G, F, H) at N = 4, and ragged cases: S not a multiple of 64, F
# off the 16-f step, N from 1 to 48 (2N past one 64-column tile), every G
DX_LAYERS = {"conv2": (3, 4, 96, 2, 256, 27), "conv3": (3, 4, 256, 2, 384, 13),
             "conv4": (3, 4, 384, 2, 384, 13), "conv5": (3, 4, 384, 2, 256, 13)}
DX_RAGGED = {"n1_g1": (3, 1, 70, 1, 40, 9), "n4_g2": (3, 4, 37, 2, 24, 13),
             "n32_g3": (3, 32, 100, 3, 48, 9), "n48_g4": (4, 48, 70, 4, 33, 9)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("name", sorted(DX_LAYERS) + sorted(DX_RAGGED))
def test_dx_kernel_matches_the_plain_contraction(cuda_device, name, dtype, bound):
    case = DX_LAYERS.get(name) or DX_RAGGED[name]
    args, kw, (esb, wg) = _spectral_case(case, cuda_device, dtype, seed=len(name))
    got = tfb.fused_spectral_grads(*args, **kw, esb=esb, wg=wg)[1]
    torch.cuda.synchronize()
    # `_dx_spectra_plain` on the twin's phase factors (its own dx)
    want = tfb.fused_spectral_grads_plain(*args, **kw, esb=esb, wg=wg)[1]
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got - want).abs().max()) <= bound * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("gather", ["phi", "factored"])
def test_dx_kernel_is_bitwise_repeatable(cuda_device, gather):
    # each dX element is summed by one block in one order: no atomics
    args, kw, (esb, wg) = _spectral_case(DX_LAYERS["conv3"], cuda_device, torch.bfloat16, seed=7)
    first = tfb.fused_spectral_grads(*args, **kw, esb=esb, wg=wg, gather=gather)[1]
    second = tfb.fused_spectral_grads(*args, **kw, esb=esb, wg=wg, gather=gather)[1]
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["n4_g2", "n48_g4"])
def test_dx_operands_of_the_operand_kernel_match_the_torch_operands(cuda_device, name, dtype):
    # the operand kernel builds the dx kernel's B and tap records, bit for
    # bit, as `dx_operands` does in torch (the CPU tests hold those against
    # the JAX kernel); esb and wg strided, as the op hands them over
    (xs, es, t1, t2, a1, a2), kw, (esb, wg) = _spectral_case(DX_RAGGED[name], cuda_device,
                                                             dtype, seed=5)
    esb = esb.permute(1, 2, 0).contiguous().permute(2, 0, 1)
    wg = wg.permute(1, 0, 2).contiguous().permute(1, 0, 2)
    n, p1, rb = kw["n_img"], kw["p1b"], kw["rbb"]
    lib = tfb._library("dau_spectral_grads")
    *_, eb_t, rec = tfb._spectral_operands_cuda(lib, xs, es, a1, a2, t1, t2, n, p1, rb, esb, wg)
    torch.cuda.synchronize()
    want_eb, want_rec = tfb.dx_operands(esb, wg, a1, a2, n)
    assert torch.equal(eb_t, want_eb) and torch.equal(rec, want_rec)


@pytest.mark.cuda
def test_spectral_grads_kernel_raises_without_a_plan(cuda_device):
    args, kw, _ = _spectral_case("small", cuda_device, torch.float32)
    xs = torch.cat([args[0]] * 2, dim=1)[:, :5].contiguous()  # M = 5
    with pytest.raises(tfb.FusedPlanError):
        tfb.fused_spectral_grads(xs, *args[1:], **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("fused_dx", ["off", "on"])
def test_layer_fourier_fused_backward_matches_unfused(cuda_device, fused_dx):
    grads = {}
    for fused in ("on", "off"):
        layer = DAUConv2d(16, 40, (2, 1), 9, engine="fourier", fused_bwd=fused,
                          fused_dx=fused_dx, activation=F.relu, dau_sigma_trainable=True,
                          device=cuda_device, generator=torch.Generator().manual_seed(0))
        x = torch.rand((3, 16, 13, 13), generator=torch.Generator().manual_seed(1))
        x = x.to(cuda_device).requires_grad_()
        err = torch.randn((3, 40, 13, 13), generator=torch.Generator().manual_seed(2))
        before = tfb.fused_spectral_grads.launches_k1 + tfb.fused_spectral_grads.launches_k2
        (layer(x) * err.to(cuda_device)).sum().backward()
        after = tfb.fused_spectral_grads.launches_k1 + tfb.fused_spectral_grads.launches_k2
        assert after - before == (1 if fused == "on" else 0)
        grads[fused] = {"x": x.grad, **{k: p.grad for k, p in layer.named_parameters()}}
    for name, want in grads["off"].items():
        got = grads["on"][name]
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), name


@pytest.mark.cuda
@pytest.mark.parametrize("fused_dx,counter", [("off", "launches_k1"), ("on", "launches_k2")])
def test_fused_backward_span_counts_the_counters_launches(cuda_device, fused_dx, counter):
    """A fused DAU backward's `dau.unit_grads` span: route 'phi', and its K1
    (or K2) delta equals the launch counter's, on the autograd engine's
    device thread (its `dau.backward` takes the open step as its parent)."""
    from dau_convnet_tpu_torch.utils import tracing

    layer = DAUConv2d(16, 40, (2, 1), 9, engine="fourier", fused_bwd="on", fused_dx=fused_dx,
                      device=cuda_device, generator=torch.Generator().manual_seed(0))
    layer.trace_name = "conv"
    x = torch.rand((3, 16, 13, 13), generator=torch.Generator().manual_seed(1))
    x = x.to(cuda_device).requires_grad_()
    tracing.clear()
    try:
        before = getattr(tfb.fused_spectral_grads, counter)
        with tracing.record(), tracing.span("train.step", adopt=True) as step:
            layer(x).sum().backward()
        torch.cuda.synchronize()
        delta = getattr(tfb.fused_spectral_grads, counter) - before
        recs = tracing.spans()
    finally:
        tracing.clear()
    (grads,) = [s for s in recs if s.name == "dau.unit_grads"]
    (bwd,) = [s for s in recs if s.name == "dau.backward"]
    assert delta == 1
    assert grads.attrs["route"] == "phi" and grads.attrs["dx_fused"] == (fused_dx == "on")
    assert grads.attrs[counter[len("launches_"):]] == delta
    assert grads.attrs["k8"] == grads.attrs["k6"] == 0
    assert bwd.attrs["layer"] == "conv" and bwd.parent == step.id
    assert grads.parent == bwd.id


# K8, the factored gather: K1's shapes and bounds (the twin rounds T, P and Q
# to bf16 where the kernel does)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("name", sorted(SPECTRAL))
def test_factored_grads_kernel_matches_twin(cuda_device, name, dtype, bound):
    args, kw, (esb, wg) = _spectral_case(name, cuda_device, dtype, seed=2)
    counts = tfb.fused_spectral_grads
    before = (counts.launches_k8, counts.launches_k8_dx, counts.launches_k1)
    got = tfb.fused_spectral_grads(*args, **kw, gather="factored")
    got_dx = tfb.fused_spectral_grads(*args, **kw, esb=esb, wg=wg, gather="factored")
    torch.cuda.synchronize()
    assert (counts.launches_k8, counts.launches_k8_dx, counts.launches_k1) == (
        before[0] + 1, before[1] + 1, before[2])
    want = tfb.fused_factored_grads_plain(*args, **kw, esb=esb, wg=wg)
    for g, w in zip((got, *got_dx), (want[0], *want)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert float((g - w).abs().max()) <= bound * float(w.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 3, 4])
@pytest.mark.parametrize("m", [3, 4])
def test_factored_grads_every_instance_matches_twin(cuda_device, m, g):
    # every (M, G) instance of K8 (16, 8 or 4 f per warpgroup, where its P/Q
    # sums fit the registers), S = 96 as at conv2 and F over ragged tiles,
    # N = 3, at 13x13's 17 rows of 9 bins; without and with the dx operands
    for dtype, bound in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        args, kw, (esb, wg) = _spectral_case((m, 3, 96, g, 41, 13), cuda_device, dtype,
                                             seed=m * g)
        counts = tfb.fused_spectral_grads
        before = (counts.launches_k8, counts.launches_k8_dx)
        got = tfb.fused_spectral_grads(*args, **kw, gather="factored")
        got_dx = tfb.fused_spectral_grads(*args, **kw, esb=esb, wg=wg, gather="factored")
        torch.cuda.synchronize()
        assert (counts.launches_k8, counts.launches_k8_dx) == (before[0] + 1, before[1] + 1)
        want = tfb.fused_factored_grads_plain(*args, **kw, esb=esb, wg=wg)
        assert got.shape == want[0].shape == (m, 96, g, 41)
        for g_, w_ in zip((got, *got_dx), (want[0], *want)):
            assert float((g_ - w_).abs().max()) <= bound * float(w_.abs().max()), dtype


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_factored_grads_kernel_is_deterministic(cuda_device, dtype):
    # each output is summed by one block per range of rows, in one order,
    # and the ranges by the wrapper: no atomics
    args, kw, _ = _spectral_case("wide", cuda_device, dtype, seed=4)
    first = tfb.fused_spectral_grads(*args, **kw, gather="factored")
    second = tfb.fused_spectral_grads(*args, **kw, gather="factored")
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [9, 13, 27])
def test_factored_plan_and_ranges_equal_the_kernels(cuda_device, h):
    # the CPU plan against the library's shared memory, and the kernel's
    # ranges: whole k1 rows, within 1 .. P1
    p1, _, rb = tfe.plan_bins(h, h, KS)
    lib = tfb._library("dau_spectral_grads")
    for m in (3, 4):
        for g in (1, 2, 3, 4):
            plan = tfb.factored_plan(m=m, g=g, nj=12, p1b=p1, rbb=rb)
            assert lib.dau_factored_grads_smem_bytes(m, g, p1, rb, 12) == plan["smem"]
            for code in (0, 1):
                r = lib.dau_factored_grads_ranges(code, m, g, p1 * rb, 96, 256, p1, rb, 12)
                assert 1 <= r <= p1
                assert len(tfb.row_ranges(p1, rb, r)) == r


@pytest.mark.cuda
@pytest.mark.parametrize("fused_dx", ["off", "on"])
def test_layer_factored_backward_matches_unfused(cuda_device, fused_dx):
    grads = {}
    counts = tfb.fused_spectral_grads
    for gather, fused in (("factored", "auto"), ("phi", "off")):
        layer = DAUConv2d(16, 40, (2, 1), 9, engine="fourier", fused_bwd=fused,
                          fused_gather=gather, fused_dx=fused_dx, activation=F.relu,
                          dau_sigma_trainable=True, device=cuda_device,
                          generator=torch.Generator().manual_seed(0))
        x = torch.rand((3, 16, 27, 27), generator=torch.Generator().manual_seed(1))
        x = x.to(cuda_device).requires_grad_()
        err = torch.randn((3, 40, 27, 27), generator=torch.Generator().manual_seed(2))
        before = counts.launches_k8 + counts.launches_k8_dx
        (layer(x) * err.to(cuda_device)).sum().backward()
        after = counts.launches_k8 + counts.launches_k8_dx
        assert after - before == (1 if gather == "factored" else 0)  # 496 bins: no gate
        grads[gather] = {"x": x.grad, **{k: p.grad for k, p in layer.named_parameters()}}
    for name, want in grads["phi"].items():
        got = grads["factored"][name]
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), name


@pytest.mark.cuda
def test_kernels_raise_without_a_plan_and_compute_no_twin(cuda_device, monkeypatch):
    def no_twin(*args, **kw):
        raise AssertionError("the twin ran on a CUDA tensor")

    monkeypatch.setattr(tfb, "fused_factored_grads_plain", no_twin)
    monkeypatch.setattr(tfb, "fused_spectral_grads_plain", no_twin)
    monkeypatch.setattr(tff, "fused_apply_phi_plain", no_twin)
    args, kw, _ = _spectral_case("small", cuda_device, torch.float32)
    xs = torch.cat([args[0]] * 2, dim=1)[:, :5].contiguous()  # M = 5
    for gather in ("phi", "factored"):
        with pytest.raises(tfb.FusedPlanError):
            tfb.fused_spectral_grads(xs, *args[1:], **kw, gather=gather)


# K7, the partial iDFT: (H, ks, C) with C not a multiple of 128 and P
# (ks*ks) not of 32; the (B, P) matrices of fourier_grad_tables
IDFT = {"9px": (9, 9, 3 * 37 * 41), "27px": (27, 9, 1000), "ks17": (13, 17, 300)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                                    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("name", sorted(IDFT))
def test_partial_idft_kernel_matches_twin(cuda_device, name, dtypes):
    h, ks, c = IDFT[name]
    p1, p2, rb = tfe.plan_bins(h, h, ks)
    pos = range(-(ks // 2), ks // 2 + 1)
    cmat, smat = tfe._idft_mats(p1, p2, rb, pos, pos, torch.float32, cuda_device)
    gen = torch.Generator().manual_seed(3)
    tre, tim = torch.randn((2, p1 * rb, c), generator=gen).to(cuda_device, dtypes[0])
    before = tsp.partial_idft.launches
    got = tsp.partial_idft(cmat, smat, tre, tim, out_dtype=dtypes[1])
    torch.cuda.synchronize()
    assert tsp.partial_idft.launches == before + 1
    want = tsp.partial_idft_plain(cmat, smat, tre, tim, out_dtype=torch.float32)
    bound = 1e-2 if dtypes[1] == torch.bfloat16 else 1e-4
    assert got.dtype == dtypes[1] and got.shape == (ks * ks, c)
    assert float((got.float() - want).abs().max()) <= bound * float(want.abs().max())


# K7 at the edges of the tensor-core kernel's tiles: (kind, H, C) with P =
# 81 (fourier_grad_tables), 169 and 729 (the fused apply-phi's closing
# stage); C not a multiple of the 256-column tile (123 not of 8 either); B =
# 153 bins at H = 13, a K tail of 25 past the 64-bin stages
IDFT_TC = {"p81": ("tables", 13, 1000), "p169": ("fused", 13, 123), "p729": ("fused", 27, 600)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                                    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("name", sorted(IDFT_TC))
def test_partial_idft_kernel_edges_match_twin(cuda_device, name, dtypes):
    kind, h, c = IDFT_TC[name]
    p1, p2, rb = tfe.plan_bins(h, h, KS)
    if kind == "tables":
        pos = range(-(KS // 2), KS // 2 + 1)
        cmat, smat = tfe._idft_mats(p1, p2, rb, pos, pos, torch.float32, cuda_device)
    else:
        dct, dst, _ = tfe._fused_idft_mats(p1, p2, rb, h, h, cuda_device)
        cmat, smat = dct.t(), dst.t()
    gen = torch.Generator().manual_seed(11)
    tre, tim = torch.randn((2, p1 * rb, c), generator=gen).to(cuda_device, dtypes[0])
    before = tsp.partial_idft.launches
    got = tsp.partial_idft(cmat, smat, tre, tim, out_dtype=dtypes[1])
    torch.cuda.synchronize()
    assert tsp.partial_idft.launches == before + 1
    want = tsp.partial_idft_plain(cmat, smat, tre, tim, out_dtype=torch.float32)
    bound = 1e-2 if dtypes[1] == torch.bfloat16 else 1e-4
    assert got.dtype == dtypes[1] and got.shape == (cmat.shape[1], c)
    assert float((got.float() - want).abs().max()) <= bound * float(want.abs().max())


@pytest.mark.cuda
def test_separable_spectra_to_image_matches_the_dense_product_on_the_card(cuda_device):
    """The Fourier engine's partial inverse rDFT at ResNet-18's 56x56 plane,
    N*C = 8,192 (N = 128, C = 64), in f32 with TF32 off: the two separable
    stages against the dense (P1*rb) x (H*W) product with `_idft_mats`."""
    h = w = 56
    p1, p2, rb = tfe.plan_bins(h, w, KS)
    n, c = 128, 64
    gen = torch.Generator().manual_seed(13)
    yre, yim = torch.randn((2, p1 * rb, n, c), generator=gen).to(cuda_device)
    assert not torch.backends.cuda.matmul.allow_tf32
    got = tfe._spectra_to_image(yre, yim, p1, p2, rb, h, w)
    torch.cuda.synchronize()
    assert not torch.backends.cuda.matmul.allow_tf32
    tables = tfe._idft_stage_mats(p1, p2, rb, h, w, torch.float32, cuda_device)
    assert all(t.dtype == torch.float32 for t in tables)
    cmat, smat = tfe._idft_mats(p1, p2, rb, range(h), range(w), torch.float32, cuda_device)
    flat = (p1 * rb, n * c)
    want = (yre.reshape(flat).t() @ cmat - yim.reshape(flat).t() @ smat).reshape(n, c, h, w)
    assert got.dtype == torch.float32 and got.shape == (n, c, h, w) and got.is_contiguous()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
def test_pmsf_tables_give_the_unit_grads_on_the_card(cuda_device):
    gen = torch.Generator().manual_seed(4)
    xb = torch.randn((3, 2, 8, 13, 13), generator=gen).to(cuda_device)
    err = torch.randn((2, 16, 13, 13), generator=gen).to(cuda_device)
    mu1, mu2 = (torch.rand((2, 8, 2, 16), generator=gen) * 7.98 - 3.99).to(cuda_device)
    table = tfe.fourier_grad_tables(xb, err, KS, "highest")
    got = tke.tap_gather(table, mu1, mu2, KS, table_layout="pmsf")
    want = tfe.fourier_unit_grads(xb, err, mu1, mu2, KS, precision="highest")
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


# K3, the fused apply-phi: (N, S, G, F, H) with 2N past one 64-column tile,
# CI off the 16-ci step and CO off the 64-co tile; both directions


def _apply_phi_case(n, s, g, f, h, contract_f, device, dtype, seed=0, ks=KS):
    gen = torch.Generator().manual_seed(seed)
    p1, p2, rb = tfe.plan_bins(h, h, ks)
    span = ks // 2 + 1
    ci = f if contract_f else s
    w = torch.randn((s, g, f), generator=gen) * 0.1
    lim = ks // 2 - 0.01
    mu1, mu2 = torch.rand((2, s, g, f), generator=gen) * (2 * lim) - lim
    order = (0, 2, 3, 1) if contract_f else (0, 2, 1, 3)
    aw = (tfe._phase_onehot(mu2, span, True) * w[None]).permute(order)
    a = tfe._phase_onehot(mu1, span, True).permute(order)
    dct, dst, _ = tfe._fused_idft_mats(p1, p2, rb, h, h, device)
    ops = dict(xs=torch.randn((p1 * rb, 2 * n, ci), generator=gen).to(device, dtype),
               t1=tfe._phase_table(p1, p1, span, torch.float32, device, conj=contract_f),
               t2=tfe._phase_table(p2, rb, span, torch.float32, device, conj=contract_f),
               aw=aw.to(device, dtype), a=a.to(device, dtype), dct=dct, dst=dst)
    return ops, dict(n_img=n, p1b=p1, rbb=rb)


APPLY_PHI = {"small": (2, 8, 2, 16, 9), "ragged": (3, 37, 1, 41, 13),
             "many_images": (35, 20, 3, 24, 9), "wide": (2, 64, 2, 96, 27)}


@pytest.mark.cuda
@pytest.mark.parametrize("contract_f", [False, True])
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("name", sorted(APPLY_PHI))
def test_apply_phi_kernel_matches_twin(cuda_device, name, dtype, bound, contract_f):
    ops, kw = _apply_phi_case(*APPLY_PHI[name], contract_f, cuda_device, dtype)
    before = (tff.fused_apply_phi.launches, tsp.partial_idft.launches)
    got = tff.fused_apply_phi(**ops, **kw)
    torch.cuda.synchronize()
    assert (tff.fused_apply_phi.launches, tsp.partial_idft.launches) == (before[0] + 1,
                                                                           before[1])
    want = tff.fused_apply_phi_plain(**ops, **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got - want).abs().max()) <= bound * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("contract_f", [False, True])
def test_apply_phi_fused_matches_the_unfused_chain(cuda_device, contract_f):
    gen = torch.Generator().manual_seed(5)
    n, s, g, f, h = 3, 24, 2, 40, 13
    w = (torch.randn((s, g, f), generator=gen) * 0.1).to(cuda_device)
    mu1, mu2 = (torch.rand((2, s, g, f), generator=gen) * 7.98 - 3.99).to(cuda_device)
    x = torch.rand((n, f if contract_f else s, h, h), generator=gen).to(cuda_device)
    got = tfe.fourier_apply_phi_fused(x, w, mu1, mu2, KS, contract_f=contract_f)
    if contract_f:
        p1, p2, rb = tfe.plan_bins(h, h, KS)
        want = tfe.fourier_input_grad(x, tfe.build_phi(w, mu1, mu2, p1, p2, rb, True, 5), KS)
    else:
        want = tfe.fourier_forward(x, w, mu1, mu2, KS)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def _apply_phi_wide(nj, contract_f, device, dtype):
    """K3's operands with nj exponents: at ks 33 and 65 (nj 36 and 68) as
    `fourier_apply_phi_fused` makes them on a small plane (N=3, S=16, F=24,
    7x7); past 68, the ks-65 operands with nj - 68 exponents put in front
    (random table columns, zero one-hot rows), so the taps lie at 4 .. nj-1."""
    ops, kw = _apply_phi_case(3, 16, 2, 24, 7, contract_f, device, dtype, seed=nj,
                              ks=33 if nj == 36 else 65)
    extra = nj - ops["aw"].shape[0]
    if extra:
        gen = torch.Generator().manual_seed(11)
        for key in ("t1", "t2"):
            cols = torch.rand((ops[key].shape[0], extra), generator=gen) * 2 - 1
            ops[key] = torch.cat([cols.to(device), ops[key]], dim=1)
        for key in ("aw", "a"):
            t = ops[key]
            ops[key] = torch.cat([t.new_zeros((extra,) + t.shape[1:]), t])
    assert ops["aw"].shape[0] == nj
    return ops, kw


@pytest.mark.cuda
@pytest.mark.parametrize("contract_f", [False, True])
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("nj", [36, 68, 72])
def test_apply_phi_kernel_past_64_exponents_matches_twin(cuda_device, nj, dtype, bound,
                                                          contract_f, monkeypatch):
    # the FP32-FMA kernel refused tables wider than 64 exponents (ks 65 has
    # 68); the tensor-core kernel takes up to 256, and computes no twin
    twin = tff.fused_apply_phi_plain

    def no_twin(*args, **kw):
        raise AssertionError("the twin ran on a CUDA tensor")

    monkeypatch.setattr(tff, "fused_apply_phi_plain", no_twin)
    ops, kw = _apply_phi_wide(nj, contract_f, cuda_device, dtype)
    got = tff.fused_apply_phi(**ops, **kw)
    torch.cuda.synchronize()
    want = twin(**ops, **kw)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= bound * float(want.abs().max())


@pytest.mark.cuda
def test_apply_phi_kernel_raises_past_its_plan(cuda_device):
    ops, kw = _apply_phi_case(2, 8, 2, 16, 9, False, cuda_device, torch.float32)
    extra = 257 - ops["aw"].shape[0]  # 257 exponents: j past 8 bits
    wide = {k: torch.cat([torch.zeros((ops[k].shape[0], extra), device=cuda_device), ops[k]], 1)
            for k in ("t1", "t2")}
    wide.update({k: torch.cat([ops[k].new_zeros((extra,) + ops[k].shape[1:]), ops[k]])
                 for k in ("aw", "a")})
    assert tff.apply_phi_plan(nj=257, dtype=torch.float32) is None
    before = tff.fused_apply_phi.launches
    with pytest.raises(ValueError, match="plan"):
        tff.fused_apply_phi(**dict(ops, **wide), **kw)
    assert tff.fused_apply_phi.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("g", [5, 7])
def test_apply_phi_kernel_with_more_units_than_a_pass_matches_twin(cuda_device, g, dtype,
                                                                    bound):
    # past 4 units the kernel sums them 4 a pass (its chunked instance)
    for contract_f in (False, True):
        ops, kw = _apply_phi_case(3, 24, g, 40, 9, contract_f, cuda_device, dtype, seed=g)
        got = tff.fused_apply_phi(**ops, **kw)
        want = tff.fused_apply_phi_plain(**ops, **kw)
        assert float((got - want).abs().max()) <= bound * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["ragged", "ks65"])
def test_apply_phi_operand_kernel_matches_the_torch_operands(cuda_device, case, dtype):
    # K3's operand kernel builds, bit for bit, what `apply_phi_operands` and
    # `spectral_table_quads` build in torch (the CPU tests hold those against
    # the JAX kernel), from one-hots at the op's (permuted) strides
    if case == "ragged":
        ops, kw = _apply_phi_case(*APPLY_PHI["ragged"], True, cuda_device, dtype, seed=3)
    else:
        ops, kw = _apply_phi_wide(68, False, cuda_device, dtype)
    assert not ops["aw"].is_contiguous()
    n, p1, rb = kw["n_img"], kw["p1b"], kw["rbb"]
    b_t, rec, tq = tff._operands_cuda(tff._library(), ops["xs"], ops["t1"], ops["t2"], ops["aw"],
                                      ops["a"], n, p1, rb)
    torch.cuda.synchronize()
    want_b, want_rec = tff.apply_phi_operands(ops["xs"], ops["aw"], ops["a"], n)
    quads = [tfb.spectral_table_quads(t.to(dtype).float(), rows)
             for t, rows in ((ops["t1"], p1), (ops["t2"], rb))]
    assert torch.equal(b_t, want_b) and torch.equal(rec, want_rec)
    assert torch.equal(tq, torch.cat(quads))


@pytest.mark.cuda
@pytest.mark.parametrize("n,co", [(4, 40), (3, 37)])
def test_apply_phi_split_kernel_is_split_bf16(cuda_device, n, co):
    # K3's closing launch multiplies Y's bf16 hi/lo parts; the split kernel
    # writes them bit for bit as `split_bf16`, zero past N*CO (3*37 = 111
    # columns pad to 112)
    y = torch.randn((5, 2 * n, co), generator=torch.Generator().manual_seed(n)) * 10
    y = y.to(cuda_device)
    parts = tff._split_cuda(tff._library(), y, n)
    torch.cuda.synchronize()
    c = n * co
    assert parts.shape == (4, 5, -(-c // 8) * 8) and parts.dtype == torch.bfloat16
    for h in (0, 1):
        hi, lo = tk.split_bf16(y[:, h * n:(h + 1) * n].reshape(5, -1))
        assert torch.equal(parts[2 * h, :, :c], hi) and torch.equal(parts[2 * h + 1, :, :c], lo)
    assert not parts[:, :, c:].float().any()


# K4 on the tensor cores. Bounds: f32 1e-4 * max|y| (the three-way bf16
# split, ~2**-24 of each product, and f32 sums in another order); bf16 1e-2 *
# max|y| (exact products, the output rounded once to bf16). (N, S, G, F,
# H=W, ks, use_interpolation): ragged S and F, F past the 64-channel tile,
# 6x6 and 13x13 planes, ks 3 and 9.
AGG_TC = {
    "s5_f7_6px_ks3": (2, 5, 2, 7, 6, 3, True),
    "s16_f96_13px_ks9": (2, 16, 2, 96, 13, 9, True),
    "s5_f7_13px_ks9_nointerp": (2, 5, 2, 7, 13, 9, False),
    "s16_f96_6px_ks3_nointerp": (1, 16, 1, 96, 6, 3, False),
}
# the four AlexNet-DAU layers (S, F, H=W) at N = 4, forward and dx (S<->F)
AGG_LAYERS = {"conv2": (96, 256, 27), "conv3": (256, 384, 13), "conv4": (384, 384, 13),
              "conv5": (384, 256, 13)}


def _agg_inputs(n, s, g, f, h, ks, device, seed=0, w_cols=None):
    gen = torch.Generator().manual_seed(seed)
    bound = ks // 2 - 0.01
    x = torch.rand((n, s, h, w_cols or h), generator=gen)
    w = torch.randn((s, g, f), generator=gen) * 0.1
    mu1, mu2 = torch.rand((2, s, g, f), generator=gen) * 2 * bound - bound
    return [t.to(device) for t in (x, w, mu1, mu2)]


def _check_aggregate(args, ks, interp=True):
    for dtype, bound in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        a = [t.to(dtype) for t in args]
        before = tk.aggregate_forward.launches
        y = tk.aggregate_forward(*a, ks, interp)
        torch.cuda.synchronize()
        assert tk.aggregate_forward.launches == before + 1
        want = tk.aggregate_forward_plain(a[0].float(), *a[1:], ks, interp)
        assert y.dtype == dtype and y.shape == want.shape
        err = float((y.float() - want).abs().max())
        assert err <= bound * float(want.abs().max()), (dtype, err)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(AGG_TC))
def test_aggregate_kernel_edges_match_twin(cuda_device, name):
    n, s, g, f, h, ks, interp = AGG_TC[name]
    _check_aggregate(_agg_inputs(n, s, g, f, h, ks, cuda_device), ks, interp)


@pytest.mark.cuda
@pytest.mark.parametrize("dx", [False, True])
@pytest.mark.parametrize("name", sorted(AGG_LAYERS))
def test_aggregate_kernel_at_layer_shapes_matches_twin(cuda_device, name, dx):
    s, f, h = AGG_LAYERS[name]
    if dx:  # the dx pass: the error's F channels in, S out
        s, f = f, s
    _check_aggregate(_agg_inputs(4, s, 2, f, h, KS, cuda_device, seed=len(name)), KS)


@pytest.mark.cuda
@pytest.mark.parametrize("ks,h,w", [(1, 7, 9), (19, 8, 8), (5, 5, 67)])
def test_aggregate_kernel_runtime_ks_matches_twin(cuda_device, ks, h, w):
    # ks outside the K5 instances (1, 19; 19 stages one window at a time) and
    # a plane wider than 64 columns
    _check_aggregate(_agg_inputs(2, 70, 2, 9, h, ks, cuda_device, w_cols=w), ks)


@pytest.mark.cuda
@pytest.mark.parametrize("dx", [False, True])
@pytest.mark.parametrize("name", sorted(AGG_LAYERS))
@pytest.mark.parametrize("ks", [33, 65])
def test_aggregate_kernel_past_ks17_at_layer_shapes_matches_twin(cuda_device, ks, name, dx):
    # the tiers 33 and 65: bands of tap rows, one window per (group, band)
    s, f, h = AGG_LAYERS[name]
    if dx:
        s, f = f, s
    assert tk.aggregate_plan(h, h, ks)["bands"] > 1
    _check_aggregate(_agg_inputs(2, s, 2, f, h, ks, cuda_device, seed=ks + len(name)), ks)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [3, 7, 13, 27])
@pytest.mark.parametrize("ks", [9, 17, 33, 65])
def test_band_plans_equal_the_kernels(cuda_device, ks, h):
    # the CPU mirror of the plans against the libraries' own, forward and dx
    # planes alike (the same H x W)
    assert tk._library("dau_aggregate").dau_aggregate_smem_bytes(h, h, ks) == \
        tk.aggregate_plan(h, h, ks)["smem"]
    lib = tk._library("dau_forward_fused")
    for dtype, code in tk._DTYPE_CODE.items():
        assert lib.dau_forward_fused_smem_bytes(h, h, ks, 9, code) == \
            tk.fused_plan(h, h, ks, 9, dtype)["smem"]


@pytest.mark.cuda
def test_aggregate_kernel_rejects_a_window_too_large(cuda_device):
    # ks = 257: a padded row wider than a TMA box even for a strip of one column
    args = _agg_inputs(1, 3, 2, 4, 4, 3, cuda_device, w_cols=300)
    with pytest.raises(ValueError, match="window"):
        tk.aggregate_forward(*args, 257)


# planes wider than a TMA box side (256 pixels): column strips. (N, S, F,
# H): F past one 64-channel tile (K5 runs its F-tile pair as a cluster)
WIDE = (1, 9, 70, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("ks", [3, 9, 33])
@pytest.mark.parametrize("w", [300, 640])
def test_aggregate_kernel_on_a_wide_plane_matches_twin(cuda_device, w, ks):
    n, s, f, h = WIDE
    assert tk.aggregate_plan(h, w, ks)["strips"] > 1
    _check_aggregate(_agg_inputs(n, s, 2, f, h, ks, cuda_device, seed=w + ks, w_cols=w), ks)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,ks", [(3, 257, 9), (40, 300, 3), (300, 9, 9)])
def test_band_and_strip_plans_equal_the_kernels_on_wide_planes(cuda_device, h, w, ks):
    assert tk._library("dau_aggregate").dau_aggregate_smem_bytes(h, w, ks) == \
        tk.aggregate_plan(h, w, ks)["smem"]
    lib = tk._library("dau_forward_fused")
    for dtype, code in tk._DTYPE_CODE.items():
        assert lib.dau_forward_fused_smem_bytes(h, w, ks, 9, code) == \
            tk.fused_plan(h, w, ks, 9, dtype)["smem"]


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["pallas", "pallas_fused"])
def test_layer_on_a_wide_plane_matches_xla_engine(cuda_device, engine):
    # 2x32x24x300: K4 or K5 in column strips, forward and dx pass, and K6.
    # sigma is left untrained, as in the models (its gradient, one sum over
    # the whole plane, went beyond 1e-4 of its value at this size under
    # K6's former f32 hi/lo split, strips or not)
    out = {}
    for eng in (engine, "xla"):
        layer = DAUConv2d(32, 40, (2, 1), 9, engine=eng, device=cuda_device,
                          generator=torch.Generator().manual_seed(0))
        x = torch.rand((2, 32, 24, 300), generator=torch.Generator().manual_seed(1))
        x = x.to(cuda_device).requires_grad_()
        err = torch.randn((2, 40, 24, 300), generator=torch.Generator().manual_seed(2))
        before = (tk.aggregate_forward.launches, tk.dau_forward_fused.launches)
        y = layer(x)
        (y * err.to(cuda_device)).sum().backward()
        torch.cuda.synchronize()
        if eng != "xla":
            kernel = 0 if eng == "pallas" else 1
            after = (tk.aggregate_forward.launches, tk.dau_forward_fused.launches)
            assert after[kernel] == before[kernel] + 2  # the forward and the dx pass
        out[eng] = {"y": y.detach(), "x": x.grad,
                    **{k: p.grad for k, p in layer.named_parameters() if p.grad is not None}}
    assert len(out["xla"]) == 6  # y, x and the gradients of w, mu1, mu2 and the bias
    for name, want in out["xla"].items():
        got = out[engine][name]
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), name


# K5 on the tensor cores: the raw input blurred in f32 into K4's staged
# window, bounds as for K4. (N, S, F, H, W, ks, kb): S and F not multiples
# of 64 (S also ragged against the 8-channel chunks), a 27x27 plane spread
# over four tiles, a 13x20 plane, and ks/kb outside the old instance set
FUSED_TC = {
    "s70_f90_27px": (2, 70, 90, 27, 27, 9, 9),
    "s13_f65_13x20": (1, 13, 65, 13, 20, 9, 9),
    "ks19_kb5": (2, 11, 9, 8, 8, 19, 5),
    "ks5_kb9_wide": (1, 70, 9, 5, 67, 5, 9),
    "ks3_kb11": (2, 9, 70, 10, 11, 3, 11),
}


def _blur_filter(kb, device, seed=1):
    """A kb x kb filter that is not separable."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand((kb, kb), generator=gen) / (kb * kb)).to(device)


def _check_fused(args, filt, ks, interp=True):
    for dtype, bound in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        a = [t.to(dtype) for t in args]
        before = tk.dau_forward_fused.launches
        y = tk.dau_forward_fused(*a, filt, ks, interp)
        torch.cuda.synchronize()
        assert tk.dau_forward_fused.launches == before + 1
        want = tk.dau_forward_fused_plain(a[0].float(), *a[1:], filt, ks, interp)
        assert y.dtype == dtype and y.shape == want.shape
        err = float((y.float() - want).abs().max())
        assert err <= bound * float(want.abs().max()), (dtype, err)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FUSED_TC))
def test_fused_kernel_ragged_and_runtime_sizes_match_twin(cuda_device, name):
    n, s, f, h, w, ks, kb = FUSED_TC[name]
    args = _agg_inputs(n, s, 2, f, h, ks, cuda_device, seed=len(name), w_cols=w)
    _check_fused(args, _blur_filter(kb, cuda_device), ks)


@pytest.mark.cuda
@pytest.mark.parametrize("dx", [False, True])
@pytest.mark.parametrize("name", sorted(AGG_LAYERS))
@pytest.mark.parametrize("ks", [33, 65])
def test_fused_kernel_past_ks17_at_layer_shapes_matches_twin(cuda_device, ks, name, dx):
    # the tiers 33 and 65: the blur warps write each band's window, zeros in
    # the rows outside the image; the dx pass takes the mirrored filter
    s, f, h = AGG_LAYERS[name]
    if dx:
        s, f = f, s
    filt = gaussian_filters(0.5, size=9, device=cuda_device)["error" if dx else "w"]
    assert tk.fused_plan(h, h, ks, 9, torch.bfloat16)["bands"] > 1
    _check_fused(_agg_inputs(2, s, 2, f, h, ks, cuda_device, seed=ks + len(name)), filt, ks)


@pytest.mark.cuda
def test_fused_kernel_rejects_a_window_too_large(cuda_device):
    # ks + kb - 1 = 257: a raw row wider than a TMA box even for a strip of
    # one column
    args = _agg_inputs(1, 3, 2, 4, 4, 3, cuda_device, w_cols=300)
    filt = gaussian_filters(0.5, size=9, device=cuda_device)["w"]
    with pytest.raises(ValueError, match="does not fit"):
        tk.dau_forward_fused(*args, filt, 249)


@pytest.mark.cuda
@pytest.mark.parametrize("ks", [3, 9, 33])
@pytest.mark.parametrize("w", [300, 640])
def test_fused_kernel_on_a_wide_plane_matches_twin(cuda_device, w, ks):
    n, s, f, h = WIDE
    assert tk.fused_plan(h, w, ks, 9, torch.bfloat16)["strips"] > 1
    args = _agg_inputs(n, s, 2, f, h, ks, cuda_device, seed=w + ks, w_cols=w)
    _check_fused(args, gaussian_filters(0.5, size=9, device=cuda_device)["w"], ks)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["conv2", "conv4"])
def test_fused_kernel_bf16_matches_the_pallas_engine_chain(cuda_device, name):
    # both round the blurred plane to bf16 once before the tensor cores
    s, f, h = AGG_LAYERS[name]
    args = [t.bfloat16() for t in _agg_inputs(2, s, 2, f, h, KS, cuda_device, seed=5)]
    filt = gaussian_filters(0.5, size=9, device=cuda_device)["w"]
    y = tk.dau_forward_fused(*args, filt, KS)
    xb = depthwise_blur(args[0], filt)
    assert xb.dtype == torch.bfloat16
    want = tk.aggregate_forward(xb, *args[1:], KS)
    err = float((y.float() - want.float()).abs().max())
    assert err <= 1e-2 * float(want.float().abs().max()), err


def _assert_matrix(mat, gt, name, rel_tolerance=0.01):
    """The reference tolerance policy of `tests/helpers.py::assert_matrix`
    (copied: that module imports the JAX package, which the card's machine
    does not have): a value is invalid only if rel-diff > 1e-4 AND abs-diff
    > 1e-7; fail only if the mean rel-diff over the invalid values >
    rel_tolerance AND > 1% of the values are invalid."""
    mat, gt = np.asarray(mat, np.float64), np.asarray(gt, np.float64)
    assert mat.shape == gt.shape, f"{name}: shape {mat.shape} vs {gt.shape}"
    diff_abs = np.abs(mat - gt)
    diff_rel = np.nan_to_num(diff_abs / np.abs(gt + 1e-9))
    invalid = np.logical_and(diff_rel > 1e-4, diff_abs > 1e-7)
    rate = invalid.mean()
    avg = diff_rel[invalid].mean() if invalid.any() else 0.0
    assert avg <= rel_tolerance or rate <= 1e-2, (
        f"{name}: avg rel-diff {avg:.6f} over {rate * 100:.2f}% invalid values")


@pytest.mark.cuda
def test_f32_xla_layer_on_the_card_matches_the_cpu_under_torch_defaults():
    # torch's own TF32 defaults (cuDNN convs may use TF32, matmuls not): the
    # layer's precision='highest' must keep its convs in f32 by itself. The
    # CPU has no TF32, so the same layer there is the f32 reference.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        out = {}
        for dev in ("cpu", "cuda"):
            layer = DAUConv2d(16, 40, (2, 1), 9, engine="xla", dau_sigma_trainable=True,
                              device=dev, generator=torch.Generator().manual_seed(0))
            assert layer.cfg.precision == "highest"
            gen = torch.Generator().manual_seed(1)
            x = torch.rand((2, 16, 15, 17), generator=gen).to(dev).requires_grad_()
            err = torch.randn((2, 40, 15, 17), generator=gen).to(dev)
            y = layer(x)
            (y * err).sum().backward()
            out[dev] = {"y": y.detach(), "x": x.grad,
                        **{k: p.grad for k, p in layer.named_parameters()}}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    for name, want in out["cpu"].items():
        got = out["cuda"][name].cpu()
        _assert_matrix(got.numpy(), want.numpy(), name)
        # and the file's f32 bound, which TF32 (a 10-bit mantissa) breaks
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), name


# The other models' layer shapes (N, S, F, H): the CIFAR nets at 32x32
# (conv1's S = 3, conv3's F = 192) and DAU-ResNet-18 at 224x224 (stage 0 at
# 56x56, F = 64), G = 4 each. F = 64 and 192 are odd counts of 64-wide F
# tiles, where K5 runs without its 2-block cluster; "cifar1_dx" is the dx
# shape of the 3-channel layer (F = 96 in, 3 out, one tile).
MODEL_SHAPES = {
    "cifar1": (4, 3, 96, 32), "cifar1_dx": (4, 96, 3, 32), "cifar2": (4, 96, 96, 16),
    "cifar3": (4, 96, 192, 8), "cifar3_dx": (4, 192, 96, 8), "resnet0": (2, 64, 64, 56),
    "resnet1": (2, 128, 128, 28), "resnet3": (2, 512, 512, 7),
}


def _model_case(name, device, dtype, seed=0):
    n, s, f, hw = MODEL_SHAPES[name]
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((n, s, hw, hw), generator=gen).to(device, dtype)
    w = (torch.randn((s, 4, f), generator=gen) * 0.1).to(device, dtype)
    mu1, mu2 = (torch.rand((2, s, 4, f), generator=gen) * 7.98 - 3.99).to(device, dtype)
    return x, w, mu1, mu2


@pytest.mark.cuda
@pytest.mark.parametrize("kb,sigma", [(9, 0.5), (17, 1.6)])
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("name", sorted(MODEL_SHAPES))
def test_fused_kernel_at_the_model_shapes_matches_twin(cuda_device, name, dtype, bound, kb,
                                                       sigma):
    """K5 at G = 4, S = 3, odd F-tile counts (its cluster-less branch) and
    the blur filter of a trainable sigma (kb = 17)."""
    args = _model_case(name, cuda_device, dtype)
    filt = gaussian_filters(sigma, size=kb, device=cuda_device)["w"]
    before = tk.dau_forward_fused.launches, tk.dau_forward_fused.launches_clusterless
    y = tk.dau_forward_fused(*args, filt, KS)
    torch.cuda.synchronize()
    clusterless = MODEL_SHAPES[name][2] in (3, 64, 192)
    assert (tk.dau_forward_fused.launches, tk.dau_forward_fused.launches_clusterless) == (
        before[0] + 1, before[1] + clusterless)
    want = tk.dau_forward_fused_plain(args[0].float(), *args[1:], filt, KS)
    assert y.dtype == dtype and y.shape == want.shape
    assert float((y.float() - want).abs().max()) <= bound * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("name", sorted(MODEL_SHAPES))
def test_aggregate_kernel_at_the_model_shapes_matches_twin(cuda_device, name, dtype, bound):
    args = _model_case(name, cuda_device, dtype, seed=1)
    y = tk.aggregate_forward(*args, KS)
    want = tk.aggregate_forward_plain(args[0].float(), *args[1:], KS)
    assert y.dtype == dtype
    assert float((y.float() - want).abs().max()) <= bound * float(want.abs().max())


# K1/K2 at G = 4 on the new planes: (M, N, S, G, F, H); 32x32 has 684 bins,
# 56x56 1,860 (the op sends G >= 4 to K1 at any bin count); M = 4 is the
# trainable-sigma backward; S = 3 is CIFAR conv1
SPECTRAL_G4 = {
    "cifar1_m3": (3, 4, 3, 4, 96, 32), "cifar1_m4": (4, 4, 3, 4, 96, 32),
    "cifar2_m4": (4, 4, 96, 4, 96, 16), "resnet0_m3": (3, 2, 64, 4, 64, 56),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("name", sorted(SPECTRAL_G4))
def test_spectral_grads_at_g4_on_the_model_planes_match_twin(cuda_device, name, dtype, bound):
    m, n, s, g, f, h = SPECTRAL_G4[name]
    p1, _, rb = tfe.plan_bins(h, h, KS)
    assert tfb.spectral_plan(m=m, g=g, nj=12, p1b=p1, rbb=rb) is not None
    args, kw, (esb, wg) = _spectral_case(SPECTRAL_G4[name], cuda_device, dtype)
    before = tfb.fused_spectral_grads.launches_k1
    got = tfb.fused_spectral_grads(*args, **kw)
    torch.cuda.synchronize()
    assert tfb.fused_spectral_grads.launches_k1 == before + 1
    want = tfb.fused_spectral_grads_plain(*args, **kw)
    assert float((got - want).abs().max()) <= bound * float(want.abs().max())
    got = tfb.fused_spectral_grads(*args, **kw, esb=esb, wg=wg)
    want = tfb.fused_spectral_grads_plain(*args, **kw, esb=esb, wg=wg)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= bound * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,s,f,hw", [(3, 128, 3, 96, 32), (4, 128, 96, 96, 16)])
def test_grad_tables_f32_kernel_holds_a_cancelling_table(cuda_device, m, n, s, f, hw):
    """K6 in f32 at the CIFAR layer shapes (N = 128) with an error of zero
    mean per channel, as a train-mode BatchNorm hands back: within 1e-5 of
    max|table| of the float64 table (three bf16 parts, six products; two
    parts and three products moved such tables by ~1e-3 in a step)."""
    gen = torch.Generator().manual_seed(3)
    xb = (torch.randn((m, n, s, hw, hw), generator=gen) + 3.0).to(cuda_device)
    err = torch.randn((n, f, hw, hw), generator=gen).to(cuda_device)
    err = err - err.mean(dim=(0, 2, 3), keepdim=True)
    got = tkb.grad_tables(xb, err, KS)
    want = tke.grad_tables(xb.double(), err.double(), KS)
    assert float((got.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,s,f,hw", [(3, 128, 3, 96, 32), (4, 128, 96, 96, 16)])
def test_grad_tables_bf16_kernel_holds_a_cancelling_table(cuda_device, m, n, s, f, hw):
    """K6 in bf16 at the CIFAR layer shapes (N = 128) with an error of zero
    mean per channel: within 1e-4 of max|table| (phase 6's bound) of the
    float64 table of the same bf16 inputs. One wgmma chain per tap, rounded
    toward zero, drifted by 1.9e-4 at the first shape; the kernel folds its
    chain every FOLD_BF16 stages (2.4e-6 there)."""
    gen = torch.Generator().manual_seed(4)
    xb = (torch.randn((m, n, s, hw, hw), generator=gen) + 3.0).to(cuda_device, torch.bfloat16)
    err = torch.randn((n, f, hw, hw), generator=gen)
    err = (err - err.mean(dim=(0, 2, 3), keepdim=True)).to(cuda_device, torch.bfloat16)
    got = tkb.grad_tables(xb, err, KS)
    want = tke.grad_tables(xb.double(), err.double(), KS)
    assert float((got.double() - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
def test_fused_launch_takes_the_wrappers_cluster_size(cuda_device):
    """K5's launcher launches with the cluster size the wrapper passes and
    refuses one that does not divide the F-tile count (F = 64: one tile)."""
    x, w, mu1, mu2 = _model_case("resnet0", cuda_device, torch.bfloat16)
    filt = gaussian_filters(0.5, size=9, device=cuda_device)["w"]
    x_t, kern_t, f32 = tk.fused_forward_operands(x, w, mu1, mu2, filt, KS)
    n, s, h, wd = x.shape
    out = torch.empty((n, 64, h, wd), dtype=x.dtype, device=cuda_device)
    lib = tk._library("dau_forward_fused")
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    codes = [lib.dau_forward_fused_launch(x_t.data_ptr(), f32.data_ptr(), kern_t.data_ptr(),
                                          out.data_ptr(), 1, n, s, 64, h, wd, KS, 9,
                                          kern_t.shape[-1], csize, stream)
             for csize in (2, 1)]
    torch.cuda.synchronize()
    assert codes[0] != 0 and codes[1] == 0
    assert tk.fused_cluster_size(64) == 1
    want = tk.dau_forward_fused_plain(x.float(), w, mu1, mu2, filt, KS)
    assert float((out.float() - want).abs().max()) <= 1e-2 * float(want.abs().max())


@pytest.mark.cuda
def test_prefetch_to_device_copies_in_order_under_a_busy_stream(cuda_device):
    """`prefetch_to_device` on the card: the batches arrive in order with
    their values, on the card, while the consumer's stream is kept busy
    (so a read before the side stream's copy had finished would show), and
    the producer's exception is raised in the consumer."""
    from dau_convnet_tpu_torch.data import prefetch_to_device

    batches = [(np.full((256, 1024), i, np.float32), np.arange(4) + i) for i in range(8)]
    busy = torch.randn((2048, 2048), device=cuda_device)
    seen = []
    for x, y in prefetch_to_device(iter(batches), size=2):
        for _ in range(8):
            busy = busy @ busy * 1e-3
        assert x.device.type == "cuda" and tuple(x.shape) == (256, 1024)
        seen.append((float(x.min()), float(x.max()), y.tolist()))
    assert seen == [(float(i), float(i), [i, i + 1, i + 2, i + 3]) for i in range(8)]

    def failing():
        yield (np.zeros(3, np.float32),)
        raise RuntimeError("boom")

    it = prefetch_to_device(failing())
    assert float(next(it)[0].sum()) == 0.0
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


# the probes' kernels (kernels/probe_kernels.py) at reduced shapes:
# (a shape, b shape, trans_a) of the probe GEMM: P1's K-major A with rows
# of 153, P2's M-major A against a shared B with rows of 81 (odd N: unpaired
# stores), P5's batched layout, a shared A, and M, N, K ragged against the
# tile
PROBE_GEMM_CASES = {
    "p1": ((81, 153), (153, 640), False),
    "p2": ((6, 153, 128), (153, 81), True),
    "p5": ((5, 384, 64), (5, 64, 128), False),
    "shared_a": ((200, 72), (3, 72, 136), False),
    "m_major_ragged": ((2, 40, 136), (2, 40, 33), True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PROBE_GEMM_CASES))
def test_probe_gemm_kernel_matches_twin(cuda_device, case):
    from dau_convnet_tpu_torch.kernels import probe_kernels as pk

    a_shape, b_shape, trans_a = PROBE_GEMM_CASES[case]
    rng = np.random.default_rng(0)
    a, b = (torch.tensor(rng.standard_normal(s), dtype=torch.float32, device=cuda_device)
            .bfloat16() for s in (a_shape, b_shape))
    before = pk.probe_gemm.launches
    got = pk.probe_gemm(a, b, trans_a)
    torch.cuda.synchronize()
    assert pk.probe_gemm.launches == before + 1 and got.dtype == torch.float32
    want = pk.probe_gemm_plain(a, b, trans_a)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
def test_probe_gather_kernel_matches_twin(cuda_device):
    """Targets that hit, and fractions, negatives, NaN and out-of-range
    ones that do not: exact (one product or zero per output)."""
    from dau_convnet_tpu_torch.kernels import probe_kernels as pk

    rng = np.random.default_rng(0)
    tab = torch.tensor(rng.standard_normal((17, 3, 40, 24)), dtype=torch.float32,
                       device=cuda_device)
    tgt = rng.integers(-2, 20, (40, 2, 24)).astype(np.float32)
    tgt[::3, 0, ::5] += 0.5
    tgt[1, 1, :4] = np.nan
    tgt = torch.tensor(tgt, device=cuda_device)
    iw = torch.tensor(rng.random((40, 2, 24)), dtype=torch.float32, device=cuda_device)
    before = pk.probe_gather.launches
    got = pk.probe_gather(tab, tgt, iw)
    torch.cuda.synchronize()
    assert pk.probe_gather.launches == before + 1
    assert torch.equal(got, pk.probe_gather_plain(tab, tgt, iw))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [3, 1000, 5000])
def test_probe_scale_colsum_kernel_matches_twin(cuda_device, rows):
    """Integer values, so any order of the sums gives the twin's exactly."""
    from dau_convnet_tpu_torch.kernels import probe_kernels as pk

    rng = np.random.default_rng(rows)
    x = torch.tensor(rng.integers(-8, 8, (rows, 520)), dtype=torch.float32, device=cuda_device)
    before = pk.scale_colsum.launches
    got = pk.scale_colsum(x)
    torch.cuda.synchronize()
    assert pk.scale_colsum.launches == before + 1
    assert torch.equal(got, pk.scale_colsum_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [None, 1, 7, 300])
def test_probe_add_one_kernel_matches_twin(cuda_device, blocks):
    from dau_convnet_tpu_torch.kernels import probe_kernels as pk

    rng = np.random.default_rng(0)
    x = (torch.tensor(rng.standard_normal((1000, 24)) * 300, dtype=torch.float32,
                      device=cuda_device)).bfloat16()
    out = torch.empty_like(x)
    before = pk.add_one.launches
    assert pk.add_one(x, out=out, blocks=blocks) is out
    torch.cuda.synchronize()
    assert pk.add_one.launches == before + 1
    assert torch.equal(out, pk.add_one_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("ch", [64, 200, 4096])
def test_probe_copy_tiles_kernel_matches_twin(cuda_device, ch):
    """Tiles that divide the row, a ragged last tile, one tile wider than
    the row."""
    from dau_convnet_tpu_torch.kernels import probe_kernels as pk

    x = torch.randn((13, 1000), device=cuda_device).bfloat16()
    before = pk.copy_tiles.launches
    got = pk.copy_tiles(x, ch)
    torch.cuda.synchronize()
    assert pk.copy_tiles.launches == before + 1
    assert torch.equal(got, pk.copy_tiles_plain(x, ch))


@pytest.mark.cuda
def test_probe_device_limits_are_the_cards(cuda_device):
    from dau_convnet_tpu_torch.kernels import probe_kernels as pk

    lim = pk.device_limits()
    props = torch.cuda.get_device_properties(0)
    assert lim["sms"] == props.multi_processor_count
    assert lim["l2_bytes"] == props.L2_cache_size
    assert lim["smem_optin"] >= 48 * 1024


@pytest.mark.cuda
def test_p9_chunked_dot_equals_the_whole_one(cuda_device):
    """P9's chunks through K7 give the whole table's bits, one launch each."""
    from dau_convnet_tpu_torch.probes import pallas_ladder as tpl

    gen = torch.Generator().manual_seed(0)
    cm, sm = torch.randn((2, 153, 81), generator=gen).to(cuda_device, torch.bfloat16)
    tre, tim = torch.randn((2, 153, 4096), generator=gen).to(cuda_device, torch.bfloat16)
    whole = tpl.run_dot(cm, sm, tre, tim)
    before = tsp.partial_idft.launches
    chunked = tpl.run_dot(cm, sm, tre, tim, 1024)
    torch.cuda.synchronize()
    assert tsp.partial_idft.launches == before + 4
    assert torch.equal(chunked, whole)


# the one-device train step replayed as a CUDA graph (parallel/train.py)

def _graph_model(kind, dev):
    from dau_convnet_tpu_torch.models import AlexNetDAU, DAUResNet
    gen = torch.Generator().manual_seed(0)
    if kind == "alexnet":
        return AlexNetDAU(variant="default", image_size=227, dtype=torch.bfloat16, device=dev,
                          generator=gen)
    if kind == "resnet18":
        return DAUResNet(dtype=torch.bfloat16, device=dev, generator=gen)
    torch.manual_seed(0)
    return torch.nn.Sequential(
        DAUConv2d(3, 16, (2, 1), 9, engine="fourier", device=dev, generator=gen),
        torch.nn.ReLU(), DAUConv2d(16, 16, (2, 1), 9, engine="fourier", device=dev, generator=gen),
        torch.nn.Flatten(), torch.nn.Linear(16 * 13 * 13, 10, device=dev))


# (batch, side, classes) of the graphed-step cases
_GRAPH_CASES = {"alexnet": (8, 227, 1000), "resnet18": (4, 224, 1000), "tiny": (4, 13, 10)}


def _graph_batches(kind, dev, steps, n=None):
    n0, side, classes = _GRAPH_CASES[kind]
    g = torch.Generator().manual_seed(7)
    return [(torch.rand((n or n0, 3, side, side), generator=g).to(dev) * 2 - 1,
             torch.randint(0, classes, (n or n0,), generator=g).to(dev)) for _ in range(steps)]


def _graph_run(kind, dev, batches, cuda_graph, opt=None, lrs=None):
    """(losses, final parameters, their last gradients, BatchNorm statistics,
    the step) of SGD steps from the seed's weights."""
    from dau_convnet_tpu_torch.parallel.train import make_train_step
    model = _graph_model(kind, dev)
    optimizer = (opt or (lambda ps: torch.optim.SGD(ps, lr=1e-3)))(model.parameters())
    step = make_train_step(model, optimizer, cuda_graph=cuda_graph)
    losses = []
    for i, (x, y) in enumerate(batches):
        if lrs is not None:
            optimizer.param_groups[0]["lr"] = lrs[i]
        losses.append(step(x, y))
    torch.cuda.synchronize()
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    return torch.stack(losses), state, grads, step


def _held_like_eager(a, b, c):
    """c (graphed) against a (eager): bit for bit where a second eager run
    b is, else within b's distance from a."""
    for key in a:
        ref, twin, got = a[key].float(), b[key].float(), c[key].float()
        if torch.equal(ref, twin):
            assert torch.equal(ref, got), key
        else:
            assert float((got - ref).abs().max()) <= float((twin - ref).abs().max()), key


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["alexnet", "resnet18"])
def test_graphed_steps_match_eager_steps(cuda_device, kind):
    """4 SGD steps from the same weights and batches, eager twice and
    graphed (the first call eager, the second captures and replays, then
    replays): losses, parameters, gradients and BatchNorm statistics."""
    batches = _graph_batches(kind, cuda_device, 4)
    a = _graph_run(kind, cuda_device, batches, False)
    b = _graph_run(kind, cuda_device, batches, False)
    c = _graph_run(kind, cuda_device, batches, True)
    assert dict(c[3].counts) == {"first_call": 1, "captures": 1, "replays": 2}
    assert dict(a[3].counts) == {"off": 4}
    _held_like_eager({"loss": a[0]}, {"loss": b[0]}, {"loss": c[0]})
    _held_like_eager(a[1], b[1], c[1])
    assert set(a[2]) == set(c[2])
    _held_like_eager(a[2], b[2], c[2])


@pytest.mark.cuda
def test_a_hooked_call_runs_eager_and_the_next_replays(cuda_device):
    from dau_convnet_tpu_torch.parallel.train import make_train_step
    model = _graph_model("tiny", cuda_device)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3))
    (x, y), = _graph_batches("tiny", cuda_device, 1)
    seen = []
    for i in range(5):
        hook = model[2].register_forward_hook(lambda *a: seen.append(1)) if i == 3 else None
        step(x, y)
        if hook is not None:
            hook.remove()
    assert len(seen) == 1
    assert dict(step.counts) == {"first_call": 1, "captures": 1, "replays": 2, "hooks": 1}


@pytest.mark.cuda
def test_a_changed_lr_is_applied_not_replayed(cuda_device):
    lrs = [1e-2, 1e-2, 1e-2, 5e-3, 5e-3, 5e-3, 5e-3]
    batches = _graph_batches("tiny", cuda_device, len(lrs))
    a = _graph_run("tiny", cuda_device, batches, False, lrs=lrs)
    b = _graph_run("tiny", cuda_device, batches, False, lrs=lrs)
    c = _graph_run("tiny", cuda_device, batches, True, lrs=lrs)
    assert dict(c[3].counts) == {"first_call": 1, "captures": 2, "replays": 3, "signature": 1}
    _held_like_eager({"loss": a[0]}, {"loss": b[0]}, {"loss": c[0]})
    _held_like_eager(a[1], b[1], c[1])
    # the replays after the change did not take the old lr
    d = _graph_run("tiny", cuda_device, batches, False, lrs=lrs[:3] + [1e-2] * 4)
    assert not torch.equal(d[1]["4.weight"], c[1]["4.weight"])


@pytest.mark.cuda
def test_a_batch_of_another_shape_does_not_replay_the_graph(cuda_device):
    batches = _graph_batches("tiny", cuda_device, 3) + _graph_batches("tiny", cuda_device, 1, n=2)
    a = _graph_run("tiny", cuda_device, batches, False)
    b = _graph_run("tiny", cuda_device, batches, False)
    c = _graph_run("tiny", cuda_device, batches, True)
    assert dict(c[3].counts) == {"first_call": 1, "captures": 1, "replays": 1, "signature": 1}
    _held_like_eager({"loss": a[0]}, {"loss": b[0]}, {"loss": c[0]})
    _held_like_eager(a[1], b[1], c[1])


@pytest.mark.cuda
def test_a_non_capturable_optimizer_falls_back_with_its_reason(cuda_device):
    batches = _graph_batches("tiny", cuda_device, 4)
    adam = lambda ps: torch.optim.Adam(ps, lr=1e-3, capturable=False)  # noqa: E731
    a = _graph_run("tiny", cuda_device, batches, False, opt=adam)
    b = _graph_run("tiny", cuda_device, batches, False, opt=adam)
    with pytest.warns(RuntimeWarning, match="capture failed"):
        c = _graph_run("tiny", cuda_device, batches, True, opt=adam)
    assert dict(c[3].counts) == {"first_call": 1, "capture_failed": 3}
    (reason,) = c[3].failures.values()
    assert "capturable" in reason
    _held_like_eager({"loss": a[0]}, {"loss": b[0]}, {"loss": c[0]})
    _held_like_eager(a[1], b[1], c[1])


@pytest.mark.cuda
def test_a_replay_counts_the_launches_of_an_eager_step_and_returns_its_own_loss(cuda_device):
    from dau_convnet_tpu_torch.parallel.train import make_train_step
    model = _graph_model("tiny", cuda_device)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3))
    deltas, losses = [], []
    for x, y in _graph_batches("tiny", cuda_device, 4):
        before = tfb.fused_spectral_grads.launches_k1
        losses.append(step(x, y))
        torch.cuda.synchronize()
        deltas.append(tfb.fused_spectral_grads.launches_k1 - before)
    assert dict(step.counts) == {"first_call": 1, "captures": 1, "replays": 2}
    assert deltas == [2, 2, 2, 2]  # both DAU layers on K1
    assert len({t.data_ptr() for t in losses}) == 4
    assert len({float(t) for t in losses}) == 4


@pytest.mark.cuda
def test_no_more_than_two_replays_are_in_flight(cuda_device):
    """Right after call i returns, the replay of call i - 2 has finished:
    the host cannot run ahead of the card by more than two steps."""
    from dau_convnet_tpu_torch.parallel.train import make_train_step
    model = _graph_model("alexnet", cuda_device)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-4))
    (x, y), = _graph_batches("alexnet", cuda_device, 1, n=64)
    step(x, y)
    step(x, y)
    torch.cuda.synchronize()
    marks = []
    for i in range(12):
        step(x, y)
        marks.append(torch.cuda.Event())
        marks[-1].record()
        if i >= 2:
            assert marks[i - 2].query(), i
    assert not marks[-1].query()  # the host is ahead of the card
    assert step.counts["replays"] == 12
