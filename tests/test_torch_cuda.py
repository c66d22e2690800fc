"""Card-only tests of the port: the CUDA kernels against their plain twins.

This file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Without a CUDA device every test here skips.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dau_convnet_tpu_torch.kernels import forward as tk
from dau_convnet_tpu_torch.nn import DAUConv2d
from dau_convnet_tpu_torch.ops.gaussian import gaussian_filters

KS = 9
EDGE_MU = np.array([-3.99, 3.99, -3.0, 0.0, 2.0, 3.0, -0.5, -2.25, -1.75, 1.5],
                   np.float32)

# (N, S, G, F, H, W, edge mu, use_interpolation): odd sizes, F not a multiple
# of the 32-channel tile, S not a multiple of the 4-channel stage, and an
# image taller than one row tile
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
