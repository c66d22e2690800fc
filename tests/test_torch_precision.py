"""The port honours `precision` on cuDNN's f32 convolutions, on the CPU.

JAX passes `Precision.HIGHEST` to the dense engine's convolutions
(`depthwise_blur`, `xla_engine.aggregate_forward`, `xla_engine.grad_tables`);
on the card torch would let cuDNN run them in TF32. At precision='highest'
the port runs each of them with `torch.backends.cudnn.allow_tf32` off and
restores it afterwards; at 'default' it leaves the flag alone. A spy on
`F.conv2d` records the flag at each call; the CPU reads and sets it as the
card does.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dau_convnet_tpu_torch.nn import DAUConv2d
from dau_convnet_tpu_torch.ops import xla_engine
from dau_convnet_tpu_torch.ops._precision import conv_precision
from dau_convnet_tpu_torch.ops.gaussian import depthwise_blur


@pytest.fixture
def tf32_spy(monkeypatch):
    """The cuDNN TF32 flag at each F.conv2d call, with torch's default (on)
    set for the test and the flag put back after it."""
    seen = []
    real = F.conv2d

    def spy(*args, **kw):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real(*args, **kw)

    monkeypatch.setattr(F, "conv2d", spy)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    yield seen
    torch.backends.cudnn.allow_tf32 = before


def _tensors(seed=0):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.random((2, 3, 8, 9)).astype(np.float32))
    w = torch.tensor(rng.standard_normal((3, 2, 4)).astype(np.float32) * 0.1)
    mu1, mu2 = torch.tensor(rng.uniform(-3.9, 3.9, (2, 3, 2, 4)).astype(np.float32))
    err = torch.tensor(rng.standard_normal((2, 4, 8, 9)).astype(np.float32))
    return x, w, mu1, mu2, err


CONVS = {
    "depthwise_blur": lambda x, w, mu1, mu2, err, p: depthwise_blur(
        x, torch.ones((3, 3)) / 9, precision=p),
    "aggregate_forward": lambda x, w, mu1, mu2, err, p: xla_engine.aggregate_forward(
        x, w, mu1, mu2, 9, precision=p),
    "grad_tables": lambda x, w, mu1, mu2, err, p: xla_engine.grad_tables(
        x[None], err, 9, precision=p),
}


@pytest.mark.parametrize("precision,tf32", [("highest", False), ("default", True)])
@pytest.mark.parametrize("name", sorted(CONVS))
def test_dense_convs_turn_tf32_off_at_highest(tf32_spy, name, precision, tf32):
    out = CONVS[name](*_tensors(), precision)
    assert torch.isfinite(out).all()
    assert tf32_spy == [tf32]
    assert torch.backends.cudnn.allow_tf32  # restored after the call


@pytest.mark.parametrize("precision,tf32", [("highest", False), ("default", True)])
def test_layer_convs_follow_the_layer_precision(tf32_spy, precision, tf32):
    # engine 'xla' forward and backward: the blur, the aggregation, the
    # derivative blurs, the grad tables and the dx pass's blur + aggregation
    layer = DAUConv2d(3, 4, (2, 1), 9, engine="xla", precision=precision, device="cpu",
                      dau_sigma_trainable=True, generator=torch.Generator().manual_seed(0))
    x = _tensors()[0].requires_grad_()
    layer(x).square().sum().backward()
    assert len(tf32_spy) == 6 and set(tf32_spy) == {tf32}
    assert torch.backends.cudnn.allow_tf32


def test_conv_precision_restores_the_flag_on_error():
    before = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        with pytest.raises(RuntimeError):
            with conv_precision("highest"):
                assert not torch.backends.cudnn.allow_tf32
                raise RuntimeError("inside")
        assert torch.backends.cudnn.allow_tf32
        with pytest.raises(ValueError):
            with conv_precision("high"):
                pass
    finally:
        torch.backends.cudnn.allow_tf32 = before
