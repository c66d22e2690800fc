"""The benchmark's float32 reference against the program on the CPU, at a
tiny size: the port's dense engine ('xla') in float32, on the weights and
inputs the benchmark makes from a seed."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from portbench import weights as wts
from portbench.reference import dau, train as ref

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _f32_config(name: str, image: int) -> dict:
    cfg = copy.deepcopy(json.loads((CONFIGS / f"{name}.json").read_text()))
    cfg.update(dtype="float32", image_size=image)
    cfg["program"]["kwargs"]["engine"] = "xla"
    if "image_size" in cfg["program"]["kwargs"]:
        cfg["program"]["kwargs"]["image_size"] = image
    return cfg


def _close(got, want, tol, what):
    got, want = got.detach().float(), want.detach().float()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol * max(scale, 1e-30), f"{what}: max|d| {err:.3e} max|ref| {scale:.3e}"


@pytest.mark.parametrize("units,stride", [((2, 1), 1), ((2, 2), 1), ((2, 2), 2)])
def test_dau_layer_forward_and_backward_match_the_program(units, stride):
    from dau_convnet_tpu_torch.nn.layers import DAUConv2d

    gen = torch.Generator().manual_seed(7)
    s, f, g = 5, 6, units[0] * units[1]
    layer = DAUConv2d(s, f, units, 9, strides=stride, engine="xla", dtype=torch.float32,
                      device="cpu")
    with torch.no_grad():
        layer.weights.copy_(torch.randn((1, s, g, f), generator=gen) * 0.3)
        layer.mu1.copy_((torch.rand((1, s, g, f), generator=gen) * 2 - 1) * 3.5)
        layer.mu2.copy_((torch.rand((1, s, g, f), generator=gen) * 2 - 1) * 3.5)
        layer.bias.copy_(torch.randn(f, generator=gen) * 0.1)
    x = torch.randn((2, s, 11, 13), generator=gen, requires_grad=True)
    gy_seed = torch.Generator().manual_seed(8)
    y = layer(x)
    gy = torch.randn(y.shape, generator=gy_seed)
    gx, gw, gm1, gm2, gb = torch.autograd.grad(
        y, [x, layer.weights, layer.mu1, layer.mu2, layer.bias], gy)

    xr = x.detach().clone().requires_grad_(True)
    p = {k: getattr(layer, k).detach().clone().requires_grad_(True)
         for k in ("weights", "mu1", "mu2", "bias")}
    settings = dau.layer_settings({"max_kernel_size": 9, "border_bound": 0.01, "sigma": 0.5,
                                   "mu_learning_rate_factor": 500.0}, stride)
    with ref.no_tf32():
        yr = dau.dau_conv(xr, p, settings)
        want = torch.autograd.grad(yr, [xr, p["weights"], p["mu1"], p["mu2"], p["bias"]], gy)
    _close(y, yr, 1e-5, "y")
    for got, w, name in zip((gx, gw, gm1, gm2, gb), want, ("dx", "dw", "dmu1", "dmu2", "dbias")):
        _close(got, w, 1e-4, name)


# ResNet at 64x64 and 4 images: at 32x32 its last stage's BatchNorm sees one
# pixel of 2 images, a variance near epsilon that turns rounding into gaps
@pytest.mark.parametrize("name,image,n", [("alexnet-dau-default", 67, 2), ("dau-resnet18", 64, 4)])
def test_reference_sgd_steps_match_the_program(name, image, n):
    from portbench import program
    from portbench.loads.train import normalise

    cfg = _f32_config(name, image)
    mix = {"model_kwargs": {}}
    params = wts.make_weights(cfg, 2**33 + 11, torch.device("cpu"))
    model = program.build_model(cfg, mix, params, torch.device("cpu"))
    gen = torch.Generator().manual_seed(3)
    batches = [(normalise(torch.randint(0, 256, (n, 3, image, image), dtype=torch.uint8,
                                        generator=gen)),
                torch.randint(0, 1000, (n,), generator=gen)) for _ in range(2)]
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    losses, first = [], None
    for x, y in batches:
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        if first is None:
            first = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
        opt.step()
        losses.append(float(loss.detach()))
    losses_r, grads_r, final_r, logits_r = ref.train_steps(cfg, params, batches, 1e-2)
    assert losses == pytest.approx(losses_r, rel=1e-5)
    assert set(grads_r) == set(first)
    for k, g in grads_r.items():
        _close(first[k], g, 2e-4, f"grad {k}")
    state = model.state_dict()
    for k, v in final_r.items():
        _close(state[k], v, 1e-5, f"param {k}")
