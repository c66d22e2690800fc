"""Port vs JAX: the CIFAR nets and DAU-ResNet, their BatchNorm, and the
repo's trained artifacts.

Each model is built in both packages from the same flax variables (the JAX
model's init, with random offsets and random BatchNorm statistics so every
path is exercised) and run on the same numpy inputs from a seed, in f32.

Tolerances: logits to rtol 1e-4 with an absolute floor of 1e-4*max|logits|
(as tests/test_torch_alexnet.py); in the SGD step the loss to rtol 1e-5,
each gradient to rtol 1e-3 with a floor of 1e-4*max|grad| of that tensor
and the updated parameters to rtol 1e-6 with a floor of 1e-3*LR*max|grad|
(as tests/test_torch_train.py), and the BatchNorm running statistics after
the step to rtol 1e-5 with a floor of 1e-6 (one f32 update of values of
order one; torch.nn.BatchNorm2d's unbiased variance is n/(n-1) off, far
outside it). The artifacts are held to the accuracies recorded for them
(tests/test_models.py:141-270).
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from dau_convnet_tpu.models import ConvCifarNet as JaxConvCifarNet
from dau_convnet_tpu.models import DAUCifarNet as JaxDAUCifarNet
from dau_convnet_tpu.models import DAUResNet as JaxDAUResNet
from dau_convnet_tpu_torch.examples.train_cifar10 import digits_32x32, synthetic_spatial
from dau_convnet_tpu_torch.models import ConvCifarNet, DAUCifarNet, DAUResNet
from dau_convnet_tpu_torch.nn import BatchNorm, set_dau_variables_manually
from dau_convnet_tpu_torch.parallel import make_train_step
from dau_convnet_tpu_torch.utils import load_params_npz, params_from_flax

DOCS = os.path.join(os.path.dirname(__file__), "..", "docs")

# name: (JAX model, port model, input shape, SGD learning rate)
MODELS = {
    "cifar": (lambda **kw: JaxDAUCifarNet(**kw), lambda **kw: DAUCifarNet(**kw),
              (2, 3, 32, 32), 1e-3),
    "cifar-fourier": (lambda **kw: JaxDAUCifarNet(engine="fourier", **kw),
                      lambda **kw: DAUCifarNet(engine="fourier", **kw), (2, 3, 32, 32), 1e-3),
    "conv": (lambda **kw: JaxConvCifarNet(**kw), lambda **kw: ConvCifarNet(**kw),
             (2, 3, 32, 32), 1e-3),
    "resnet18": (lambda **kw: JaxDAUResNet(depth="18", width=8, num_classes=5, **kw),
                 lambda **kw: DAUResNet(depth="18", width=8, num_classes=5, **kw),
                 (2, 3, 64, 64), 1e-4),
}


def _close(got, ref, name, rtol=1e-4, floor=1e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=floor * float(np.abs(ref).max()),
                               err_msg=name)


def _variables(name, seed=0):
    """The JAX model's variables, with offsets spread over the kernel and
    BatchNorm statistics and affines away from their init values; and the
    input (a fresh copy of both)."""
    v, x = _made_variables(name, seed)
    return jax.tree_util.tree_map(np.copy, v), x.copy()


@functools.lru_cache(maxsize=None)
def _made_variables(name, seed):
    jax_model, _, shape, _ = MODELS[name]
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    v = jax.device_get(jax.jit(jax_model(train=False).init)(jax.random.PRNGKey(seed),
                                                            jnp.asarray(x)))

    def perturb(node):
        for key, val in node.items():
            if isinstance(val, dict):
                perturb(val)
            elif key in ("mu1", "mu2"):
                node[key] = rng.uniform(-3.99, 3.99, val.shape).astype(np.float32)
            elif key in ("mean", "bias"):
                node[key] = (rng.standard_normal(val.shape) * 0.1).astype(np.float32)
            elif key in ("var", "scale"):
                node[key] = rng.uniform(0.5, 2.0, val.shape).astype(np.float32)

    perturb(v)
    return v, x


def _port(name, variables, train):
    model = MODELS[name][1](train=train, device="cpu")
    model.load_state_dict(params_from_flax(variables))
    return model


@pytest.mark.parametrize("name", ["cifar", "conv", "resnet18"])
def test_eval_logits_match_jax(name):
    v, x = _variables(name)
    ref = np.asarray(jax.jit(MODELS[name][0](train=False).apply)(v, jnp.asarray(x)))
    with torch.inference_mode():
        got = _port(name, v, train=False)(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    _close(got, ref, name)


@pytest.mark.parametrize("name", ["cifar", "cifar-fourier", "resnet18"])
def test_train_step_matches_jax(name):
    """One train-mode SGD step: the loss, every gradient, the updated
    parameters and the BatchNorm running statistics."""
    jax_model, _, _, lr = MODELS[name]
    v, x = _variables(name, seed=1)
    labels = np.array([1, 3])
    model = jax_model(train=True)

    def loss_fn(params):
        logits, upd = model.apply({"params": params, "batch_stats": v["batch_stats"]},
                                  jnp.asarray(x), mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels))
        return loss.mean(), upd

    (loss, upd), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    tx = optax.sgd(lr)
    new = optax.apply_updates(v["params"], tx.update(grads, tx.init(v["params"]))[0])
    ref_grads = params_from_flax(jax.device_get(grads))
    ref_new = params_from_flax({"params": jax.device_get(new),
                                "batch_stats": jax.device_get(upd["batch_stats"])})

    port = _port(name, v, train=True)
    step = make_train_step(port, torch.optim.SGD(port.parameters(), lr=lr))
    got_loss = step(torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    for key, p in port.named_parameters():
        ref = ref_grads[key].numpy()
        if key.endswith(".sigma"):  # not trainable: no grad, no update
            assert p.grad is None and not np.any(ref), key
            continue
        _close(p.grad.numpy(), ref, f"grad {key}", rtol=1e-3)
        _close(p.detach().numpy(), ref_new[key].numpy(), f"param {key}", rtol=1e-6,
               floor=1e-3 * lr * float(np.abs(ref).max()) / max(
                   float(np.abs(ref_new[key].numpy()).max()), 1e-30))
    stats = {k: b for k, b in port.named_buffers() if k.endswith(("running_mean", "running_var"))}
    assert stats and set(stats) == {k for k in ref_new if k.endswith(("mean", "var"))}
    for key, b in stats.items():
        np.testing.assert_allclose(b.numpy(), ref_new[key].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("momentum", [0.9, 0.99, 0.9999])
def test_batchnorm_matches_flax_and_batchnorm2d_does_not(momentum):
    """flax's running variance takes the biased batch variance; the port's
    BatchNorm does the same, torch.nn.BatchNorm2d the unbiased one."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 4, 3, 3)) * 1.5 + 0.3).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=momentum, epsilon=1e-3, axis=1)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref, upd = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    want_var = np.asarray(upd["batch_stats"]["var"])

    port = BatchNorm(4, momentum=1 - momentum, eps=1e-3, device="cpu")
    got = port(torch.from_numpy(x)).detach().numpy()
    _close(got, np.asarray(ref), "output", rtol=1e-5, floor=1e-6)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(port.running_var.numpy(), want_var, rtol=1e-5, atol=1e-7)

    if momentum <= 0.99:  # at 0.9999 the two rules differ by ~1e-5 of var
        torch_bn = torch.nn.BatchNorm2d(4, momentum=1 - momentum, eps=1e-3)
        torch_bn(torch.from_numpy(x))
        off = np.abs(torch_bn.running_var.detach().numpy() - want_var)
        assert off.max() > 10 * (1e-5 * np.abs(want_var).max() + 1e-7), off


def test_batchnorm_bf16_stats_in_f32_and_output_in_bf16():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 6, 5, 5)) * 3).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, axis=1, dtype=jnp.bfloat16)
    v = bn.init(jax.random.PRNGKey(0), xb)
    ref, upd = bn.apply(v, xb, mutable=["batch_stats"])
    port = BatchNorm(6, momentum=0.1, device="cpu")
    got = port(torch.tensor(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and port.running_var.dtype == torch.float32
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(ref, np.float32),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5)


def test_models_keep_flax_names_and_dtypes():
    v, _ = _variables("resnet18")
    state = params_from_flax(v)
    port = DAUResNet(depth="18", width=8, num_classes=5, dtype=torch.bfloat16, device="cpu")
    want = set(port.state_dict())
    assert set(state) == want
    assert "stage1_block0.proj.weight" in want and "stage0_block0.proj.weight" not in want
    sd = port.state_dict()
    assert sd["stage2_block1.dau1.weights"].dtype == torch.bfloat16
    assert sd["stage2_block1.bn1.running_var"].dtype == torch.float32
    assert sd["stem.weight"].dtype == torch.float32 and sd["head.weight"].dtype == torch.float32
    cifar = DAUCifarNet(train=False, device="cpu")
    assert not cifar.training and DAUCifarNet(device="cpu").training
    assert cifar.dau_conv1.bias is None and cifar.BatchNorm_0.momentum == 1e-4
    assert cifar.BatchNorm_0.eps == 1e-3


@pytest.fixture(scope="module")
def spatial_slice():
    _, _, x_test, y_test = synthetic_spatial(n=50000)
    return x_test[:500], y_test[:500]


def _accuracies(pred, y):
    return (pred == y).mean(), ((pred % 5) == (y % 5)).mean()


def test_spatial_artifact_matches_jax_and_its_accuracy(spatial_slice):
    """docs/spatial_dau_4000_params.npz through the port's DAUCifarNet on the
    fourier engine: logits within tolerance of JAX's on the recorded
    500-image slice, top-1 in [0.42, 0.58] (the task's 50% ceiling) and
    pair accuracy >= 0.92."""
    x, y = spatial_slice
    trees = load_params_npz(os.path.join(DOCS, "spatial_dau_4000_params.npz"))
    jax_net = JaxDAUCifarNet(train=False, engine="fourier")
    fn = jax.jit(lambda v: jax_net.apply(trees, v))
    port = DAUCifarNet(train=False, engine="fourier", device="cpu")
    port.load_state_dict(params_from_flax(trees))
    ref, got = [], []
    with torch.inference_mode():
        for i in range(0, len(x), 125):
            ref.append(np.asarray(fn(jnp.asarray(x[i:i + 125]))))
            got.append(port(torch.from_numpy(x[i:i + 125])).numpy())
    ref, got = np.concatenate(ref), np.concatenate(got)
    _close(got, ref, "spatial_dau_4000 logits")
    top1, pair = _accuracies(got.argmax(-1), y)
    assert 0.42 <= top1 <= 0.58, top1
    assert pair >= 0.92, pair


def test_spatial_conv_artifact_accuracy(spatial_slice):
    """docs/spatial_conv_2500_params.npz through the port's ConvCifarNet
    (recorded: top-1 0.4905, pair 0.9735 on the full test split)."""
    x, y = spatial_slice
    port = ConvCifarNet(train=False, device="cpu")
    port.load_state_dict(params_from_flax(
        load_params_npz(os.path.join(DOCS, "spatial_conv_2500_params.npz"))))
    with torch.inference_mode():
        pred = port(torch.from_numpy(x)).argmax(-1).numpy()
    top1, pair = _accuracies(pred, y)
    assert 0.42 <= top1 <= 0.58, top1
    assert pair >= 0.92, pair


@pytest.mark.parametrize("artifact,sigma_trainable", [("digits_dau_params.npz", False),
                                                      ("digits_dau_sigma_params.npz", True)])
def test_digits_artifacts_install_and_reach_their_accuracy(artifact, sigma_trainable):
    """The digits artifacts, their DAU parameters installed through
    `set_dau_variables_manually` and the rest loaded as a state dict, reach
    >= 0.85 in eval mode on the 128-image digits slice. The sigma artifact
    needs dau_sigma_trainable=True (its learned sigma exceeds the fixed
    filter's support)."""
    pytest.importorskip("sklearn")
    trees = load_params_npz(os.path.join(DOCS, artifact))
    params = trees["params"]
    net = DAUCifarNet(train=False, dau_sigma_trainable=sigma_trainable, device="cpu")
    for name in ("dau_conv1", "dau_conv2", "dau_conv3"):
        p = params[name]
        set_dau_variables_manually(net, name, weights=p["weights"], mu1=p["mu1"], mu2=p["mu2"],
                                   sigma=p["sigma"])
        for key in ("weights", "mu1", "mu2", "sigma"):
            np.testing.assert_array_equal(getattr(net, name).state_dict()[key].numpy(), p[key])
    rest = {k: v for k, v in params_from_flax(trees).items() if not k.startswith("dau_conv")}
    missing, unexpected = net.load_state_dict(rest, strict=False)
    assert not unexpected and all(k.startswith("dau_conv") for k in missing)
    _, _, x_te, y_te = digits_32x32()
    with torch.inference_mode():
        pred = net(torch.from_numpy(x_te[:128])).argmax(-1).numpy()
    acc = (pred == y_te[:128]).mean()
    assert acc >= 0.85, acc


def _example(name):
    """A function of the JAX package's `examples/train_cifar10.py`."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from examples import train_cifar10
    return getattr(train_cifar10, name)


@pytest.mark.parametrize("kw", [dict(n=300, n_test=40), dict(n=200, n_test=30, seed=3,
                                                              distinct=True)], ids=str)
def test_synthetic_spatial_is_the_examples_bit_for_bit(kw):
    ref_fn = _example("synthetic_spatial")
    for got, ref in zip(synthetic_spatial(**kw), ref_fn(**kw)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_digits_32x32_is_the_examples_bit_for_bit():
    pytest.importorskip("sklearn")
    ref_fn = _example("digits_32x32")
    for got, ref in zip(digits_32x32(), ref_fn()):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
