"""Port vs JAX: one SGD training step of the full-width AlexNet-DAU.

The slice `bench.py::bench_alexnet` times: the default variant (G=2),
train=False (no dropout), mean softmax cross-entropy on integer labels,
`optax.sgd(1e-4)` against `torch.optim.SGD(lr=1e-4)`, at N=2 and 3x67x67 in
f32 (every layer still runs: conv2 at 7x7, conv3-conv5 at 3x3). The JAX
step runs engine 'pallas_fused' with its Pallas kernels in interpret mode;
the port runs the two Pallas engines, whose kernel wrappers compute their
plain twins on the CPU.

Tolerances: the loss to rtol 1e-5; each gradient to rtol 1e-3 with an
absolute floor of 1e-4 * max|grad| of that tensor (the sums run in other
orders through four DAU layers, the analytic DAU backward and 4096-wide
FCs, and the mu grads carry the learning-rate factor 500); the updated
parameters to rtol 1e-6 (two f32 roundings) with an absolute floor of
1e-3 * LR * max|grad|, the gradient bound carried through the update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dau_convnet_tpu.models import AlexNetDAU as JaxAlexNetDAU
from dau_convnet_tpu_torch.models import AlexNetDAU
from dau_convnet_tpu_torch.parallel import make_train_step, softmax_xent
from dau_convnet_tpu_torch.utils import params_from_flax

IMAGE, BATCH, LR = 67, 2, 1e-4


@pytest.fixture(scope="module")
def jax_step():
    rng = np.random.default_rng(0)
    model = JaxAlexNetDAU(engine="pallas_fused", train=False)
    x = rng.random((BATCH, 3, IMAGE, IMAGE)).astype(np.float32)
    labels = rng.integers(0, 1000, BATCH)
    params = jax.device_get(model.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    for name in ("dau_conv2", "dau_conv3", "dau_conv4", "dau_conv5"):
        layer = params[name]
        shape = layer["mu1"].shape
        layer["mu1"] = rng.uniform(-3.99, 3.99, shape).astype(np.float32)
        layer["mu2"] = rng.uniform(-3.99, 3.99, shape).astype(np.float32)
        layer["bias"] = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean()

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = optax.sgd(LR)
    updates, _ = tx.update(grads, tx.init(params))
    new = optax.apply_updates(params, updates)
    return dict(params=params, x=x, labels=labels, loss=float(loss),
                grads=params_from_flax(jax.device_get(grads)),
                new=params_from_flax(jax.device_get(new)))


def _close(got, ref, name):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4 * float(np.abs(ref).max()),
                               err_msg=name)


@pytest.mark.parametrize("engine", ["pallas_fused", "pallas"])
def test_sgd_step_matches_jax(jax_step, engine):
    port = AlexNetDAU(engine=engine, image_size=IMAGE, device="cpu")
    port.load_state_dict(params_from_flax(jax_step["params"]))
    old = {k: v.detach().clone() for k, v in port.named_parameters()}
    step = make_train_step(port, torch.optim.SGD(port.parameters(), lr=LR))
    loss = step(torch.from_numpy(jax_step["x"]), torch.from_numpy(jax_step["labels"]))
    np.testing.assert_allclose(float(loss), jax_step["loss"], rtol=1e-5)

    for name, p in port.named_parameters():
        ref = jax_step["grads"][name].numpy()
        if name.endswith(".sigma"):  # not trainable: no grad, no update
            assert p.grad is None and not np.any(ref), name
            assert torch.equal(p.detach(), old[name]), name
            continue
        _close(p.grad.numpy(), ref, f"grad {name}")
        np.testing.assert_allclose(p.detach().numpy(), jax_step["new"][name].numpy(),
                                   rtol=1e-6, atol=1e-3 * LR * float(np.abs(ref).max()),
                                   err_msg=f"param {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_xent_matches_optax(dtype):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((5, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, 5)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits, jd), jnp.asarray(labels)).mean()
    got = softmax_xent(torch.from_numpy(logits).to(td), torch.from_numpy(labels))
    assert got.dtype == td
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(float(got), float(ref), rtol=tol)


def test_train_step_does_not_accumulate_grads():
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.SGD(model.parameters(), lr=0.5)
    step = make_train_step(model, opt)
    x, y = torch.randn(6, 4), torch.tensor([0, 1, 2, 0, 1, 2])
    w0 = model.weight.detach().clone()
    loss = step(x, y)
    assert not loss.requires_grad
    torch.testing.assert_close(model.weight.detach(), w0 - 0.5 * model.weight.grad)
    ref = torch.nn.Linear(4, 3)
    ref.load_state_dict(model.state_dict())
    step(x, y)  # the second step's grads are those of the first update alone
    torch.nn.functional.cross_entropy(ref(x), y).backward()
    torch.testing.assert_close(model.weight.grad, ref.weight.grad)
    torch.testing.assert_close(model.bias.grad, ref.bias.grad)


def test_bf16_step_is_finite_and_follows_sgd():
    gen = torch.Generator().manual_seed(0)
    model = AlexNetDAU(engine="pallas_fused", dtype=torch.bfloat16, image_size=IMAGE,
                       device="cpu", generator=gen)
    old = {k: v.detach().clone() for k, v in model.named_parameters()}
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR))
    x = torch.rand((BATCH, 3, IMAGE, IMAGE), generator=gen)
    loss = step(x, torch.tensor([3, 7]))
    assert torch.isfinite(loss.float())
    for name, p in model.named_parameters():
        assert p.dtype == old[name].dtype, name
        if name.endswith(".sigma"):
            assert p.grad is None
            continue
        assert p.grad is not None and torch.isfinite(p.grad.float()).all(), name
        assert torch.any(p.grad != 0), name
        # SGD adds -LR * grad in f32 and rounds once to the parameter's
        # dtype (in bf16 an update below half an ulp leaves the parameter as
        # it was); whether that add is fused may move the result by one ulp
        want = (old[name].float() - LR * p.grad.float()).to(p.dtype)
        if p.dtype == torch.bfloat16:
            rtol, atol = 2 ** -7, 0.0
        else:
            rtol, atol = 1e-6, 2 ** -23 * float(old[name].abs().max())
        torch.testing.assert_close(p.detach(), want, rtol=rtol, atol=atol, msg=name)
    assert not torch.equal(model.fc8.bias, old["fc8.bias"])
