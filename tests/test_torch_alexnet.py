"""Port vs JAX: the whole serving slice, AlexNet-DAU through the fused engine.

Full-width default variant (G=2) at N=2 and 3x67x67, which still passes
through every layer (conv2 at 7x7, conv3-conv5 at 3x3), in f32. The JAX
model runs engine='pallas_fused' with the Pallas kernel in interpret mode.
Tolerance: rtol 1e-4, atol 1e-4*max|logits|, looser than one layer's since
the sums run in other orders through 4 DAU layers and 4096-wide FCs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dau_convnet_tpu.models import AlexNetDAU as JaxAlexNetDAU
from dau_convnet_tpu_torch.models import AlexNetDAU
from dau_convnet_tpu_torch.utils import params_from_flax

IMAGE = 67


@pytest.fixture(scope="module")
def jax_model_and_params():
    rng = np.random.default_rng(0)
    model = JaxAlexNetDAU(engine="pallas_fused", train=False)
    x = rng.random((2, 3, IMAGE, IMAGE)).astype(np.float32)
    params = jax.device_get(model.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    for name in ("dau_conv2", "dau_conv3", "dau_conv4", "dau_conv5"):
        layer = params[name]
        shape = layer["mu1"].shape
        layer["mu1"] = rng.uniform(-3.99, 3.99, shape).astype(np.float32)
        layer["mu2"] = rng.uniform(-3.99, 3.99, shape).astype(np.float32)
        layer["bias"] = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    return model, params, x


def test_alexnet_logits_match_jax(jax_model_and_params):
    model, params, x = jax_model_and_params
    ref = np.asarray(jax.jit(lambda p, v: model.apply({"params": p}, v))(params, jnp.asarray(x)))

    port = AlexNetDAU(engine="pallas_fused", image_size=IMAGE, device="cpu")
    port.load_state_dict(params_from_flax(params))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 1000)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


def test_params_from_flax_layouts(jax_model_and_params):
    _, params, _ = jax_model_and_params
    state = params_from_flax({"params": params})
    port = AlexNetDAU(image_size=IMAGE, device="cpu")
    want = {k: (tuple(v.shape), v.dtype) for k, v in port.state_dict().items()}
    assert {k: (tuple(v.shape), v.dtype) for k, v in state.items()} == want
    np.testing.assert_array_equal(state["conv1.weight"].numpy(),
                                  params["conv1"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["fc7.weight"].numpy(), params["fc7"]["kernel"].T)


def test_bf16_model_keeps_dau_params_bf16_and_dense_params_f32():
    port = AlexNetDAU(engine="pallas_fused", dtype=torch.bfloat16, image_size=IMAGE,
                      device="cpu", generator=torch.Generator().manual_seed(0))
    state = port.state_dict()
    assert state["dau_conv3.weights"].dtype == torch.bfloat16
    assert state["dau_conv3.sigma"].dtype == torch.bfloat16
    assert state["conv1.weight"].dtype == torch.float32
    assert state["fc6.weight"].dtype == torch.float32
    with torch.inference_mode():
        y = port(torch.rand((1, 3, IMAGE, IMAGE), generator=torch.Generator().manual_seed(1)))
    assert y.dtype == torch.bfloat16 and y.shape == (1, 1000)
    assert torch.isfinite(y.float()).all()


# ---- the bench's other variants: small (units (1, 1), rounded to G = 2
# with one dummy unit) and large (G = 4), logits and one step's gradients

def _variant_params(variant, engine, x, rng):
    model = JaxAlexNetDAU(variant=variant, engine=engine, train=False)
    params = jax.device_get(model.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    for name in ("dau_conv2", "dau_conv3", "dau_conv4", "dau_conv5"):
        layer = params[name]
        shape = layer["mu1"].shape
        layer["mu1"] = rng.uniform(-3.99, 3.99, shape).astype(np.float32)
        layer["mu2"] = rng.uniform(-3.99, 3.99, shape).astype(np.float32)
        layer["bias"] = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    return model, params


@pytest.mark.parametrize("engine", ["pallas_fused", "fourier"])
@pytest.mark.parametrize("variant, g", [("small", 2), ("large", 4)])
def test_variant_logits_and_gradients_match_jax(variant, g, engine):
    """Tolerances as for the default variant: the logits as in
    `test_alexnet_logits_match_jax`, the gradients as in
    `test_torch_train.py` (rtol 1e-3, floor 1e-4 * max|grad| per tensor)."""
    import optax

    rng = np.random.default_rng(0)
    x = rng.random((2, 3, IMAGE, IMAGE)).astype(np.float32)
    labels = rng.integers(0, 1000, 2)
    model, params = _variant_params(variant, engine, x, rng)

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(x))
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels))
        return loss.mean(), logits

    (_, ref), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    ref = np.asarray(ref)
    grads = params_from_flax(jax.device_get(grads))

    port = AlexNetDAU(variant=variant, engine=engine, image_size=IMAGE, device="cpu")
    assert port.dau_conv3.num_dau_units_all == g
    port.load_state_dict(params_from_flax(params))
    logits = port(torch.from_numpy(x))
    np.testing.assert_allclose(logits.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()))
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels)).backward()
    for name, p in port.named_parameters():
        want = grads[name].numpy()
        if name.endswith(".sigma"):  # not trainable
            assert p.grad is None and not np.any(want), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=name)
