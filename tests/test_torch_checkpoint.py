"""Port vs JAX: parameter interchange and checkpoints.

- The '/'-joined npz of `save_params_npz` written by either package is read
  by the other, and the model it restores gives the other's logits (f32,
  rtol 1e-4 with a floor of 1e-4*max|logits|, as tests/test_torch_alexnet.py).
- `params_from_flax` maps whole flax variables, batch_stats included, onto
  the port's state dict; `params_to_flax` inverts it bit for bit.
- `save_checkpoint`/`restore_checkpoint`/`latest_step` round-trip a model
  and an optimizer, keep `max_to_keep` steps and raise FileNotFoundError on
  an empty directory, as tests/test_checkpoint.py pins for JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dau_convnet_tpu.models import DAUCifarNet as JaxDAUCifarNet
from dau_convnet_tpu.utils import checkpoint as jck
from dau_convnet_tpu_torch.models import DAUCifarNet
from dau_convnet_tpu_torch.nn import DAUConv2d
from dau_convnet_tpu_torch.parallel import make_train_step
from dau_convnet_tpu_torch.utils import checkpoint as tck


@pytest.fixture(scope="module")
def cifar():
    """JAX DAUCifarNet variables (random statistics) and an input."""
    rng = np.random.default_rng(0)
    x = rng.random((2, 3, 32, 32)).astype(np.float32)
    net = JaxDAUCifarNet(train=False)
    v = jax.device_get(jax.jit(net.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    for name, stats in v["batch_stats"].items():
        stats["mean"] = (rng.standard_normal(stats["mean"].shape) * 0.1).astype(np.float32)
        stats["var"] = rng.uniform(0.5, 2.0, stats["var"].shape).astype(np.float32)
    return net, v, x


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


def test_npz_from_jax_loads_into_the_port(cifar, tmp_path):
    net, v, x = cifar
    path = str(tmp_path / "jax.npz")
    jck.save_params_npz(path, params=v["params"], batch_stats=v["batch_stats"])
    port = DAUCifarNet(train=False, device="cpu")
    port.load_state_dict(tck.params_from_flax(tck.load_params_npz(path)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    _close(got, np.asarray(net.apply(v, jnp.asarray(x))))


def test_npz_from_the_port_loads_into_jax(cifar, tmp_path):
    net, v, x = cifar
    port = DAUCifarNet(train=True, device="cpu", generator=torch.Generator().manual_seed(3))
    step = make_train_step(port, torch.optim.SGD(port.parameters(), lr=1e-3))
    step(torch.from_numpy(x), torch.tensor([1, 2]))  # statistics away from their init
    port.eval()
    path = str(tmp_path / "port.npz")
    tck.save_params_npz(path, **tck.params_to_flax(port.state_dict()))
    trees = jck.load_params_npz(path)
    assert set(trees) == {"params", "batch_stats"}
    assert jax.tree_util.tree_structure(trees) == jax.tree_util.tree_structure(
        {"params": v["params"], "batch_stats": v["batch_stats"]})
    ref = np.asarray(net.apply(trees, jnp.asarray(x)))
    with torch.inference_mode():
        _close(port(torch.from_numpy(x)).numpy(), ref)


def test_params_from_flax_maps_batch_stats(cifar):
    _, v, _ = cifar
    state = tck.params_from_flax(v)
    port = DAUCifarNet(device="cpu")
    assert {k: (tuple(t.shape), t.dtype) for k, t in state.items()} == {
        k: (tuple(t.shape), t.dtype) for k, t in port.state_dict().items()}
    np.testing.assert_array_equal(state["BatchNorm_1.weight"].numpy(),
                                  v["params"]["BatchNorm_1"]["scale"])
    np.testing.assert_array_equal(state["BatchNorm_2.running_var"].numpy(),
                                  v["batch_stats"]["BatchNorm_2"]["var"])
    np.testing.assert_array_equal(state["fc4.weight"].numpy(), v["params"]["fc4"]["kernel"].T)
    # the params alone still map as before
    assert set(tck.params_from_flax(v["params"])) == {
        k for k in state if not k.endswith(("running_mean", "running_var"))}
    back = tck.params_to_flax(state)
    for tree in ("params", "batch_stats"):
        for (kp, a), (kq, b) in zip(jax.tree_util.tree_leaves_with_path(back[tree]),
                                    jax.tree_util.tree_leaves_with_path(v[tree])):
            assert kp == kq
            np.testing.assert_array_equal(a, b)


def test_params_npz_bare_leaf_and_bf16(tmp_path):
    path = str(tmp_path / "leaf.npz")
    sigma = torch.full((1,), 0.5, dtype=torch.bfloat16)
    tck.save_params_npz(path, sigma=sigma, params={"w": torch.ones(2, 3)})
    for back in (tck.load_params_npz(path), jck.load_params_npz(path)):
        np.testing.assert_array_equal(back["sigma"], np.full((1,), 0.5, np.float32))
        np.testing.assert_array_equal(back["params"]["w"], np.ones((2, 3), np.float32))


def _layer(seed):
    return DAUConv2d(3, 4, (2, 1), 9, device="cpu", generator=torch.Generator().manual_seed(seed))


def test_checkpoint_roundtrip(tmp_path):
    directory = str(tmp_path / "ckpt")
    layer = _layer(0)
    opt = torch.optim.SGD(layer.parameters(), lr=0.1, momentum=0.9)
    x = torch.rand(1, 3, 8, 8)
    layer(x).sum().backward()
    opt.step()
    tck.save_checkpoint(directory, 3, {"model": layer, "optimizer": opt, "step": 3})
    assert tck.latest_step(directory) == 3

    fresh = _layer(1)
    fresh_opt = torch.optim.SGD(fresh.parameters(), lr=0.1, momentum=0.9)
    saved = tck.restore_checkpoint(directory, {"model": fresh, "optimizer": fresh_opt})
    assert saved["step"] == 3
    for k, t in layer.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], t), k
    assert torch.equal(fresh_opt.state_dict()["state"][0]["momentum_buffer"],
                       opt.state_dict()["state"][0]["momentum_buffer"])
    with torch.no_grad():
        assert torch.equal(fresh(x), layer(x))


def test_checkpoint_keeps_max_to_keep_and_restores_any_kept_step(tmp_path):
    directory = str(tmp_path / "ckpt")
    for step in (1, 5, 2, 9):
        tck.save_checkpoint(directory, step, {"step": step, "w": torch.full((2,), step)},
                            max_to_keep=2)
    assert tck.latest_step(directory) == 9
    assert tck.restore_checkpoint(directory, step=5)["step"] == 5
    assert tck.restore_checkpoint(directory)["step"] == 9
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint(directory, step=2)


@pytest.mark.parametrize("make", [False, True])
def test_restore_from_an_empty_directory_raises(tmp_path, make):
    directory = tmp_path / "nope"
    if make:
        directory.mkdir()
    assert tck.latest_step(str(directory)) is None
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint(str(directory), {"model": _layer(0)})
