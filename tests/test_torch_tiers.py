"""Port vs JAX: `utils/tiers.py`, the kernel-tier policy between steps.

Every function on the same inputs as JAX's: a grid of offsets (the
ValueError past 32 included), `retier_offset` over a grid of (live,
current, kernel_size), `tier_for_params` on tensors and arrays, and
`max_offset_in_tree`/`tier_for_tree` on a port AlexNet-DAU against JAX's
on the flax params `params_from_flax` carried across. Exact equality: the
policy is integer and comparison logic on the same float32 values.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dau_convnet_tpu.models import AlexNetDAU as JaxAlexNetDAU
from dau_convnet_tpu.utils import tiers as jt
from dau_convnet_tpu_torch.models import AlexNetDAU
from dau_convnet_tpu_torch.utils import params_from_flax
from dau_convnet_tpu_torch.utils import tiers as tt

OFFSETS = [0.0, 0.3, 1.0, 3.0, 3.99, 4.0, 4.01, 7.5, 8.0, 8.2, 15.9, 16.0, 16.5, 31.0,
           32.0]


def test_constants_match_jax():
    assert tt.KERNEL_TIERS == jt.KERNEL_TIERS
    assert tt.MAX_SUPPORTED_OFFSET == jt.MAX_SUPPORTED_OFFSET
    assert set(tt.__all__) == set(jt.__all__)


@pytest.mark.parametrize("offset", OFFSETS)
def test_snap_kernel_tier_matches_jax(offset):
    assert tt.snap_kernel_tier(offset) == jt.snap_kernel_tier(offset)


@pytest.mark.parametrize("offset", [32.01, 40.0, 64.0])
def test_snap_kernel_tier_refuses_past_32_as_jax(offset):
    with pytest.raises(ValueError, match="exceeds the supported bound"):
        jt.snap_kernel_tier(offset)
    with pytest.raises(ValueError, match="exceeds the supported bound"):
        tt.snap_kernel_tier(offset)


@pytest.mark.parametrize("kernel_size", [9, 17, 33])
def test_retier_offset_matches_jax(kernel_size):
    lives = [0.0, 0.4, 0.6, 1.0, 1.49, 1.5, 2.2, 2.9, 3.0, 3.1, 3.6, 5.5, 7.9, 12.0, 16.0]
    currents = [1.0, 2.0, 3.0, 4.0, 8.0, 16.0]
    for live, current, slack in itertools.product(lives, currents, (0.5, 0.0, 1.0)):
        got = tt.retier_offset(live, current, kernel_size, slack=slack)
        assert got == jt.retier_offset(live, current, kernel_size, slack=slack), (
            live, current, slack)


def test_tier_for_params_matches_jax_on_tensors_and_arrays():
    rng = np.random.default_rng(0)
    for bound in (0.5, 3.9, 7.2, 12.0):
        mu1 = rng.uniform(-bound, bound, (1, 4, 2, 5)).astype(np.float32)
        mu2 = rng.uniform(-bound, bound, (1, 4, 2, 5)).astype(np.float32)
        want = jt.tier_for_params(jnp.asarray(mu1), jnp.asarray(mu2))
        assert tt.tier_for_params(torch.from_numpy(mu1), torch.from_numpy(mu2)) == want
        assert tt.tier_for_params(mu1, mu2) == want
        b1, b2 = (torch.from_numpy(m).bfloat16() for m in (mu1, mu2))
        assert tt.tier_for_params(b1, b2) == jt.tier_for_params(b1.float().numpy(),
                                                                b2.float().numpy())


@pytest.fixture(scope="module")
def alexnet_params():
    rng = np.random.default_rng(1)
    x = jnp.zeros((1, 3, 67, 67), jnp.float32)
    params = jax.device_get(JaxAlexNetDAU(engine="xla", train=False).init(
        jax.random.PRNGKey(0), x))["params"]
    for scale, name in zip((2.5, 7.3, 1.1, 4.6), ("dau_conv2", "dau_conv3", "dau_conv4",
                                                  "dau_conv5")):
        for mu in ("mu1", "mu2"):
            shape = params[name][mu].shape
            params[name][mu] = rng.uniform(-scale, scale, shape).astype(np.float32)
    return params


def test_max_offset_in_tree_on_the_port_model_matches_jax(alexnet_params):
    want = jt.max_offset_in_tree(alexnet_params)
    assert 7.0 < want <= 7.3
    port = AlexNetDAU(image_size=67, device="cpu")
    state = params_from_flax(alexnet_params)
    port.load_state_dict(state)
    assert tt.max_offset_in_tree(port) == want
    assert tt.max_offset_in_tree(state) == want
    assert tt.tier_for_tree(port) == jt.tier_for_tree(alexnet_params) == 17
    # no DAU layer: nothing to bound
    assert tt.max_offset_in_tree(torch.nn.Linear(3, 4)) == 0.0
