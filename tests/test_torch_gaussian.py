"""Port vs JAX: blur filters, filter size and depthwise blur."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dau_convnet_tpu.ops import gaussian as jg
from dau_convnet_tpu_torch.ops import gaussian as tg

MODES = [
    dict(),
    dict(unit_normalization=False),
    dict(square_unit_normalization=True),
    dict(single_dim_kernel=True),
    dict(forbid_positive_dim1=True),
    dict(single_dim_kernel=True, forbid_positive_dim1=True,
         square_unit_normalization=True),
]


@pytest.mark.parametrize("mode", MODES, ids=lambda m: "-".join(m) or "unit")
@pytest.mark.parametrize("sigma,size", [(0.5, 9), (0.8, 9), (1.3, 15)])
def test_gaussian_filters_match_jax(mode, sigma, size):
    ref = jg.gaussian_filters(jnp.float32(sigma), size=size, **mode)
    got = tg.gaussian_filters(torch.tensor(sigma), size=size, **mode)
    assert set(got) == set(ref)
    for name in ref:
        want = np.asarray(ref[name])
        atol = 1e-7
        if mode.get("square_unit_normalization"):
            # the square-mode correction d/z - g_n*ss cancels terms ~40x the
            # result, so the f32 sums' order (XLA sums sequentially, torch
            # pairwise) shows at ~1e-6 of the largest entry in both
            # packages alike (each is ~4e-7 off the float64 oracle)
            atol = 1e-6 * float(np.abs(want).max())
        np.testing.assert_allclose(got[name].numpy(), want,
                                   rtol=1e-6, atol=atol, err_msg=name)


@pytest.mark.parametrize("sigma", [0.3, 0.5, 0.9, 1.6, 3.0])
def test_blur_kernel_size_matches_jax(sigma):
    assert tg.blur_kernel_size(sigma) == jg.blur_kernel_size(sigma)


def test_blur_kernel_size_rejects_huge_sigma():
    with pytest.raises(ValueError):
        tg.blur_kernel_size(3.5)


def test_depthwise_blur_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 10, 12)).astype(np.float32)
    filt = jg.gaussian_filters(jnp.float32(0.6), size=9)["w"]
    ref = jg.depthwise_blur(jnp.asarray(x), filt)
    got = tg.depthwise_blur(torch.from_numpy(x), torch.tensor(np.asarray(filt)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
