"""Port vs JAX: the fused forward (K5) and the kernel synthesis it uses.

On the CPU the port's `dau_forward_fused` computes its plain twin; the JAX
side runs the Pallas kernel in interpret mode, as tests/test_pallas.py does.
tests/test_torch_cuda.py holds the CUDA kernel against the twin on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dau_convnet_tpu.kernels import dau_forward_fused_pallas
from dau_convnet_tpu.ops import reference as oracle
from dau_convnet_tpu.ops import xla_engine as jxe
from dau_convnet_tpu.ops.gaussian import gaussian_filters
from dau_convnet_tpu_torch.kernels import forward as tk
from dau_convnet_tpu_torch.ops import xla_engine as txe

from helpers import assert_matrix

KS = 9  # synth_kernel_size of kernel_size 9
EDGE_MU = np.array([-3.99, 3.99, -3.0, 0.0, 2.0, 3.0, -0.5, -2.25, -1.75, 1.5],
                   np.float32)

CASES = {
    # name: (N, S, G, F, H, W, mu kind, use_interpolation, num_ignore)
    "random": (2, 3, 2, 4, 10, 12, "random", True, 0),
    "edges": (1, 4, 2, 5, 9, 8, "edges", True, 0),
    "no_interp": (2, 3, 2, 4, 8, 9, "random", False, 0),
    "ignore1": (1, 3, 2, 6, 7, 10, "edges", True, 1),
}


def _case(name, seed=0):
    n, s, g, f, h, w, mu_kind, interp, ignore = CASES[name]
    rng = np.random.default_rng(seed)
    x = rng.random((n, s, h, w)).astype(np.float32)
    wt = (rng.standard_normal((s, g, f)) * 0.1).astype(np.float32)
    if mu_kind == "edges":
        mu1 = rng.choice(EDGE_MU, (s, g, f))
        mu2 = rng.choice(EDGE_MU, (s, g, f))
    else:
        mu1 = rng.uniform(-3.99, 3.99, (s, g, f)).astype(np.float32)
        mu2 = rng.uniform(-3.99, 3.99, (s, g, f)).astype(np.float32)
    if ignore:
        wt[:, g - ignore:, :] = 0.0  # the op masks dummy units before synthesis
    return x, wt, mu1, mu2, interp, ignore


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_plain_matches_jax_kernel_and_oracle(name):
    x, w, mu1, mu2, interp, ignore = _case(name)
    filt = gaussian_filters(jnp.float32(0.5), size=9)["w"]
    ref = jax.jit(lambda *a: dau_forward_fused_pallas(*a, filt, KS, interp))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(mu1), jnp.asarray(mu2))
    got = tk.dau_forward_fused(_t(x), _t(w), _t(mu1), _t(mu2), _t(filt), KS, interp)
    assert got.dtype == torch.float32
    assert_matrix(got.numpy(), np.asarray(ref), f"{name}: port vs jax")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)

    gt = oracle.forward(x, w[None], mu1[None], mu2[None], [0.5],
                        num_dau_units_ignore=ignore, use_interpolation=interp)
    assert_matrix(got.numpy(), gt, f"{name}: port vs oracle")
    np.testing.assert_allclose(got.numpy(), gt, rtol=1e-5, atol=1e-5)


def test_fused_on_cpu_counts_no_launch_and_keeps_bf16():
    x, w, mu1, mu2, interp, _ = _case("random")
    filt = _t(gaussian_filters(jnp.float32(0.5), size=9)["w"])
    before = tk.dau_forward_fused.launches
    y = tk.dau_forward_fused(_t(x).bfloat16(), _t(w).bfloat16(), _t(mu1).bfloat16(),
                             _t(mu2).bfloat16(), filt, KS, interp)
    assert tk.dau_forward_fused.launches == before
    assert y.dtype == torch.bfloat16 and y.shape == (2, 4, 10, 12)
    # the twin widens to f32 and rounds once at the end
    want = tk.dau_forward_fused_plain(_t(x).bfloat16().float(), _t(w).bfloat16(),
                                      _t(mu1).bfloat16(), _t(mu2).bfloat16(),
                                      filt, KS, interp)
    assert torch.equal(y, want.bfloat16())


@pytest.mark.parametrize("bad", ["rank", "dtype", "params", "channels", "filter", "ks"])
def test_fused_rejects_bad_input(bad):
    x, w, mu1, mu2, interp, _ = _case("random")
    x, w, mu1, mu2 = _t(x), _t(w), _t(mu1), _t(mu2)
    filt, ks = _t(gaussian_filters(jnp.float32(0.5), size=9)["w"]), KS
    if bad == "rank":
        x = x[0]
    elif bad == "dtype":
        x = x.double()
    elif bad == "params":
        mu1 = mu1[:, :1]
    elif bad == "channels":
        x = x[:, :2]
    elif bad == "filter":
        filt = filt[:8, :8]
    else:
        ks = 8
    with pytest.raises((ValueError, TypeError)):
        tk.dau_forward_fused(x, w, mu1, mu2, filt, ks, interp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("interp", [True, False])
def test_synthesize_kernel_matches_jax(dtype, interp):
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((3, 2, 5)) * 0.1).astype(np.float32)
    mu1 = rng.uniform(-3.99, 3.99, (3, 2, 5)).astype(np.float32)
    mu2 = rng.choice(EDGE_MU, (3, 2, 5))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jxe.synthesize_kernel(jnp.asarray(w, jd), jnp.asarray(mu1, jd),
                                jnp.asarray(mu2, jd), KS, interp)
    got = txe.synthesize_kernel(_t(w).to(td), _t(mu1).to(td), _t(mu2).to(td),
                                KS, interp)
    assert got.dtype == td and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


def test_tap_vectors_match_jax():
    rng = np.random.default_rng(8)
    mu1 = rng.choice(EDGE_MU, (3, 2, 4))
    mu2 = rng.uniform(-3.99, 3.99, (3, 2, 4)).astype(np.float32)
    for interp in (True, False):
        ref = jxe.tap_vectors(jnp.asarray(mu1), jnp.asarray(mu2), KS, interp)
        got = txe.tap_vectors(_t(mu1), _t(mu2), KS, interp)
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)


def test_aggregate_forward_matches_jax():
    x, w, mu1, mu2, interp, _ = _case("random", seed=3)
    ref = jxe.aggregate_forward(jnp.asarray(x), jnp.asarray(w), jnp.asarray(mu1),
                                jnp.asarray(mu2), KS, interp)
    got = txe.aggregate_forward(_t(x), _t(w), _t(mu1), _t(mu2), KS, interp)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
