"""Port vs JAX: the shared-displacement op `dau_conv2d_shared_op`.

The cases of tests/test_shared.py (N=2, S=3, G=2, F=4, 9x11, f32), run
through both packages on the same numpy inputs: the forward, and the
gradients of x, w, the (S, G) offsets (the per-f gradients summed over F by
the broadcast's adjoint) and sigma, on the engines 'xla' and 'fourier'.

Tolerance: rtol 1e-4 with an absolute floor of 1e-4*max|ref| (as
tests/test_torch_alexnet.py); the mu gradients carry the learning-rate
factor and sums over F in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dau_convnet_tpu.ops import DAUConvSettings as JaxSettings
from dau_convnet_tpu.ops.shared_engine import dau_conv2d_shared_op as jax_shared_op
from dau_convnet_tpu_torch.ops import DAUConvSettings, dau_conv2d_op, dau_conv2d_shared_op


def _case(seed=0, n=2, s=3, g=2, f=4, h=9, w=11):
    rng = np.random.default_rng(seed)
    return dict(x=rng.random((n, s, h, w)).astype(np.float32),
                w=(rng.standard_normal((s, g, f)) * 0.1).astype(np.float32),
                mu1=rng.uniform(-3, 3, (s, g)).astype(np.float32),
                mu2=rng.uniform(-3, 3, (s, g)).astype(np.float32),
                sigma=np.asarray([0.5], np.float32),
                err=rng.standard_normal((n, f, h, w)).astype(np.float32))


def _close(got, ref, name):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()),
                               err_msg=name)


@pytest.mark.parametrize("engine", ["xla", "fourier"])
def test_shared_forward_matches_jax_and_the_broadcast_op(engine):
    c = _case()
    args = [c[k] for k in ("x", "w", "mu1", "mu2", "sigma")]
    ref = np.asarray(jax.jit(lambda *a: jax_shared_op(JaxSettings(kernel_size=9, engine=engine),
                                                      *a))(*args))
    cfg = DAUConvSettings(kernel_size=9, engine=engine)
    t = [torch.from_numpy(a) for a in args]
    with torch.inference_mode():
        got = dau_conv2d_shared_op(cfg, *t).numpy()
        shape = t[1].shape
        full = dau_conv2d_op(cfg, t[0], t[1], t[2][:, :, None].expand(shape).contiguous(),
                             t[3][:, :, None].expand(shape).contiguous(), t[4]).numpy()
    _close(got, ref, "forward vs JAX")
    np.testing.assert_array_equal(got, full)


@pytest.mark.parametrize("engine", ["xla", "fourier"])
def test_shared_gradients_match_jax(engine):
    c = _case(1)
    names = ("x", "w", "mu1", "mu2", "sigma")
    args = [c[k] for k in names]
    jcfg = JaxSettings(kernel_size=9, unit_testing=True, engine=engine)

    @jax.jit
    def vjp(*a):
        return jax.vjp(lambda *b: jax_shared_op(jcfg, *b), *a)[1](c["err"])

    ref = [np.asarray(g) for g in vjp(*args)]
    cfg = DAUConvSettings(kernel_size=9, unit_testing=True, engine=engine)
    t = [torch.tensor(a, requires_grad=True) for a in args]
    dau_conv2d_shared_op(cfg, *t).backward(torch.from_numpy(c["err"]))
    for name, p, r in zip(names, t, ref):
        assert p.grad.shape == p.shape == r.shape, name
        _close(p.grad.numpy(), r, name)
    assert t[2].grad.shape == (3, 2)  # (S, G)
