"""Port vs the C++ oracle: the op's f32 forward and analytic backward.

The port's `dau_conv2d_op` forward and `_bwd_rule` on the dense engine
('xla', f32 at precision 'highest') against `native/dau_cpu.cpp` through
`dau_convnet_tpu/ops/cpp_oracle.py`, at the reference's
`test_DAUConvQuick` configs (`test_full_matrix.py::REFERENCE_QUICK`), with
`unit_testing=True` (the reference GPU's zeroed last error row/column) on
both sides. Pass/fail is the reference tolerance policy,
`helpers.assert_matrix`.
"""

import numpy as np
import pytest
import torch

from dau_convnet_tpu.ops import cpp_oracle
from dau_convnet_tpu_torch.ops import dau_conv as tdc

from helpers import assert_matrix, random_case
from test_full_matrix import REFERENCE_QUICK

pytestmark = pytest.mark.skipif(not cpp_oracle.available(),
                                reason="native oracle not built (needs g++)")

OUTPUTS = ("bwd_error", "bwd_w_grad", "bwd_mu1_grad", "bwd_mu2_grad", "bwd_sigma_grad")


@pytest.mark.parametrize(
    "case", REFERENCE_QUICK,
    ids=lambda c: f"N{c['N']}_S{c['S']}_F{c['F']}_{c['W']}x{c['H']}_k{c['max_kernel_size']}")
def test_port_matches_cpp_oracle(case):
    rng = np.random.default_rng(0)
    # random_case's clip bound is a numpy float64, which lifts mu1 and mu2
    # to float64; the op runs in f32, as JAX's does without x64
    x, w, mu1, mu2, sigma, err = (np.asarray(a, np.float32)
                                  for a in random_case(rng, **case))
    cfg = tdc.DAUConvSettings(kernel_size=case["max_kernel_size"], unit_testing=True)
    assert cfg.engine == "xla" and cfg.precision == "highest"
    sig = np.broadcast_to(np.float32(sigma).reshape(1, 1, 1, 1), w.shape).astype(np.float32)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (x, w, mu1, mu2, sig)]

    with torch.no_grad():
        y = tdc.dau_conv2d_op(cfg, *args)
        grads = tdc._bwd_rule(cfg, *args, torch.from_numpy(err), (True,) * 5)

    assert_matrix(y.numpy(), cpp_oracle.forward(x, w, mu1, mu2, [float(sigma)]), "fwd_output")
    want = cpp_oracle.backward(x, err, w, mu1, mu2, [float(sigma)], unit_testing=True)
    for name, got, ref in zip(OUTPUTS, grads, want):
        assert got.dtype == torch.float32, name
        assert_matrix(got.numpy(), ref, name)
