"""dau_convnet_tpu_torch: the DAU ConvNet port to PyTorch and CUDA (Hopper).

A second package beside the JAX one (`dau_convnet_tpu`), which stays the
reference it is tested against. It mirrors the JAX package's module paths
and function names; each Pallas kernel becomes a hand-written sm_90a kernel
with a plain PyTorch twin used on the CPU. This package imports no JAX.
"""

__version__ = "0.1.0"

from .ops import (
    DAUConvSettings,
    blur_kernel_size,
    dau_conv2d_infer,
    dau_conv2d_op,
    depthwise_blur,
    gaussian_filters,
    precompute_phi,
)

__all__ = [
    "DAUConvSettings",
    "dau_conv2d_op",
    "dau_conv2d_infer",
    "precompute_phi",
    "blur_kernel_size",
    "depthwise_blur",
    "gaussian_filters",
    "__version__",
]
