from .dau_conv import (DAUConvSettings, dau_conv2d_infer, dau_conv2d_op, edge_gradient_mask,
                       precompute_phi)
from .gaussian import (blur_kernel_size, depthwise_blur, gaussian_factor_filters,
                       gaussian_filters, rank1_blur, rank1_blur_stack)
from .shared_engine import dau_conv2d_shared_op

__all__ = [
    "DAUConvSettings",
    "dau_conv2d_op",
    "dau_conv2d_infer",
    "dau_conv2d_shared_op",
    "precompute_phi",
    "edge_gradient_mask",
    "blur_kernel_size",
    "depthwise_blur",
    "gaussian_filters",
    "gaussian_factor_filters",
    "rank1_blur",
    "rank1_blur_stack",
]
