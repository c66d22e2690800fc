from .dau_conv import DAUConvSettings, dau_conv2d_infer, dau_conv2d_op
from .gaussian import blur_kernel_size, depthwise_blur, gaussian_filters

__all__ = [
    "DAUConvSettings",
    "dau_conv2d_op",
    "dau_conv2d_infer",
    "blur_kernel_size",
    "depthwise_blur",
    "gaussian_filters",
]
