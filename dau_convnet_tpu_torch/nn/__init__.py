from .layers import (DAU_UNITS_GROUP, DAUConv1d, DAUConv2d, DAUConvBlock, DAUGridMean,
                     ZeroNLast, dau_conv1d, dau_conv2d, project_dau_params, refresh_phi_cache,
                     set_dau_variables_manually)
from .norm import BatchNorm

__all__ = [
    "DAU_UNITS_GROUP",
    "DAUConv1d",
    "DAUConv2d",
    "DAUConvBlock",
    "DAUGridMean",
    "ZeroNLast",
    "dau_conv1d",
    "dau_conv2d",
    "project_dau_params",
    "refresh_phi_cache",
    "set_dau_variables_manually",
    "BatchNorm",
]
