from .layers import DAU_UNITS_GROUP, DAUConv2d, DAUGridMean, ZeroNLast

__all__ = ["DAU_UNITS_GROUP", "DAUConv2d", "DAUGridMean", "ZeroNLast"]
