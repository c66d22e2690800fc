from .layers import DAU_UNITS_GROUP, DAUConv2d, DAUGridMean, ZeroNLast, refresh_phi_cache

__all__ = ["DAU_UNITS_GROUP", "DAUConv2d", "DAUGridMean", "ZeroNLast", "refresh_phi_cache"]
