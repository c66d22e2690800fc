from .checkpoint import params_from_flax
from .math import clip_nan

__all__ = ["params_from_flax", "clip_nan"]
