from .checkpoint import params_from_flax

__all__ = ["params_from_flax"]
