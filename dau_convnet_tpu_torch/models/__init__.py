from .alexnet import ALEXNET_DAU_VARIANTS, AlexNetDAU

__all__ = ["AlexNetDAU", "ALEXNET_DAU_VARIANTS"]
