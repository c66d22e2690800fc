from .loader import epoch_batches, prefetch_to_device

__all__ = ["epoch_batches", "prefetch_to_device"]
