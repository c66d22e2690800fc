from .forward import dau_forward_fused, dau_forward_fused_plain

__all__ = ["dau_forward_fused", "dau_forward_fused_plain"]
