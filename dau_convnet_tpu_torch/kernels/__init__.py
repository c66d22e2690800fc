from .backward import grad_tables, grad_tables_plain
from .forward import (aggregate_forward, aggregate_forward_plain, dau_forward_fused,
                      dau_forward_fused_plain)
from .fused_bwd import (FusedPlanError, fused_factored_grads_plain, fused_spectral_grads,
                        fused_spectral_grads_plain)
from .fused_fwd import fused_apply_phi, fused_apply_phi_plain
from .spectral import partial_idft, partial_idft_plain

__all__ = ["dau_forward_fused", "dau_forward_fused_plain", "aggregate_forward",
           "aggregate_forward_plain", "grad_tables", "grad_tables_plain",
           "FusedPlanError", "fused_spectral_grads", "fused_spectral_grads_plain",
           "fused_factored_grads_plain", "partial_idft", "partial_idft_plain",
           "fused_apply_phi", "fused_apply_phi_plain"]
