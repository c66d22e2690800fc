from .backward import grad_tables, grad_tables_plain
from .forward import (aggregate_forward, aggregate_forward_plain, dau_forward_fused,
                      dau_forward_fused_plain)
from .fused_bwd import (FusedPlanError, fused_factored_grads_plain, fused_spectral_grads,
                        fused_spectral_grads_plain)
from .fused_fwd import fused_apply_phi, fused_apply_phi_plain
from .probe_kernels import add_one, copy_tiles, probe_gather, probe_gemm, scale_colsum
from .spectral import partial_idft, partial_idft_plain

__all__ = ["dau_forward_fused", "dau_forward_fused_plain", "aggregate_forward",
           "aggregate_forward_plain", "grad_tables", "grad_tables_plain",
           "FusedPlanError", "fused_spectral_grads", "fused_spectral_grads_plain",
           "fused_factored_grads_plain", "partial_idft", "partial_idft_plain",
           "fused_apply_phi", "fused_apply_phi_plain", "LAUNCH_COUNTERS", "launch_counts",
           "advance_launch_counts"]

# every launch counter of the kernel wrappers: name -> (wrapper, attribute).
# A wrapper counts its launches in Python, so a replayed CUDA graph, which
# runs no Python, advances them through `advance_launch_counts`.
LAUNCH_COUNTERS = {
    "k5": (dau_forward_fused, "launches"),
    "k5_clusterless": (dau_forward_fused, "launches_clusterless"),
    "k4": (aggregate_forward, "launches"),
    "k6": (grad_tables, "launches"),
    "k1": (fused_spectral_grads, "launches_k1"),
    "k2": (fused_spectral_grads, "launches_k2"),
    "k8": (fused_spectral_grads, "launches_k8"),
    "k8_dx": (fused_spectral_grads, "launches_k8_dx"),
    "k7": (partial_idft, "launches"),
    "k3": (fused_apply_phi, "launches"),
    "probe_gemm": (probe_gemm, "launches"),
    "probe_gather": (probe_gather, "launches"),
    "scale_colsum": (scale_colsum, "launches"),
    "add_one": (add_one, "launches"),
    "copy_tiles": (copy_tiles, "launches"),
}


def launch_counts(names=None):
    """{name: count} of the launch counters named (all by default)."""
    return {k: getattr(*LAUNCH_COUNTERS[k]) for k in (LAUNCH_COUNTERS if names is None else names)}


def advance_launch_counts(delta) -> None:
    """Add {name: launches} to the counters: the launches a replayed graph
    enqueued, as counted while it was captured."""
    for k, n in delta.items():
        owner, attr = LAUNCH_COUNTERS[k]
        setattr(owner, attr, getattr(owner, attr) + n)
