from .checkpoint import (latest_step, load_params_npz, params_from_flax, params_to_flax,
                         restore_checkpoint, save_checkpoint, save_params_npz)
from .math import (amax, clip_eps, clip_lower, clip_nan, clip_upper, im2col, pad2d,
                   segmented_sum, validate_dau_params)
from .profiling import device_busy_ms, device_time, kernel_ms, trace
from .tiers import (KERNEL_TIERS, MAX_SUPPORTED_OFFSET, max_offset_in_tree, retier_offset,
                    snap_kernel_tier, tier_for_params, tier_for_tree)

__all__ = ["params_from_flax", "params_to_flax", "save_params_npz", "load_params_npz",
           "save_checkpoint", "restore_checkpoint", "latest_step", "clip_lower",
           "clip_upper", "clip_eps", "clip_nan", "pad2d", "amax", "segmented_sum", "im2col",
           "validate_dau_params", "trace", "device_time", "device_busy_ms", "KERNEL_TIERS",
           "MAX_SUPPORTED_OFFSET", "snap_kernel_tier", "tier_for_params",
           "max_offset_in_tree", "tier_for_tree", "retier_offset"]
