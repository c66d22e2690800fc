from .checkpoint import (latest_step, load_params_npz, params_from_flax, params_to_flax,
                         restore_checkpoint, save_checkpoint, save_params_npz)
from .math import (amax, clip_eps, clip_lower, clip_nan, clip_upper, im2col, pad2d,
                   segmented_sum, validate_dau_params)

__all__ = ["params_from_flax", "params_to_flax", "save_params_npz", "load_params_npz",
           "save_checkpoint", "restore_checkpoint", "latest_step", "clip_lower",
           "clip_upper", "clip_eps", "clip_nan", "pad2d", "amax", "segmented_sum", "im2col",
           "validate_dau_params"]
