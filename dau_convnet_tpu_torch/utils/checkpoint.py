"""Parameter interchange with the JAX package.

`params_from_flax` turns the flax params of a JAX model (a nested dict of
numpy arrays, as `jax.device_get(variables["params"])` gives them) into the
`state_dict` of the matching module in this package.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

__all__ = ["params_from_flax"]


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bf16; widening is exact
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def params_from_flax(params: tp.Mapping[str, tp.Any]) -> tp.Dict[str, torch.Tensor]:
    """Flax params -> PyTorch state_dict, dotted keys by module path.

    - a conv `kernel` (H, W, I, O) becomes `weight` (O, I, H, W);
    - a dense `kernel` (in, out) becomes `weight` (out, in);
    - everything else (DAU weights/mu1/mu2 [1, S, G, F], sigma (1,), biases)
      is copied as it is, dtype kept.

    Accepts the full variables dict ({"params": ...}) or the params alone.
    """
    if "params" in params and isinstance(params["params"], tp.Mapping):
        params = params["params"]
    out: tp.Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, tp.Mapping):
                walk(val, f"{prefix}{key}.")
                continue
            t = _tensor(val)
            if key == "kernel":
                key = "weight"
                t = t.permute(3, 2, 0, 1) if t.dim() == 4 else t.t()
            out[prefix + key] = t.contiguous()

    walk(params, "")
    return out
