"""Parameter interchange with the JAX package, and checkpoints.

- `params_from_flax` turns flax variables (nested dicts of numpy arrays, as
  `jax.device_get(variables)` or `load_params_npz` give them) into the
  `state_dict` of the matching module in this package; `params_to_flax` is
  its inverse.
- `save_params_npz`/`load_params_npz` read and write the JAX package's
  portable npz: one file, keys '/'-joined paths rooted at a tree name
  ('params/dau_conv1/mu1', 'batch_stats/BatchNorm_0/var'), readable by
  either package.
- `save_checkpoint`/`restore_checkpoint`/`latest_step` keep a training
  state (model, optimizer, step) as one `torch.save` file per step under a
  directory, the newest `max_to_keep` of them.
"""

from __future__ import annotations

import os
import re
import typing as tp

import numpy as np
import torch

__all__ = ["params_from_flax", "params_to_flax", "save_params_npz", "load_params_npz",
           "save_checkpoint", "restore_checkpoint", "latest_step"]

# flax batch_stats names -> PyTorch buffer names, and flax param names that
# PyTorch calls otherwise (a BatchNorm's scale)
_STATS = {"mean": "running_mean", "var": "running_var"}
_RENAMED = {"scale": "weight"}


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bf16; widening is exact
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def params_from_flax(variables: tp.Mapping[str, tp.Any]) -> tp.Dict[str, torch.Tensor]:
    """Flax variables -> PyTorch state_dict, dotted keys by module path.

    Takes the full variables dict ({"params": ..., "batch_stats": ...}) or
    the params alone:
    - a conv `kernel` (H, W, I, O) becomes `weight` (O, I, H, W);
    - a dense `kernel` (in, out) becomes `weight` (out, in);
    - a BatchNorm's `scale` becomes `weight`, and its batch_stats `mean`
      and `var` become `running_mean` and `running_var`;
    - everything else (DAU weights/mu1/mu2 [1, S, G, F], sigma (1,), biases)
      is copied as it is, dtype kept.
    """
    if "params" in variables and isinstance(variables["params"], tp.Mapping):
        trees = [(variables["params"], {}), (variables.get("batch_stats", {}), _STATS)]
    else:
        trees = [(variables, {})]
    out: tp.Dict[str, torch.Tensor] = {}

    def walk(node, prefix, names):
        for key, val in node.items():
            if isinstance(val, tp.Mapping):
                walk(val, f"{prefix}{key}.", names)
                continue
            t = _tensor(val)
            if key == "kernel":
                key = "weight"
                t = t.permute(3, 2, 0, 1) if t.dim() == 4 else t.t()
            key = names.get(key, _RENAMED.get(key, key))
            out[prefix + key] = t.contiguous()

    for tree, names in trees:
        walk(tree, "", names)
    return out


def params_to_flax(state_dict: tp.Mapping[str, torch.Tensor]) -> tp.Dict[str, tp.Any]:
    """PyTorch state_dict -> flax variables {"params": ..., "batch_stats":
    ...} of nested dicts of numpy arrays, the inverse of `params_from_flax`
    (a 4-D `weight` is a conv kernel, a 2-D one a dense kernel, a 1-D one
    beside `running_mean` a BatchNorm scale). bf16 tensors are widened to
    f32, exactly; `num_batches_tracked` entries are skipped. `batch_stats`
    is left out when there are no statistics."""
    stats = {v: k for k, v in _STATS.items()}
    bn = {k.rsplit(".", 1)[0] for k in state_dict if k.endswith(".running_mean")}
    trees: tp.Dict[str, tp.Any] = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        *path, name = key.split(".")
        if name == "num_batches_tracked":
            continue
        a = t.detach().cpu()
        a = (a.float() if a.dtype == torch.bfloat16 else a).numpy()
        tree = "params"
        if name in stats:
            tree, name = "batch_stats", stats[name]
        elif name == "weight" and ".".join(path) in bn:
            name = "scale"
        elif name == "weight":
            name = "kernel"
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        node = trees[tree]
        for p in path:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(a)
    if not trees["batch_stats"]:
        del trees["batch_stats"]
    return trees


def save_params_npz(path: str, **trees: tp.Any) -> None:
    """Flatten named trees (nested mappings of tensors or arrays, or a bare
    tensor/array) into one npz whose keys are '/'-joined paths rooted at the
    tree name, e.g. 'params/dau_conv1/mu1': the JAX package's layout. bf16
    tensors are written as f32 (numpy has no bf16; widening is exact)."""
    flat = {}

    def leaf(v):
        if torch.is_tensor(v):
            v = v.detach().cpu()
            return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        return np.asarray(v)

    def walk(node, prefix):
        if isinstance(node, tp.Mapping):
            for key, val in node.items():
                walk(val, f"{prefix}/{key}")
        elif isinstance(node, (list, tuple)):
            for i, val in enumerate(node):
                walk(val, f"{prefix}/{i}")
        else:
            flat[prefix] = leaf(node)

    for name, tree in trees.items():
        walk(tree, name)
    np.savez(path, **flat)


def load_params_npz(path: str) -> tp.Dict[str, tp.Any]:
    """Inverse of `save_params_npz` (either package's): {tree_name: nested
    dict of numpy arrays}; a tree saved as a bare leaf comes back as the
    array itself."""
    trees: tp.Dict[str, tp.Any] = {}
    with np.load(path) as d:
        for key in d.files:
            parts = key.split("/")
            if len(parts) == 1:
                trees[parts[0]] = d[key]
                continue
            node = trees.setdefault(parts[0], {})
            for p in parts[1:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = d[key]
    return trees


_CKPT = re.compile(r"^(\d+)\.pt$")


def _steps(directory: str) -> tp.List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT.match, os.listdir(directory)) if m)


def _savable(state):
    if hasattr(state, "state_dict"):  # a module or an optimizer
        return state.state_dict()
    if isinstance(state, tp.Mapping):
        return {k: _savable(v) for k, v in state.items()}
    return state


def save_checkpoint(directory: str, step: int, state: tp.Any, max_to_keep: int = 3) -> None:
    """Save `state` at `step` as `<directory>/<step>.pt` (`torch.save`),
    then delete all but the newest `max_to_keep` steps. Modules and
    optimizers in `state` (e.g. {"model": model, "optimizer": opt, "step":
    step}) are saved as their state_dict."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"{int(step)}.pt")
    tmp = final + ".tmp"
    torch.save(_savable(state), tmp)
    os.replace(tmp, final)
    for old in _steps(directory)[:-max_to_keep]:
        os.remove(os.path.join(directory, f"{old}.pt"))


def restore_checkpoint(directory: str, state_like: tp.Any = None,
                       step: tp.Optional[int] = None) -> tp.Any:
    """Load the state saved at `step` (default: the latest) and return it.
    Where `state_like` is given, its modules and optimizers (the object
    itself, or the values of a mapping, matched by key) take their saved
    state in place. Raises FileNotFoundError when the directory holds no
    checkpoint (or not the step asked for)."""
    steps = _steps(directory)
    step = (steps[-1] if steps else None) if step is None else step
    if step is None or step not in steps:
        raise FileNotFoundError(f"no checkpoint{'' if step is None else f' {step}'} in "
                                f"{directory}")
    saved = torch.load(os.path.join(directory, f"{step}.pt"))

    def install(target, value):
        if hasattr(target, "load_state_dict"):
            target.load_state_dict(value)
        elif isinstance(target, tp.Mapping):
            for key, sub in target.items():
                install(sub, value[key])

    if state_like is not None:
        install(state_like, saved)
    return saved


def latest_step(directory: str) -> tp.Optional[int]:
    """The newest saved step under `directory`, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None
