"""What the benchmark takes from the program under test: the model class a
configuration names, its training step, its input pipeline and its launch
counters. Nothing else of the program is read.
"""

from __future__ import annotations

import importlib
import typing as tp

import torch

__all__ = ["build_model", "COUNTERS", "read_counters", "LaunchProbe"]

# kernel -> (module, function, counter attribute) of the program's launch counters
COUNTERS = {
    "K5": ("dau_convnet_tpu_torch.kernels.forward", "dau_forward_fused", "launches"),
    "K4": ("dau_convnet_tpu_torch.kernels.forward", "aggregate_forward", "launches"),
    "K6": ("dau_convnet_tpu_torch.kernels.backward", "grad_tables", "launches"),
    "K1": ("dau_convnet_tpu_torch.kernels.fused_bwd", "fused_spectral_grads", "launches_k1"),
    "K2": ("dau_convnet_tpu_torch.kernels.fused_bwd", "fused_spectral_grads", "launches_k2"),
    "K8": ("dau_convnet_tpu_torch.kernels.fused_bwd", "fused_spectral_grads", "launches_k8"),
}


def read_counters() -> tp.Dict[str, int]:
    """The program's launch counters, by kernel."""
    return {k: int(getattr(getattr(importlib.import_module(m), fn), attr))
            for k, (m, fn, attr) in COUNTERS.items()}


def build_model(config: dict, traffic: dict, weights: dict, device) -> torch.nn.Module:
    """The configuration's model class with its keyword arguments (the
    traffic mix's `model_kwargs` over them), in the configuration's dtype on
    `device`, holding `weights` (every tensor of its state dict)."""
    prog = config["program"]
    cls = getattr(importlib.import_module(prog["module"]), prog["class"])
    kwargs = {**prog["kwargs"], **traffic.get("model_kwargs", {})}
    model = cls(**kwargs, dtype=getattr(torch, config["dtype"]), device=device)
    model.load_state_dict(weights, strict=True)
    return model


class LaunchProbe:
    """Launches of each kernel in each DAU layer's forward and backward,
    from the counters read around the layer by module hooks. Attach, run
    one step, detach: `counts[name] = {"forward": {...}, "backward": {...}}`."""

    def __init__(self, model: torch.nn.Module, layer_names: tp.Sequence[str]):
        self.counts: tp.Dict[str, dict] = {n: {"forward": {}, "backward": {}} for n in layer_names}
        self._handles = []
        for name in layer_names:
            mod = model.get_submodule(name)
            snap: dict = {}
            self._handles += [
                mod.register_forward_pre_hook(self._pre(snap)),
                mod.register_forward_hook(self._post(snap, name, "forward")),
                mod.register_full_backward_pre_hook(self._pre(snap)),
                mod.register_full_backward_hook(self._post(snap, name, "backward"))]

    @staticmethod
    def _pre(snap):
        def hook(*_):
            snap.clear()
            snap.update(read_counters())
        return hook

    def _post(self, snap, name, phase):
        def hook(*_):
            now = read_counters()
            for k, v in now.items():
                d = self.counts[name][phase]
                d[k] = d.get(k, 0) + v - snap.get(k, v)
        return hook

    def detach(self):
        for h in self._handles:
            h.remove()
        self._handles = []
