"""The training step: on one device, or sharded over a device mesh.

Counterpart of `dau_convnet_tpu/parallel/train.py`, for one process per
device under `torch.distributed`. JAX's step is one jitted program whose
shardings let XLA partition it and insert the collectives; here every
rank runs its shard of the step and the collectives are explicit: the
F-sharded layers gather their outputs and close dx over 'model' in their
own forward and backward (`_collectives`), BatchNorm sums its statistics
over 'data', and the step averages the gradients over 'data'.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..utils import tracing
from . import _collectives
from .mesh import NamedSharding, P, axis_size, batch_sharding, param_shardings

__all__ = ["softmax_xent", "make_train_step", "TrainState", "StateShardings",
           "init_sharded", "gather_state"]


def softmax_xent(logits, labels):
    """Mean softmax cross-entropy on integer labels."""
    return F.cross_entropy(logits, labels)


class TrainState:
    """JAX's `TrainState` over the live objects of one rank: `params` and
    `extra_vars` (the persistent buffers, e.g. BatchNorm statistics) are
    the model's tensors, this rank's slices where sharded; `opt_state` the
    optimizer's slots per parameter name; `step` the steps taken."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer, step: int = 0):
        self.model, self.optimizer, self.step = model, optimizer, step

    @property
    def params(self) -> tp.Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def opt_state(self) -> tp.Dict[str, tp.Dict[str, tp.Any]]:
        return {name: dict(self.optimizer.state[p]) for name, p in self.params.items()
                if p in self.optimizer.state}

    @property
    def extra_vars(self) -> tp.Dict[str, torch.Tensor]:
        params = self.params
        return {k: v for k, v in self.model.state_dict().items() if k not in params}


class StateShardings(tp.NamedTuple):
    """The shardings of a `TrainState`: `params` and `extra_vars` by name;
    an optimizer slot shares its parameter's where it has the parameter's
    shape, and is replicated otherwise (`slot`)."""

    params: tp.Dict[str, NamedSharding]
    extra_vars: tp.Dict[str, NamedSharding]
    step: NamedSharding

    def slot(self, name: str, param: torch.Tensor, value) -> NamedSharding:
        """The sharding of optimizer slot `value` of parameter `name`: keyed
        by the parameter, not by the shape (two parameters of one shape may
        be sharded differently), as JAX's `_opt_shardings`."""
        if torch.is_tensor(value) and value.shape == param.shape:
            return self.params[name]
        return self.step


def init_sharded(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 mesh: DeviceMesh, sample_input, model_axis: str = "model"):
    """Shard a model built whole on this rank, and its optimizer, over
    `mesh`. Returns (state, state_shardings).

    Every rank builds the full model from the same seeded generator, so the
    replicas hold the single-device weights; `params_from_flax` carries
    JAX's full parameters in the same way. Each tensor is then cut to this
    rank's slice by `param_shardings`, in place, so `optimizer` (built on
    `model.parameters()`) keeps its parameters; any optimizer slot that
    exists already is cut like its parameter. Every layer that can run
    sharded (DAU layers, conv/dense `Affine`s, BatchNorm) is given the mesh.
    `sample_input` is a global batch: its rows must divide over the data
    axis."""
    batch_sharding(mesh).shard(sample_input)
    shardings = param_shardings(model, mesh, model_axis)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for key, t in model.state_dict(keep_vars=True).items():
            sh = shardings[key]
            if not any(sh.spec):
                continue
            if not hasattr(type(_owner(model, key)), "mesh"):
                raise ValueError(f"{key}: its module {type(_owner(model, key)).__name__} "
                                 "cannot run sharded")
            t.grad = None
            slots = optimizer.state.get(t, {}) if key in params else {}
            for slot, value in slots.items():
                if torch.is_tensor(value) and value.shape == t.shape:
                    slots[slot] = sh.shard(value).clone()
            t.data = sh.shard(t.data).clone()
    for module in model.modules():
        if hasattr(type(module), "mesh"):
            module.mesh = mesh
    replicated = NamedSharding(mesh, P())
    sh = StateShardings(params={k: shardings[k] for k in params},
                        extra_vars={k: v for k, v in shardings.items() if k not in params},
                        step=replicated)
    return TrainState(model, optimizer), sh


def _owner(model: torch.nn.Module, key: str) -> torch.nn.Module:
    """The module that holds the tensor of state_dict key `key`."""
    return model.get_submodule(key.rpartition(".")[0])


def gather_state(state: TrainState, state_shardings: StateShardings) -> tp.Dict[str, tp.Any]:
    """The full state, on every rank (every rank calls it): {'params',
    'opt_state', 'step', 'extra_vars'} with each tensor whole, for
    `utils.checkpoint` and for comparing with one device."""
    params = state.params
    return dict(
        params={k: state_shardings.params[k].gather(p) for k, p in params.items()},
        opt_state={k: {slot: state_shardings.slot(k, params[k], v).gather(v)
                       if torch.is_tensor(v) else v for slot, v in slots.items()}
                   for k, slots in state.opt_state.items()},
        step=state.step,
        extra_vars={k: state_shardings.extra_vars[k].gather(v)
                    for k, v in state.extra_vars.items()})


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    mesh: tp.Optional[DeviceMesh] = None,
                    state_shardings: tp.Optional[StateShardings] = None,
                    loss_fn: tp.Callable = softmax_xent):
    """The training step.

    Without a mesh, on one device: `step(x, labels) -> loss`; zero the
    grads, forward, loss, backward and one `optimizer.step()`. The loss
    comes back detached.

    With a mesh and the `state_shardings` of `init_sharded` (whose model
    it checks is the one sharded): `step(state, x, labels) -> (state,
    loss)`, JAX's sharded step. x and labels are this rank's rows of the
    global batch (`batch_sharding`, as `prefetch_to_device(...,
    sharding=)` yields them); the gradients are averaged over the data
    axis before `optimizer.step()`, so every data replica takes the update
    of the global batch's mean loss, which comes back replicated. The
    model axis's sums are in the layers themselves.

    Either step records its spans (`utils.tracing`): `train.step` over
    `train.zero_grad`, `train.forward` (model and loss), `train.backward`,
    `train.allreduce` (sharded, with a data axis) and `train.optimizer`.
    Each DAU layer of the model is named for its own spans by its name in
    `model.named_modules()`.
    """
    for name, module in model.named_modules():
        if hasattr(type(module), "trace_name"):
            module.trace_name = name
    if mesh is None:
        def step(x, labels):
            with tracing.span("train.step", adopt=True):
                with tracing.span("train.zero_grad"):
                    optimizer.zero_grad(set_to_none=True)
                with tracing.span("train.forward"):
                    loss = loss_fn(model(x), labels)
                with tracing.span("train.backward", adopt=True):
                    loss.backward()
                with tracing.span("train.optimizer"):
                    optimizer.step()
            return loss.detach()

        return step

    if state_shardings is None:
        raise ValueError("a sharded step needs the state_shardings of init_sharded")
    for key, sh in state_shardings.params.items():
        if any(sh.spec) and _owner(model, key).mesh is not mesh:
            raise ValueError(f"{key} is not sharded over this mesh: run init_sharded first")
    n_data = axis_size(mesh, "data")
    group = mesh.get_group("data") if n_data > 1 else None

    def sharded_step(state: TrainState, x, labels):
        with tracing.span("train.step", adopt=True):
            with tracing.span("train.zero_grad"):
                optimizer.zero_grad(set_to_none=True)
            with tracing.span("train.forward"):
                loss = loss_fn(model(x), labels)
            with tracing.span("train.backward", adopt=True):
                loss.backward()
            loss = loss.detach()
            if group is not None:
                with tracing.span("train.allreduce"):
                    for p in model.parameters():
                        if p.grad is not None:
                            _collectives.all_reduce(p.grad, group).div_(n_data)
                    loss = _collectives.all_reduce(loss.clone(), group) / n_data
            with tracing.span("train.optimizer"):
                optimizer.step()
        state.step += 1
        return state, loss

    return sharded_step
