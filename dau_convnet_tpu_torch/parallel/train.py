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

import collections
import collections.abc
import contextlib
import typing as tp
import warnings

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.nn.modules import module as _nn_module
from torch.optim import optimizer as _optim_module

from .. import kernels
from ..utils import tracing
from . import _collectives
from .mesh import NamedSharding, P, axis_size, batch_sharding, param_shardings

__all__ = ["softmax_xent", "make_train_step", "GraphedStep", "TrainState", "StateShardings",
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


_GLOBAL_HOOKS = ("_global_forward_hooks", "_global_forward_pre_hooks", "_global_backward_hooks",
                 "_global_backward_pre_hooks")
# the spans of a capture that a replay records again, as zero-length spans
REPLAYED_SPANS = ("dau.unit_grads",)


def _on_card(x) -> bool:
    return x.is_cuda


def _frozen(v):
    """A hashable stand-in for an optimizer hyperparameter: a CUDA tensor by
    identity and version (a graph reads it where it lies, and an in-place
    write bumps the version), any other tensor by value."""
    if torch.is_tensor(v):
        return (id(v), v._version) if v.is_cuda else tuple(v.reshape(-1).tolist())
    if isinstance(v, (list, tuple)):
        return tuple(_frozen(a) for a in v)
    return v if isinstance(v, collections.abc.Hashable) else repr(v)


class GraphedStep:
    """The one-device training step of `make_train_step`: `step(x, labels)
    -> loss`, loss detached and a tensor of its own at every call.

    A call runs eager (zero the grads, forward, loss, backward, one
    `optimizer.step()`) or replays the whole step as one CUDA graph. It
    replays where all of these hold: `cuda_graph` is on; x is a CUDA tensor;
    grad mode is on; no module of the model, parameter or optimizer holds a
    hook, and no global module or optimizer hook is set (a replay runs no
    Python); its signature, the shapes, dtypes and devices of x and labels,
    `model.training`, the parameters that require grad and every
    hyperparameter of the optimizer's `param_groups`, is that of the graph
    (the graph bakes lr in). The first call that holds them after an eager
    call of the same signature (which built every lazy state: optimizer
    slots, the engines' constant tables, the kernel libraries) captures the
    graph, then replays it. A capture that raises leaves the step eager for
    that signature, with a warning the first time and the reason in
    `failures`.

    On replay x and labels are copied into the graph's own buffers; the
    gradients are the graph's tensors, rewritten in place, and `p.grad`
    points at them again after an eager call moved it. At most two replays
    are in flight: a replay first waits for the one two before it
    (`train.graph_wait`). The kernel wrappers' launch counters advance by
    what the capture counted (`kernels.advance_launch_counts`).

    `counts`: replays, captures and eager calls by reason: `off`, `cpu`,
    `no_grad`, `hooks`, `capture_failed`, `first_call` (no graph yet and
    no eager call of this signature just before), `signature` (the graph
    is another signature's). Spans: `train.step` with `graph` ('eager',
    'capture' or 'replay') and, eager, `graph_reason`; eager, its phases as
    before; on replay `train.graph_wait` and the capture's `dau.unit_grads`
    spans again, of zero length with `replayed=True` (the capture's own
    spans are recorded apart, not in the shared store).
    """

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 loss_fn: tp.Callable = softmax_xent, cuda_graph: bool = True):
        self.model, self.optimizer, self.loss_fn = model, optimizer, loss_fn
        self.cuda_graph = cuda_graph
        self.counts: tp.Counter[str] = collections.Counter()
        self.failures: tp.Dict[tuple, str] = {}
        self._graph = self._signature = self._warm = None
        self._warned = self._moved = False

    def __call__(self, x, labels):
        with tracing.span("train.step", adopt=True) as sp:
            reason, sig = self._route(x, labels)
            mode = "replay"
            if reason is None and sig != self._signature:
                mode, reason = "capture", self._capture(x, labels, sig)
            if reason is not None:
                if sp:
                    sp.set(graph="eager", graph_reason=reason)
                self.counts[reason] += 1
                return self._eager(x, labels, sig)
            if sp:
                sp.set(graph=mode)
            self.counts[mode + "s"] += 1
            if mode == "replay":
                kernels.advance_launch_counts(self._delta)
            return self._replay(x, labels)

    def _route(self, x, labels):
        """(why this call runs eager, or None; its signature)."""
        if not self.cuda_graph:
            return "off", None
        if not _on_card(x):
            return "cpu", None
        if not torch.is_grad_enabled():
            return "no_grad", None
        sig = self._sign(x, labels)
        if self._hooked():
            return "hooks", sig
        if sig in self.failures:
            return "capture_failed", sig
        if sig == self._signature or sig == self._warm:
            return None, sig
        return ("first_call" if self._graph is None else "signature"), sig

    def _sign(self, x, labels) -> tuple:
        groups = tuple(tuple(sorted((k, _frozen(v)) for k, v in g.items() if k != "params"))
                       for g in self.optimizer.param_groups)
        return (tuple(x.shape), x.dtype, x.device, tuple(labels.shape), labels.dtype,
                labels.device, self.model.training,
                tuple(id(p) for p in self.model.parameters() if p.requires_grad), groups)

    def _hooked(self) -> bool:
        opt = self.optimizer
        if (any(getattr(_nn_module, name, None) for name in _GLOBAL_HOOKS)
                or _optim_module._global_optimizer_pre_hooks
                or _optim_module._global_optimizer_post_hooks
                or getattr(opt, "_optimizer_step_pre_hooks", None)
                or getattr(opt, "_optimizer_step_post_hooks", None)):
            return True
        for m in self.model.modules():
            if m._forward_hooks or m._forward_pre_hooks or m._backward_hooks or (
                    m._backward_pre_hooks):
                return True
        return any(p._backward_hooks or getattr(p, "_post_accumulate_grad_hooks", None)
                   for p in self.model.parameters())

    def _eager(self, x, labels, sig):
        with tracing.span("train.zero_grad"):
            self.optimizer.zero_grad(set_to_none=True)
        with tracing.span("train.forward"):
            loss = self.loss_fn(self.model(x), labels)
        with tracing.span("train.backward", adopt=True):
            loss.backward()
        with tracing.span("train.optimizer"):
            self.optimizer.step()
        self._warm = sig
        self._moved = self._graph is not None
        return loss.detach()

    def _capture(self, x, labels, sig) -> tp.Optional[str]:
        """Capture the step into a new graph for `sig`: None, or the reason
        the call runs eager after a capture that raised."""
        self._graph = self._signature = None
        sx, sl = x.clone(), labels.clone()  # the graph's own inputs
        graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream(x.device)
        before = kernels.launch_counts()
        self.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize(x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        try:
            with tracing.diverted() as held, torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    loss = self.loss_fn(self.model(sx), sl)
                    loss.backward()
                    self.optimizer.step()
                except BaseException:
                    with contextlib.suppress(Exception):
                        graph.capture_end()
                    raise
                graph.capture_end()
        except Exception as e:  # noqa: BLE001 - the step runs eager instead
            kernels.advance_launch_counts(
                {k: v - kernels.launch_counts([k])[k] for k, v in before.items()})
            self.optimizer.zero_grad(set_to_none=True)
            self.failures[sig] = f"{type(e).__name__}: {e}"
            if not self._warned:
                self._warned = True
                warnings.warn(f"the train step's CUDA graph capture failed, so it runs eager "
                              f"at this signature: {self.failures[sig]}", RuntimeWarning)
            return "capture_failed"
        torch.cuda.current_stream(x.device).wait_stream(side)
        now = kernels.launch_counts()
        self._delta = {k: now[k] - before[k] for k in now if now[k] != before[k]}
        self._graph, self._signature, self._sx, self._sl = graph, sig, sx, sl
        self._loss = loss.detach()
        self._grads = [(p, p.grad) for p in self.model.parameters()]
        self._replayed = [(s.name, dict(s.attrs, replayed=True)) for s in held
                          if s.name in REPLAYED_SPANS]
        self._ring, self._launched = (torch.cuda.Event(), torch.cuda.Event()), 0
        self._moved = False
        return None

    def _replay(self, x, labels):
        done = self._ring[self._launched % 2]
        with tracing.span("train.graph_wait"):
            done.synchronize()  # the replay two before this one has finished
        self._sx.copy_(x)
        self._sl.copy_(labels)
        self._graph.replay()
        loss = self._loss.clone()
        done.record()
        self._launched += 1
        if self._moved:
            for p, g in self._grads:
                p.grad = g
            self._moved = False
        if tracing.recording():
            for name, attrs in self._replayed:
                tracing.emit(name, **attrs)
        return loss


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    mesh: tp.Optional[DeviceMesh] = None,
                    state_shardings: tp.Optional[StateShardings] = None,
                    loss_fn: tp.Callable = softmax_xent, cuda_graph: bool = True):
    """The training step.

    Without a mesh, on one device: `step(x, labels) -> loss`; zero the
    grads, forward, loss, backward and one `optimizer.step()`. The loss
    comes back detached. On a CUDA device the step captures itself as one
    CUDA graph after an eager call and replays it while nothing it can see
    changes (`GraphedStep`); `cuda_graph=False` keeps every call eager, for
    callers that watch each launch through Python.

    With a mesh and the `state_shardings` of `init_sharded` (whose model
    it checks is the one sharded): `step(state, x, labels) -> (state,
    loss)`, JAX's sharded step. x and labels are this rank's rows of the
    global batch (`batch_sharding`, as `prefetch_to_device(...,
    sharding=)` yields them); the gradients are averaged over the data
    axis before `optimizer.step()`, so every data replica takes the update
    of the global batch's mean loss, which comes back replicated. The
    model axis's sums are in the layers themselves. This step stays eager:
    its all-reduces run through gloo, which a CUDA graph cannot capture.

    Either step records its spans (`utils.tracing`): `train.step` over
    `train.zero_grad`, `train.forward` (model and loss), `train.backward`,
    `train.allreduce` (sharded, with a data axis) and `train.optimizer`
    (a replay: `GraphedStep`).
    Each DAU layer of the model is named for its own spans by its name in
    `model.named_modules()`.
    """
    for name, module in model.named_modules():
        if hasattr(type(module), "trace_name"):
            module.trace_name = name
    if mesh is None:
        return GraphedStep(model, optimizer, loss_fn, cuda_graph)

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
