"""Rank functions of the port's sharded CPU tests
(`tests/test_torch_parallel_mesh.py`, `tests/test_torch_parallel_train.py`).

Each runs in one process of a 4-process `gloo` group started by
`dau_convnet_tpu_torch.parallel._spawn.run_ranks`, computes every sharded
case of its test file at once and returns the results, which the test
process holds against JAX's sharded runs. This module imports no JAX, so
the children start with the port alone.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F

from dau_convnet_tpu_torch.data import epoch_batches, prefetch_to_device
from dau_convnet_tpu_torch.models import AlexNetDAU, DAUCifarNet, DAUResNet
from dau_convnet_tpu_torch.models._common import Affine
from dau_convnet_tpu_torch.nn import DAUConv2d
from dau_convnet_tpu_torch.ops import DAUConvSettings, dau_conv2d_op
from dau_convnet_tpu_torch.parallel import (P, NamedSharding, batch_sharding, gather_state,
                                            init_sharded, make_mesh, make_train_step,
                                            param_shardings, spatial_dau_conv2d,
                                            spatial_sharding)
from dau_convnet_tpu_torch.parallel import _collectives
from dau_convnet_tpu_torch.utils import tracing

WORLD = 4
MESHES = ((4, 1), (2, 2))


class TinyDAUNet(torch.nn.Module):
    """`tests/test_distributed.py`'s TinyDAUNet: DAUConv2d(8, units (2, 1),
    ks 9, no bias) -> ReLU -> spatial mean -> Dense(4), under flax's module
    names so JAX's variables load through `params_from_flax`."""

    def __init__(self, engine: str = "xla", sigma_trainable: bool = False):
        super().__init__()
        self.DAUConv2d_0 = DAUConv2d(3, 8, (2, 1), 9, use_bias=False, engine=engine,
                                     dau_sigma_trainable=sigma_trainable, device="cpu")
        self.Dense_0 = Affine((4, 8), 8, "cpu", None)

    def forward(self, x):
        x = F.relu(self.DAUConv2d_0(x)).mean(dim=(2, 3))
        return self.Dense_0.dense(x, torch.float32)


def build(kind: str, engine: str) -> torch.nn.Module:
    if kind == "cifar":
        return DAUCifarNet(train=True, device="cpu")
    return TinyDAUNet(engine, sigma_trainable=kind == "tiny_sigma")


def _meshes():
    return {shape: make_mesh(model=shape[1], device_type="cpu") for shape in MESHES}


class _Logs(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def train_cases(rank, cases):
    """Each case {kind, engine, mesh, state, x, y, lr, momentum, steps}: the
    model of `build` from the full `state`, sharded by `init_sharded`, takes
    `steps` sharded SGD steps on this rank's rows of (x, y). Returns per
    case the losses (every rank) and, on rank 0, the gathered params,
    momentum buffers and buffers; and the errors of the step's guards."""
    meshes = _meshes()
    out = {}
    for key, c in cases.items():
        mesh = meshes[c["mesh"]]
        model = build(c["kind"], c["engine"])
        model.load_state_dict({k: torch.from_numpy(v) for k, v in c["state"].items()})
        opt = torch.optim.SGD(model.parameters(), lr=c["lr"], momentum=c["momentum"])
        state, sh = init_sharded(model, opt, mesh, c["x"])
        step = make_train_step(model, opt, mesh, sh)
        bsh = batch_sharding(mesh)
        x, y = torch.from_numpy(bsh.shard(c["x"])), torch.from_numpy(bsh.shard(c["y"]))
        losses = []
        for _ in range(c["steps"]):
            state, loss = step(state, x, y)
            losses.append(float(loss))
        full = gather_state(state, sh)
        res = dict(losses=losses, step=state.step,
                   specs={k: tuple(v.spec) for k, v in sh.params.items()},
                   local={k: tuple(p.shape) for k, p in state.params.items()},
                   slots={k: tuple(s["momentum_buffer"].shape)
                          for k, s in state.opt_state.items()})
        if rank == 0:
            res.update(params=full["params"], extra=full["extra_vars"],
                       momentum={k: s["momentum_buffer"] for k, s in full["opt_state"].items()})
        out[key] = res
    out["guards"] = _guards(meshes[(2, 2)])
    return out


def _guards(mesh):
    """The messages of the sharded step's refusals: a model that
    `init_sharded` has not sharded, and a module that cannot run sharded."""
    errors = []
    model, other = TinyDAUNet(), TinyDAUNet()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    _, sh = init_sharded(other, torch.optim.SGD(other.parameters(), lr=0.1), mesh,
                         np.zeros((8, 3, 8, 8), np.float32))
    try:
        make_train_step(model, opt, mesh, sh)
    except ValueError as e:
        errors.append(str(e))
    linear = torch.nn.Sequential(torch.nn.Linear(4, 8))
    try:
        init_sharded(linear, torch.optim.SGD(linear.parameters(), lr=0.1), mesh,
                     np.zeros((8, 4), np.float32))
    except ValueError as e:
        errors.append(str(e))
    return errors


def mesh_cases(rank, spec):
    """Every case of tests/test_torch_parallel_mesh.py on this rank; see the
    test file for what each holds."""
    meshes = _meshes()
    tp_mesh, dp_mesh = meshes[(2, 2)], meshes[(4, 1)]
    out = {}
    models = {"alexnet": lambda: AlexNetDAU(num_classes=999, image_size=67, device="cpu"),
              "cifar": lambda: DAUCifarNet(device="cpu"),
              "resnet": lambda: DAUResNet(device="cpu")}
    for name, make in models.items():
        out[f"specs {name}"] = {k: tuple(s.spec) for k, s in param_shardings(make(), tp_mesh).items()}
    out["specs cifar dp"] = {k: tuple(s.spec)
                             for k, s in param_shardings(DAUCifarNet(device="cpu"), dp_mesh).items()}

    x, y = spec["x"], spec["y"]
    for shape, mesh in meshes.items():
        for kind, sh in (("batch", batch_sharding(mesh)), ("spatial", spatial_sharding(mesh))):
            out[f"shard {kind} {shape}"] = sh.shard(x).copy()
        two_d = NamedSharding(mesh, P("data", "model"))
        out[f"roundtrip {shape}"] = two_d.gather(torch.from_numpy(two_d.shard(spec["m"]).copy()))
        for kind, sh in (("batch", batch_sharding(mesh)),
                         ("spatial", (spatial_sharding(mesh), NamedSharding(mesh, P())))):
            out[f"prefetch {kind} {shape}"] = [
                tuple(t.numpy().copy() for t in b) for b in prefetch_to_device(
                    epoch_batches(x, y, 4, rng=np.random.default_rng(0)), device="cpu",
                    sharding=sh)]

    group = tp_mesh.get_group("model")
    a = torch.ones(3, requires_grad=True)
    (_collectives.copy_to_model(a, group) * (rank + 1)).sum().backward()
    b = (torch.arange(2.0) + 10 * (rank % 2)).requires_grad_()
    gathered = _collectives.gather_from_model(b, group, 0)
    (gathered * torch.arange(4.0)).sum().backward()
    out["collectives"] = dict(copy_grad=a.grad, gathered=gathered, gather_grad=b.grad)

    out["op"] = {key: _sharded_op(tp_mesh, spec["op"], *key) for key in spec["op_configs"]}
    out["spatial"] = {engine: _spatial(dp_mesh, spec["spatial"], engine)
                      for engine in ("xla", "fourier")}
    return out


def _sharded_op(mesh, arrays, gather, fused_dx):
    """The op on this rank's rows and F-slice under fused_bwd='on', its
    backward from the error; the unit gradients all-reduced over 'data' as
    the step does. Returns the gathered y, dx, dw, dmu1, dmu2, dsig (rank
    0), the op's log lines and the attrs of its `dau.unit_grads` spans."""
    cfg = DAUConvSettings(kernel_size=9, engine="fourier", fused_bwd="on", fused_dx=fused_dx,
                          fused_gather=gather)
    bsh = batch_sharding(mesh)
    fsh = NamedSharding(mesh, P(None, None, None, "model"))
    esh = NamedSharding(mesh, P("data", "model"))
    x = torch.from_numpy(bsh.shard(arrays["x"]).copy()).requires_grad_()
    params = [torch.from_numpy(fsh.shard(arrays[k]).copy()).requires_grad_()
              for k in ("w", "mu1", "mu2", "sig")]
    logs = _Logs()
    logger = logging.getLogger("dau_convnet_tpu_torch.ops.dau_conv")
    logger.addHandler(logs)
    old_level = logger.level
    logger.setLevel(logging.INFO)
    tracing.clear()
    try:
        with tracing.record():
            y = dau_conv2d_op(cfg, x, *params, mesh=mesh)
            y.backward(torch.from_numpy(esh.shard(arrays["err"]).copy()))
    finally:
        logger.removeHandler(logs)
        logger.setLevel(old_level)
    unit_grads = [s.attrs for s in tracing.spans() if s.name == "dau.unit_grads"]
    tracing.clear()
    data = mesh.get_group("data")
    grads = [fsh.gather(_collectives.all_reduce(p.grad, data)) for p in params]
    return dict(y=esh.gather(y), dx=bsh.gather(x.grad), grads=grads, logs=logs.lines,
                unit_grads=unit_grads)


def _spatial(mesh, arrays, engine):
    """The op's forward on this rank's H-band, gathered."""
    cfg = DAUConvSettings(kernel_size=9, engine=engine)
    sh = spatial_sharding(mesh)
    band = torch.from_numpy(sh.shard(arrays["x"]).copy())
    params = [torch.from_numpy(arrays[k]) for k in ("w", "mu1", "mu2", "sig")]
    return sh.gather(spatial_dau_conv2d(cfg, band, *params, mesh))
