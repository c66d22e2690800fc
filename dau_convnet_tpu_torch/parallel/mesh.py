"""Device-mesh helpers for data- and tensor-parallel DAU training.

Counterpart of `dau_convnet_tpu/parallel/mesh.py`, for one process per
device under `torch.distributed`. The mesh is a
`torch.distributed.device_mesh.DeviceMesh` of shape (data, model) over
the default process group; each axis has its own process group. The
sharding rules are JAX's, in the port's tensor layouts:

- data parallel: the batch dim of the NCHW input over 'data'; the
  gradients are all-reduced over 'data' by the train step.
- tensor parallel: the F (out-channel) axis of every DAU parameter
  [1, S, G, F], of the dense weights (out, in) and OIHW conv weights (dim
  0, where flax's (in, out)/HWIO kernels shard their last dim) and of 1-D
  biases over 'model'. A sharded layer is column-parallel: each rank
  computes its F-slice of the output, then the slices are all-gathered
  over 'model' and everything after runs replicated on the model ranks;
  its input enters through an identity whose backward all-reduces over
  'model', the psum that closes dx (`_collectives`).

A rank's place along an axis is its rank in that axis's process group:
`NamedSharding.shard` cuts a full tensor into this rank's slice and
`NamedSharding.gather` puts the slices together again.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from . import _collectives

__all__ = ["P", "NamedSharding", "make_mesh", "dau_param_spec", "param_shardings",
           "batch_sharding", "spatial_sharding", "axis_size",
           "spatial_dau_conv2d"]


class P(tuple):
    """A partition spec, JAX's `PartitionSpec`: for each leading dim of a
    tensor the mesh axis it is split over, or None; dims past its length
    are not split."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


def make_mesh(devices=None, *, data: int = -1, model: int = 1,
              axis_names=("data", "model"), device_type: str = "cuda") -> DeviceMesh:
    """Build a (data x model) mesh over the initialised default process
    group. `devices`: the global ranks, default all of them; `data=-1`
    absorbs the ranks that `model` leaves. `device_type` is the device each
    rank computes on ('cpu' for `gloo` on the host). Every rank calls it."""
    if devices is None:
        devices = range(dist.get_world_size())
    devices = list(devices)
    n = len(devices)
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    ranks = torch.tensor(devices, dtype=torch.int).reshape(data, model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The size of `axis` in the mesh, 1 where the mesh has no such axis."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """JAX's `NamedSharding`: a tensor's `spec` over a `mesh`. Each split
    dim must divide by its axis."""

    mesh: DeviceMesh
    spec: P

    def _split(self, shape):
        """(dim, axis, size of the axis) of each split dim."""
        out = []
        for dim, axis in enumerate(self.spec):
            if axis is None:
                continue
            if not isinstance(axis, str):
                raise ValueError(f"one mesh axis per dim, got {axis!r}")
            n = axis_size(self.mesh, axis)
            if n > 1:
                if shape[dim] % n:
                    raise ValueError(f"dim {dim} of {tuple(shape)} does not divide over "
                                     f"{axis}={n}")
                out.append((dim, axis, n))
        return out

    def shard(self, t):
        """This rank's slice of a full tensor or numpy array (a view)."""
        index = [slice(None)] * len(t.shape)
        for dim, axis, n in self._split(t.shape):
            size = t.shape[dim] // n
            i = dist.get_rank(self.mesh.get_group(axis))
            index[dim] = slice(i * size, (i + 1) * size)
        return t[tuple(index)]

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The full tensor from this rank's slice `t`, on every rank (no
        gradient)."""
        t = t.detach()
        full = list(t.shape)
        for dim, axis in enumerate(self.spec):
            if axis is not None:
                full[dim] *= axis_size(self.mesh, axis)
        for dim, axis, _ in self._split(full):
            t = _collectives.all_gather(t.contiguous(), self.mesh.get_group(axis), dim)
        return t


def dau_param_spec(path: tp.Tuple[str, ...], value, model_axis: str = "model") -> P:
    """The partition spec of one parameter by name and rank, JAX's rule in
    the port's layouts: DAU weights/mu1/mu2 [1, S, G, F] on dim 3; a conv or
    dense `weight` of rank >= 2 ((out, in) or OIHW) and a 1-D `bias` on dim
    0; everything else (sigma, a BatchNorm's 1-D weight, its statistics)
    replicated."""
    name = path[-1] if path else ""
    shape = tuple(getattr(value, "shape", ()))
    if name in ("weights", "mu1", "mu2") and len(shape) == 4:
        return P(None, None, None, model_axis)
    if name == "weight" and len(shape) >= 2:
        return P(model_axis, *([None] * (len(shape) - 1)))
    if name == "bias" and len(shape) == 1:
        return P(model_axis)
    return P()


def param_shardings(model: torch.nn.Module, mesh: DeviceMesh,
                     model_axis: str = "model") -> tp.Dict[str, NamedSharding]:
    """{state_dict key: NamedSharding} by `dau_param_spec`, for the
    parameters and the persistent buffers (JAX's variables). Everything is
    replicated when the model axis has size 1, and so is any tensor whose
    dim the axis does not divide."""
    tp_on = axis_size(mesh, model_axis) > 1
    out = {}
    for key, v in model.state_dict(keep_vars=True).items():
        spec = dau_param_spec(tuple(key.split(".")), v, model_axis) if tp_on else P()
        for dim, ax in enumerate(spec):
            if ax is not None and v.shape[dim] % axis_size(mesh, ax):
                spec = P()
                break
        out[key] = NamedSharding(mesh, spec)
    return out


def batch_sharding(mesh: DeviceMesh, data_axis: str = "data") -> NamedSharding:
    """NCHW (or any batch-major) tensors: the batch over the data axis."""
    return NamedSharding(mesh, P(data_axis))


def spatial_sharding(mesh: DeviceMesh, axis: str = "data") -> NamedSharding:
    """The H dimension of NCHW inputs over `axis`: each rank holds a band of
    rows (`spatial_dau_conv2d`)."""
    return NamedSharding(mesh, P(None, None, axis, None))


def spatial_dau_conv2d(cfg, x, w, mu1, mu2, sigma, mesh: DeviceMesh, axis: str = "data"):
    """The DAU convolution's forward on an H-band `x` of `spatial_sharding`:
    this rank's band of the output. The band takes from its neighbours the
    rows the blur and the aggregation reach across its edges (the blur
    radius plus the synthesized kernel's, `ceil(max_offset)` with
    interpolation) through one exchange of edge rows, runs the op on the
    widened band and keeps its own rows. Its zero padding at the widened
    band's ends is the op's at the image's borders, and inside the image it
    reaches only the rows that are dropped. Forward only, as JAX's test of
    its spatial sharding."""
    from ..ops.dau_conv import dau_conv2d_infer

    rows = cfg.blur_size // 2 + cfg.synth_kernel_size // 2
    above, below = _collectives.halo_rows(x, rows, mesh.get_group(axis))
    parts = [t for t in (above, x, below) if t is not None]
    y = dau_conv2d_infer(cfg, torch.cat(parts, dim=2), w, mu1, mu2, sigma)
    start = 0 if above is None else rows
    return y[:, :, start:start + x.shape[2]]
