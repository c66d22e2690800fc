"""The collectives that XLA inserts for the JAX package's sharded step,
written out for `torch.distributed`.

Every one of them is built from `all_reduce` alone: `gloo` takes only
`all_reduce` and `broadcast` for CUDA tensors (no `all_gather`, no
point-to-point), and `nccl` takes both. An all-gather is the all-reduce of
a zero-filled buffer in which each rank has written its own slice, which
is exact: every element is one rank's value plus zeros. Each call goes
through the module attribute `all_reduce`, so a caller can wrap that one
function to time or count them.

- `copy_to_model`: identity forward, all-reduce of the gradient over the
  axis backward. What enters an F-sharded layer replicated (its input, a
  replicated sigma) enters through it: the psum that closes dx.
- `gather_from_model`: the all-gather of the F-sharded slices along a dim
  forward, this rank's slice of the gradient backward.
- `all_reduce_sum`: the sum over an axis with the same sum as its
  gradient (global batch statistics).
- `halo_rows`: the rows a band needs from its neighbours along H.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_reduce", "all_gather", "copy_to_model", "gather_from_model",
           "all_reduce_sum", "halo_rows"]


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` in place over the ranks of `group`; returns it."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Concatenate the ranks' equal slices `t` along `dim`, in rank order of
    `group`: the all-reduce of a zero-filled buffer (exact)."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    dim = dim % t.dim()
    shape = list(t.shape)
    size = shape[dim]
    shape[dim] = size * n
    out = t.new_zeros(shape)
    out.narrow(dim, dist.get_rank(group) * size, size).copy_(t)
    return all_reduce(out, group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.group), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return all_gather(x.contiguous(), group, dim)

    @staticmethod
    def backward(ctx, grad):
        index = dist.get_rank(ctx.group)
        return grad.narrow(ctx.dim, index * ctx.size, ctx.size).contiguous(), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.group), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """x unchanged; its gradient summed over `group` in the backward."""
    if dist.get_world_size(group) == 1:
        return x
    return _CopyToModel.apply(x, group)


def gather_from_model(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' slices of `group` concatenated along `dim`; the gradient
    of the whole comes back as this rank's slice."""
    if dist.get_world_size(group) == 1:
        return x
    return _GatherFromModel.apply(x, group, dim % x.dim())


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group`, on every rank; its gradient is the sum of
    the ranks' gradients."""
    if dist.get_world_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def halo_rows(x: torch.Tensor, rows: int, group):
    """(above, below): the `rows` last rows (dim 2) of the previous rank's
    band and the `rows` first of the next one's, in rank order of `group`;
    None at the first and the last band. One all-reduce of a zero-filled
    buffer (n, 2, N, C, rows, W) in which each rank writes its two edges."""
    n, index = dist.get_world_size(group), dist.get_rank(group)
    if rows > x.shape[2]:
        raise ValueError(f"a halo of {rows} rows is taller than the band of {x.shape[2]}")
    if n == 1 or rows == 0:
        return None, None
    buf = x.new_zeros((n, 2, *x.shape[:2], rows, x.shape[3]))
    buf[index, 0] = x[:, :, :rows]
    buf[index, 1] = x[:, :, x.shape[2] - rows:]
    all_reduce(buf, group)
    above = buf[index - 1, 1] if index > 0 else None
    below = buf[index + 1, 0] if index < n - 1 else None
    return above, below
