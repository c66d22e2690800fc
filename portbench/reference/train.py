"""The reference's training steps and forward passes, in float32 with TF32
off.

`train_steps` runs softmax cross-entropy (mean over the batch) and plain
SGD, p <- p - lr * grad, computed in f32 and stored back in the dtype the
configuration stores each tensor in (so a bf16 tensor rounds as the
configured optimizer rounds it). `fp8` is the lower-precision control: both
operands of every product scaled per tensor into float8 e4m3 and back.
"""

from __future__ import annotations

import contextlib
import importlib

import torch
import torch.nn.functional as F

__all__ = ["architecture", "fp8", "no_tf32", "train_steps", "trainable", "STATS"]


def architecture(config: dict):
    """The reference module of a configuration (`reference/<architecture>.py`)."""
    return importlib.import_module(f"{__package__}.{config['architecture']}")


@contextlib.contextmanager
def no_tf32():
    """Run the enclosed block with TF32 off for matmuls and cuDNN."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8(t):
    """Per-tensor scaled float8 e4m3 rounding of `t` (the gradient passes
    through unchanged)."""
    src = t.detach()
    scale = 448.0 / src.abs().amax().clamp_min(1e-30)
    q = (src * scale).to(torch.float8_e4m3fn).float() / scale
    return t + (q - src) if t.requires_grad else q


STATS = ("running_mean", "running_var")


def trainable(config: dict):
    """Names of the tensors SGD moves: every parameter but the DAU layers'
    sigma (fixed) and the BatchNorm running statistics (buffers)."""
    return [name for name, *_ in architecture(config).param_specs(config)
            if not name.endswith(("sigma",) + STATS)]


def _storage(config, name, dau_names):
    return getattr(torch, config["dtype"]) if name in dau_names else torch.float32


def train_steps(config: dict, params: dict, batches, lr: float, quant=None):
    """SGD steps from `params` (name -> tensor as stored) over `batches`, a
    list of (f32 images, int64 labels). Returns (losses, grads of the first
    step by name, the final params by name, the first step's logits), all
    f32."""
    arch = architecture(config)
    dau_names = {name for name, *_, in_dau in arch.param_specs(config) if in_dau}
    names = trainable(config)
    with no_tf32():
        cur = {k: v.detach().float().clone() for k, v in params.items()}
        stats = {k: v for k, v in cur.items() if k.endswith(STATS)}
        losses, first, logits0 = [], None, None
        for x, y in batches:
            leaves = {k: cur[k].requires_grad_(True) for k in names}
            out = arch.forward(cur, x, config, quant=quant, train=True, stats=stats)
            logits0 = out.detach() if logits0 is None else logits0
            loss = F.cross_entropy(out, y)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
            losses.append(float(loss.detach()))
            if first is None:
                first = {k: g.detach() for k, g in zip(names, grads)}
            with torch.no_grad():
                for k, g in zip(names, grads):
                    new = (cur[k] - lr * g).to(_storage(config, k, dau_names)).float()
                    cur[k] = new
            cur.update(stats)
    return losses, first, {k: v.detach() for k, v in cur.items()}, logits0

