"""The training step, on one device.

Counterpart of the single-device part of `dau_convnet_tpu/parallel/train.py`:
the loss and `make_train_step`. The mesh, the sharded parameters and
`init_sharded` are not ported yet (ROADMAP.md §1).
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F

__all__ = ["softmax_xent", "make_train_step"]


def softmax_xent(logits, labels):
    """Mean softmax cross-entropy on integer labels."""
    return F.cross_entropy(logits, labels)


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: tp.Callable = softmax_xent):
    """`step(x, labels) -> loss`: zero the grads, forward, loss, backward
    and one `optimizer.step()`. The loss comes back detached."""

    def step(x, labels):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model(x), labels)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
