"""Host-side input pipeline: batches from numpy, prefetched to the card.

Counterpart of `dau_convnet_tpu/data/loader.py`. `epoch_batches`
(:56 there) is the same shuffled iterator: the same generator state gives
the same batches, bit for bit. `prefetch_to_device` (:21 there) overlaps
the host's batch preparation and the host-to-card copy with the card's
compute: a producer thread pins each batch and copies it on a side CUDA
stream, `size` batches ahead of the consumer. Under a device mesh, JAX's
`sharding` argument takes a `parallel.NamedSharding` (`batch_sharding`,
`spatial_sharding`): each rank's pipeline moves only its own rows (or
H-band) of each global batch to its device.
"""

from __future__ import annotations

import queue
import threading
import typing as tp

import numpy as np
import torch

from ..utils import tracing

__all__ = ["prefetch_to_device", "epoch_batches"]


def _map(fn, batch):
    """fn over the arrays of a batch: an array, or a tuple, list or dict of
    them (nested)."""
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, v) for v in batch)
    return fn(batch)


def _leaves(batch) -> list:
    out = []
    _map(out.append, batch)
    return out


def _shard(batch, sharding):
    """This rank's slice of each array of the batch: `sharding` is one
    NamedSharding for all of them, or a tuple, list or dict of them in the
    batch's structure (nested)."""
    if sharding is None:
        return batch
    if isinstance(sharding, dict):
        return {k: _shard(batch[k], v) for k, v in sharding.items()}
    if isinstance(sharding, (tuple, list)):
        return type(batch)(_shard(b, sh) for b, sh in zip(batch, sharding, strict=True))
    return _map(lambda a: np.ascontiguousarray(sharding.shard(np.asarray(a))), batch)


def prefetch_to_device(batch_iter: tp.Iterator, size: int = 2,
                       device=None, sharding=None) -> tp.Iterator:
    """Wrap a host batch iterator with a `size`-deep transfer pipeline.

    Args:
      batch_iter: yields batches of numpy arrays (an array, or tuples, lists
        or dicts of them).
      size: prefetch depth (2 = double buffering).
      device: where the batches go; default the CUDA card. On "cpu" the
        batches come back as `torch.from_numpy` views, with no copy.
      sharding: a `parallel.NamedSharding` (or a tuple, list or dict of
        them in the batch's structure): each array is cut to this rank's
        slice on the host, before the copy.

    On the card, the producer thread pins each array and copies it with
    `non_blocking=True` on a side stream, then records an event. Before a
    batch is yielded, the consumer's current stream waits on that event, and
    each tensor is marked as used by that stream (`record_stream`), so the
    caching allocator cannot hand its memory to another tensor while the
    consumer's work is queued. The pinned host copies are held until their
    copy is known to have finished. An exception in the producer is raised
    in the consumer, at the point of the batch it failed on.

    Spans (`utils.tracing`): `input.produce` on the producer thread around
    each batch's pinning and copy (`bytes` moved), `input.wait` in the
    consumer around taking the next batch (`depth`: batches ready before).
    """
    device = torch.device("cuda") if device is None else torch.device(device)
    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()
    err: list = []
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def transfer(batch):
        if stream is None:
            return _map(lambda a: torch.from_numpy(np.asarray(a)).to(device), batch), None, None
        with torch.cuda.stream(stream):
            pinned = _map(lambda a: torch.from_numpy(np.asarray(a)).pin_memory(), batch)
            moved = _map(lambda t: t.to(device, non_blocking=True), pinned)
            done = torch.cuda.Event()
            done.record(stream)
        return moved, done, pinned

    def producer():
        try:
            for batch in batch_iter:
                with tracing.span("input.produce", root=True) as sp:
                    item = transfer(_shard(batch, sharding))
                    if sp:
                        sp.set(bytes=sum(t.nbytes for t in _leaves(item[0])))
                q.put(item)
        except Exception as e:  # noqa: BLE001 - raised again in the consumer
            err.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=producer, daemon=True).start()

    held = None  # (event, pinned) of the batch yielded last
    try:
        while True:
            with tracing.span("input.wait") as sp:
                if sp:
                    sp.set(depth=q.qsize())
                item = q.get()
                if held is not None:
                    held[0].synchronize()  # its copy has finished: release the pinned arrays
                    held = None
            if item is sentinel:
                if err:
                    raise err[0]
                return
            moved, done, pinned = item
            if done is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(done)
                for t in _leaves(moved):
                    t.record_stream(current)
                held = (done, pinned)
            yield moved
    finally:
        if held is not None:
            held[0].synchronize()


def epoch_batches(x, y, batch_size: int, *, rng=None, drop_remainder=True):
    """Shuffled in-memory batch iterator over (x, y) numpy arrays."""
    n = len(x)
    order = (np.random.default_rng() if rng is None else rng).permutation(n)
    end = (n // batch_size) * batch_size if drop_remainder else n
    for i in range(0, end, batch_size):
        idx = order[i:i + batch_size]
        yield x[idx], y[idx]
