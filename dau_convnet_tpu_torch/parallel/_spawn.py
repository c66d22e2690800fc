"""Run a function on every rank of a new process group, one process each.

Nothing tells a program of its cluster here: `run_ranks` starts the
processes itself (the `spawn` method: a child starts from a fresh import),
gives each `torch.distributed.init_process_group` a `tcp://localhost`
address, the world size and its rank, and collects what each returns.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import queue
import socket
import time
import traceback
import typing as tp

import torch
import torch.distributed as dist

__all__ = ["run_ranks"]


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _host(out):
    """out with every tensor as a numpy array (bf16 widened to f32): a
    tensor put on a queue is shared through its sender's memory, which is
    gone once the child has ended."""
    if torch.is_tensor(out):
        out = out.detach().cpu()
        return (out.float() if out.dtype == torch.bfloat16 else out).numpy()
    if isinstance(out, dict):
        return {k: _host(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_host(v) for v in out)
    return out


def _child(fn, rank, world_size, port, backend, timeout, threads, results, args):
    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=world_size, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, _host(out)))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: tp.Callable, world_size: int, *args, backend: str = "gloo",
              timeout: float = 600.0, threads: int = 0) -> list:
    """[fn(rank, *args) for each rank], each in its own process of a
    `world_size` process group on `backend`. fn and args must pickle (fn a
    module-level function); tensors in what fn returns (in tuples, lists
    and dicts) come back as numpy arrays. `timeout` (s) bounds the group's collectives
    and the wait for the results; `threads` > 0 sets each child's
    `torch.set_num_threads`. Raises RuntimeError with a failed rank's
    traceback; every child has ended when it returns or raises."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_child, args=(fn, rank, world_size, port, backend, timeout,
                                              threads, results, args))
             for rank in range(world_size)]
    for p in procs:
        p.start()
    outs, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(outs) < world_size:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in outs and p.exitcode]
                if dead:
                    errors.append(f"rank {dead[0]} ended with exit code "
                                  f"{procs[dead[0]].exitcode} and no result")
                    break
                if time.monotonic() > deadline:
                    errors.append(f"no result within {timeout} s")
                    break
                continue
            if ok:
                outs[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
    finally:
        for p in procs:
            p.join(timeout=10 if errors else timeout)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("run_ranks failed: " + "\n".join(errors))
    return [outs[r] for r in range(world_size)]
