"""Train AlexNet-DAU end to end on the card for >= 1k steps (synthetic data).

Counterpart of `examples/train_alexnet_synth.py` (the JAX example, :1-192):
memorize a fixed synthetic dataset with the full net at production shapes
(N=32, 3x227x227, bf16, the fourier engine, whose unit gradients come from
the fused spectral kernel K1 at conv3-conv5), showing

- loss descent over >= 1,000 optimizer steps (global-norm clip 1.0, then
  Adam), every loss finite (the reference's test_DAUConvMemtest role);
- stable step time, per chunk of `--chunk` steps: the JAX example's
  `lax.scan` chunk becomes a Python loop whose losses stay on the card and
  are fetched once per chunk, timed by CUDA events;
- a checkpoint mid-run (`utils.checkpoint`), the live model and optimizer
  thrown away, fresh ones restored from it and trained on, their probe
  logits equal to the old ones' exactly;
- the parameters kept within the reference bounds by `project_dau_params`
  after every step (base_dau_conv_layer.cu:33-49).

    python -m dau_convnet_tpu_torch.examples.train_alexnet_synth --steps 1000

It runs on the CUDA card, and on the CPU only under `--device cpu`. It
writes the JSON record (loss curve, chunk times, resume check) to --out,
prints it without the curve, and prints TRAIN_OK. `make_step` and
`train` are module-level, so tests drive the chunk loop and the resume on
a small model (`train(build, ...)` takes the model's builder).

torch's `clip_grad_norm_` scales by 1/(norm + 1e-6) where optax's
`clip_by_global_norm` scales by 1/norm; torch's and optax's Adam agree
(b1 0.9, b2 0.999, eps 1e-8).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from ..bench import device_label
from ..models import AlexNetDAU
from ..nn import project_dau_params
from ..utils import checkpoint as ckpt
from ..utils.tiers import max_offset_in_tree
from . import device_for

__all__ = ["make_data", "make_step", "train", "parse_args", "main"]


def make_data(num_batches: int, n: int, classes: int, dtype, device, image_size: int = 227):
    """The fixed dataset, from `np.random.default_rng(0)` as in JAX: images
    (num_batches, n, 3, S, S) in `dtype` and random labels (num_batches, n)
    on `device`. The labels are random, so the loss descends only if the
    net memorizes through its DAU layers."""
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.random((num_batches, n, 3, image_size, image_size)))
    labels = torch.from_numpy(rng.integers(0, classes, (num_batches, n)))
    return data.to(device=device, dtype=dtype), labels.to(device)


def make_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer, kernel_size: int):
    """`step(x, y) -> loss` (0-d, on the device): forward, mean softmax
    cross-entropy, backward, the gradients clipped to global norm 1.0 (it
    guards the late-memorization regime: an unclipped JAX run memorized to
    loss ~0.003 by step 500, then an Adam update blew it up to ~3.9), the
    optimizer's step and the DAU parameters projected into their bounds."""

    def step(x, y):
        optimizer.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(model.parameters(), 1.0)
        optimizer.step()
        project_dau_params(model, kernel_size=kernel_size)
        return loss.detach()

    return step


def _timed(fn, device: torch.device):
    """(fn(), ms it took): CUDA events on the card, the host clock on the
    CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def train(build: tp.Callable[[], tp.Tuple[torch.nn.Module, torch.optim.Optimizer]],
          data: torch.Tensor, labels: torch.Tensor, *, steps: int, chunk: int,
          ckpt_dir: str, kernel_size: int, log=print) -> dict:
    """The chunk loop: `steps` steps (whole chunks) over the fixed batches
    in turn, from the model and optimizer `build()` returns. At the first
    chunk end past steps // 2 it saves both, builds fresh ones, restores
    them from the checkpoint and trains on with them; the probe logits
    (batch 0) before and after must be equal exactly. Returns the model
    trained last and a dict of the losses, the ms a step of each chunk and
    the resume's fields."""
    model, opt = build()
    step_fn = make_step(model, opt, kernel_size)
    device = data.device
    nb = data.shape[0]
    losses: list = []
    chunk_ms: list = []
    resume_delta = restore_s = None
    if os.path.isdir(ckpt_dir):
        shutil.rmtree(ckpt_dir)
    i = 0
    while i < steps:
        def run_chunk(start=i):
            return torch.stack([step_fn(data[(start + k) % nb], labels[(start + k) % nb])
                                for k in range(chunk)])
        chunk_losses, ms = _timed(run_chunk, device)
        chunk_losses = chunk_losses.float().cpu().numpy()
        i += chunk
        losses.extend(float(v) for v in chunk_losses)
        chunk_ms.append(ms / chunk)
        live = max_offset_in_tree(model)
        log(f"step {i:5d}  loss {chunk_losses[-1]:.4f}  {ms / chunk:7.2f} ms/step  "
            f"max|mu| {live:.3f}")
        if not np.all(np.isfinite(chunk_losses)):
            raise FloatingPointError(f"non-finite loss in the chunk ending at step {i}")

        # mid-run: checkpoint, throw the live state away, RESTORE, continue
        if resume_delta is None and i >= steps // 2:
            ckpt.save_checkpoint(ckpt_dir, i, {"model": model, "opt": opt})
            with torch.no_grad():
                probe = model(data[0])
            t0 = time.perf_counter()
            model, opt = build()
            ckpt.restore_checkpoint(ckpt_dir, {"model": model, "opt": opt})
            if device.type == "cuda":
                torch.cuda.synchronize()
            restore_s = round(time.perf_counter() - t0, 1)
            step_fn = make_step(model, opt, kernel_size)
            with torch.no_grad():
                probe2 = model(data[0])
            resume_delta = float((probe.float() - probe2.float()).abs().max())
            log(f"checkpoint+resume at step {i}: logits delta {resume_delta}")
            if resume_delta != 0.0:
                raise RuntimeError("resume changed the model")
    return model, dict(losses=losses, chunk_ms=chunk_ms, resume_logits_delta=resume_delta,
                       restore_transfer_s=restore_s)


def record_of(run: dict, model: torch.nn.Module, variant: str, kernel_size: int,
              device_name: str) -> dict:
    """The JAX example's record (:167-182) from `train`'s results."""
    losses, chunk_ms = run["losses"], run["chunk_ms"]
    live = max_offset_in_tree(model)
    # stable step time: median of the steady-state chunks; chunks > 3x the
    # median are warm-up or transfer events (the first chunk's kernel builds),
    # reported in chunk_ms_per_step but excluded from the spread
    med = float(np.median(chunk_ms))
    steady = [c for c in chunk_ms if c < 3 * med] or chunk_ms
    stability = (max(steady) - min(steady)) / (sum(steady) / len(steady))
    return {
        "variant": variant,
        "dau_units": model.num_dau_units() if hasattr(model, "num_dau_units") else None,
        "steps": len(losses),
        "loss_first20_mean": round(float(np.mean(losses[:20])), 4),
        "loss_last20_mean": round(float(np.mean(losses[-20:])), 4),
        "loss_curve_every10": [round(float(v), 4) for v in losses[::10]],
        "step_ms_steady_mean": round(sum(steady) / len(steady), 2),
        "step_ms_spread_frac": round(stability, 4),
        "chunk_ms_per_step": [round(c, 2) for c in chunk_ms],
        "resume_logits_delta": run["resume_logits_delta"],
        "restore_transfer_s": run["restore_transfer_s"],
        "final_max_abs_mu": round(float(live), 4),
        "mu_bound": kernel_size // 2 - 0.01,
        "device": device_name,
    }


def parse_args(argv=None):
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--chunk", type=int, default=50,
                    help="steps per chunk (host logging and checkpointing happen "
                         "between chunks)")
    ap.add_argument("--variant", default="small", choices=["small", "default", "large"])
    ap.add_argument("--N", type=int, default=32)
    ap.add_argument("--num-batches", type=int, default=8,
                    help="fixed synthetic batches to memorize")
    ap.add_argument("--classes", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tmp, "alexnet_synth_ckpt"))
    ap.add_argument("--out", default=os.path.join(tmp, "alexnet_synth_train.json"))
    ap.add_argument("--device", choices=["default", "cpu"], default="default",
                    help="default: the CUDA card; cpu runs on the CPU")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train, check, write the record and print it; returns the record."""
    args = parse_args(argv)
    dev = device_for(args.device)
    dtype = torch.bfloat16
    data, labels = make_data(args.num_batches, args.N, args.classes, dtype, dev)

    def build():
        model = AlexNetDAU(variant=args.variant, num_classes=args.classes, dtype=dtype,
                           engine="fourier", device=dev,
                           generator=torch.Generator(dev).manual_seed(0))
        return model, torch.optim.Adam(model.parameters(), lr=args.lr)

    first, _ = build()
    kernel_size = first.dau_conv2.max_kernel_size
    print(f"AlexNet-DAU-{args.variant}: {first.num_dau_units()} DAU units, "
          f"{sum(p.numel() for p in first.parameters())} params", flush=True)
    del first
    model, run = train(build, data, labels, steps=args.steps, chunk=args.chunk,
                       ckpt_dir=args.ckpt_dir, kernel_size=kernel_size,
                       log=lambda s: print(s, flush=True))
    record = record_of(run, model, args.variant, kernel_size, device_label(dev))
    live, bound = max_offset_in_tree(model), record["mu_bound"]
    if not live <= bound + 1e-6:
        raise RuntimeError(f"mu escaped bounds: {live} > {bound}")
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({k: v for k, v in record.items() if k != "loss_curve_every10"}),
          flush=True)
    if not record["loss_last20_mean"] < record["loss_first20_mean"]:
        raise RuntimeError("loss did not descend")
    print("TRAIN_OK", flush=True)
    return record


if __name__ == "__main__":
    main()
