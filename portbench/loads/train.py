"""Closed-loop training: one SGD step after another on batches of the mix's
size from a seeded uint8 dataset, through the program's loader.

Set-up builds the model with the seed's weights, the dataset, the loader
(`epoch_batches`, shuffled epochs chained, under `prefetch_to_device`) and
one training step (`make_train_step` with SGD). The first `check_steps`
steps go through that step and feed and are the ones checked against the
reference; one more step runs with each DAU layer's launches counted; then
`warmup_steps`. The window runs steps for `seconds` and ends with a
synchronize. With tracing, a bounded run of `trace_steps` steps follows
under the profiler, taken again until two captures are whole and agree
(`trace.whole`).
"""

from __future__ import annotations

import time
import typing as tp

import numpy as np
import torch

from .. import program, trace as tr, weights as wts, work
from ..check import train_readings
from ..reference import train as ref

__all__ = ["run", "Feed", "normalise", "dataset", "first_batches"]


class Feed:
    """Endless shuffled epochs over host (images, labels) by the program's
    `epoch_batches`; keeps copies of the first `keep` batches and ends when
    `stop` is set."""

    def __init__(self, x, y, batch: int, rng, keep: int):
        self.x, self.y, self.batch, self.rng, self.keep = x, y, batch, rng, keep
        self.kept: tp.List[tuple] = []
        self.stop = False

    def __iter__(self):
        from dau_convnet_tpu_torch.data import epoch_batches
        while not self.stop:
            for xb, yb in epoch_batches(self.x, self.y, self.batch, rng=self.rng):
                if len(self.kept) < self.keep:
                    self.kept.append((xb.copy(), yb.copy()))
                yield xb, yb
                if self.stop:
                    return


def normalise(x_u8: torch.Tensor) -> torch.Tensor:
    """uint8 images -> f32 in [-1, 1], on their device."""
    return x_u8.to(torch.float32).mul_(2.0 / 255.0).sub_(1.0)


def _gaps(ticks):
    """Quantiles (ms) of the host's time between the window's step starts,
    for the log."""
    from ..harness import p_quantile
    d = [b - a for a, b in zip(ticks[:-1], ticks[1:])]
    return {f"p{int(q * 100)}": round(p_quantile(d, q) * 1e3, 3)
            for q in (0.05, 0.5, 0.95, 1.0)} if d else {}


def dataset(cfg: dict, mix: dict, seed: int, dev):
    """The seed's host dataset: (uint8 images (n, 3, H, W), int64 labels),
    drawn on the device and copied to the host."""
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    side, count = cfg["image_size"], mix["dataset_images"]
    x = torch.randint(0, 256, (count, 3, side, side), dtype=torch.uint8, generator=gen, device=dev)
    y = torch.randint(0, cfg["num_classes"], (count,), generator=gen, device=dev)
    return x.cpu().numpy(), y.cpu().numpy()


def first_batches(cfg: dict, mix: dict, seed: int, dev):
    """The first `check_steps` batches the seed's feed yields, on `dev`:
    [(f32 images, labels)]."""
    feed = Feed(*dataset(cfg, mix, seed, dev), mix["batch"], np.random.default_rng(seed),
                keep=mix["check_steps"])
    for i, _ in enumerate(feed):
        if i + 1 == mix["check_steps"]:
            break
    return to_device(feed.kept, dev)


def to_device(kept, dev):
    return [(normalise(torch.from_numpy(x).to(dev)), torch.from_numpy(y).to(dev)) for x, y in kept]


def run(env) -> "tp.Any":
    from dau_convnet_tpu_torch.data import prefetch_to_device
    from dau_convnet_tpu_torch.parallel.train import make_train_step

    cfg, mix, dev = env.config, env.traffic, env.device
    cuda = dev.type == "cuda"
    arch = ref.architecture(cfg)
    n, k = mix["batch"], mix["check_steps"]
    marks = {"imports": time.perf_counter() - env.t_start}
    weights = wts.make_weights(cfg, env.seed, dev)
    marks["weights"] = time.perf_counter() - env.t_start
    model = program.build_model(cfg, mix, weights, dev)
    marks["model"] = time.perf_counter() - env.t_start
    params0 = {name: t.cpu() for name, t in weights.items()}
    del weights
    marks["params_to_host"] = time.perf_counter() - env.t_start
    feed = Feed(*dataset(cfg, mix, env.seed, dev), n, np.random.default_rng(env.seed), keep=k)
    marks["dataset"] = time.perf_counter() - env.t_start
    batches = prefetch_to_device(iter(feed), size=mix["prefetch"], device=dev)
    opt = torch.optim.SGD(model.parameters(), lr=mix["lr"])
    marks["optimizer"] = time.perf_counter() - env.t_start
    step = make_train_step(model, opt)
    if env.fault is not None:
        step = env.fault(step, model)
    trainable = ref.trainable(cfg)
    named = dict(model.named_parameters())
    waits: tp.List[float] = []

    def one():
        t = time.perf_counter()
        x_u8, y = next(batches)
        waits.append(time.perf_counter() - t)
        return step(normalise(x_u8), y)

    losses_p, grads_p, logits_p = [], {}, []
    hook = model.register_forward_hook(lambda m, i, o: logits_p.append(o.detach().float().cpu()))
    for i in range(k):
        losses_p.append(float(one()))
        marks.setdefault("first_step", time.perf_counter() - env.t_start)
        if i == 0:
            hook.remove()
            grads_p = {name: named[name].grad.cpu() for name in trainable
                       if named[name].grad is not None}
    state = {**named, **{name: b for name, b in model.named_buffers()
                         if name.endswith(ref.STATS)}}
    change_norms = {name: float((t.detach().float() - params0[name].to(dev).float()).norm())
                    for name, t in state.items() if name in params0}
    final_p = {name: named[name].detach().cpu() for name in trainable
               if named[name].dtype != torch.float32}
    layers = arch.dau_layers(cfg, n)
    probe = program.LaunchProbe(model, [la["name"] for la in layers])
    one()
    probe.detach()
    for _ in range(mix["warmup_steps"]):
        one()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - env.t_start
    marks["checked_and_warm_steps"] = setup_s

    waits.clear()
    losses, ticks = [], []
    t0 = time.perf_counter()
    while True:
        ticks.append(time.perf_counter())
        losses.append(one())
        if time.perf_counter() - t0 >= env.seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    wait_s = list(waits)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())

    traced, launches = None, {}
    if env.trace:
        def steps():
            for _ in range(mix["trace_steps"]):
                one()
        traced, launches, captures = tr.whole(steps, mix["trace_steps"], program.read_counters)
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    feed.stop = True
    for _ in batches:
        pass
    kept = feed.kept
    del model, opt, step, batches, named, feed
    if cuda:
        torch.cuda.empty_cache()

    losses_r, grads_r, final_r, logits_r = ref.train_steps(
        cfg, {kk: v.to(dev) for kk, v in params0.items()}, to_device(kept, dev), mix["lr"])
    readings, detail = train_readings(losses_p, grads_p, change_norms, losses_r, grads_r,
                                      params0, final_r, mix["lr"], logits_p[0], logits_r,
                                      final_p)
    detail["setup_marks_s"] = {k: round(v, 3) for k, v in marks.items()}
    detail["step_gaps_ms"] = _gaps(ticks)
    if env.trace:
        detail["trace_captures"] = captures
    flops = work.model_flops(layers, [m * n for m in arch.dense_macs(cfg)], train=True)
    return env.make_run(kind="train", setup_s=setup_s, window_s=window_s, units=len(losses),
                        images=len(losses) * n, input_wait_s=wait_s,
                        flops_per_unit=flops, trace=traced,
                        launches=launches, layers=layers, layer_launches=probe.counts,
                        elem_bytes=torch.finfo(getattr(torch, cfg["dtype"])).bits // 8,
                        memory_peak=memory_peak,
                        attempted=len(losses), failed=failed, readings=readings,
                        detail=detail)
