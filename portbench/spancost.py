"""The program's spans on the card, without the profiler and under it.

    python -m portbench.spancost --workload alexnet-train-b128 --seed 7 --seconds 10 \\
        --windows 3 --out spancost.jsonl

Builds the cell as its generator does (the seed's weights, dataset and
loader, `make_train_step` with SGD), warms it up, then runs `--windows`
rounds of three untraced windows of `--seconds`: the program's recorder
off, on (`spans.record()`), and on with a synchronize after each step, in
an order turned each round. Each window gives its images a second, the
process's CPU ms a step, the garbage collector's runs by generation and
the launch counters' K1 launches a step; each recorded one also the spans
a step (`spans.summary`: host ms and self ms of each span, the attrs
summed, the DAU layers' host ms). Then one run of the mix's `trace_steps`
steps under the program's `utils.profiling.trace`, taken again (up to 4
times) until the trace holds a K1 launch for every one the counters saw;
its Chrome file is read back: device ms a step (the union of the device's
intervals), the longest idle gaps, each with the aten op and the program
span open on the host at its start (the gaps' ms a step summed by span,
and those of the gaps outside any aten op), and whether every aten op that
a DAU layer's backward node ran lies inside that node's `dau.backward`
span. One JSON line a window and one for the capture, on stdout and in
`--out`. It needs a CUDA card, as the benchmark does.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import tempfile
import time
import typing as tp

import numpy as np
import torch

from . import harness, program, spans, trace, weights as wts
from .loads import train

__all__ = ["build", "windows", "capture", "read_chrome", "main"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
DAU_NODE = "_DAUConv2dFunctionBackward"


def build(cfg: dict, mix: dict, seed: int, dev) -> tp.Tuple[tp.Callable, tp.Callable]:
    """(one step through the cell's feed and step, a stop for the feed)."""
    from dau_convnet_tpu_torch.data import prefetch_to_device
    from dau_convnet_tpu_torch.parallel.train import make_train_step

    model = program.build_model(cfg, mix, wts.make_weights(cfg, seed, dev), dev)
    feed = train.Feed(*train.dataset(cfg, mix, seed, dev), mix["batch"],
                      np.random.default_rng(seed), keep=0)
    batches = prefetch_to_device(iter(feed), size=mix["prefetch"], device=dev)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=mix["lr"]))

    def one():
        x_u8, y = next(batches)
        return step(train.normalise(x_u8), y)

    def stop():
        feed.stop = True
        for _ in batches:
            pass

    return one, stop


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _window(one, seconds: float, dev, synced: bool) -> tp.Tuple[int, float]:
    _sync(dev)
    t0, n = time.perf_counter(), 0
    while True:
        one()
        if synced:
            _sync(dev)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(dev)
    return n, time.perf_counter() - t0


MODES = ("off", "on", "synced")


def windows(one, batch: int, seconds: float, rounds: int, dev) -> tp.List[dict]:
    """`rounds` rounds of three windows, the order turned by one each
    round: recorder off; on; on with a synchronize after each step (outside
    its `train.step` span, which then holds the host's own dispatch, with no
    wait for a full launch queue). The readings of each."""
    out = []
    for i in range(rounds):
        for mode in MODES[i % 3:] + MODES[:i % 3]:
            spans.clear()
            before, cpu = program.read_counters(), time.process_time()
            collections = [g["collections"] for g in gc.get_stats()]
            with spans.record() if mode != "off" else contextlib.nullcontext():
                n, s = _window(one, seconds, dev, synced=mode == "synced")
            k1 = (program.read_counters()["K1"] - before["K1"]) / n
            row = {"round": i, "mode": mode, "steps": n, "seconds": s,
                   "images_per_s": n * batch / s, "counter_k1_per_step": k1,
                   "cpu_ms_per_step": (time.process_time() - cpu) * 1e3 / n,
                   "gc_collections": [g["collections"] - c
                                      for g, c in zip(gc.get_stats(), collections)]}
            if mode != "off":
                row.update(_readings(spans.summary()))
            out.append(row)
    spans.clear()
    return out


def _readings(summ: dict) -> dict:
    """The spans a step from a summary: the metrics' readings and each
    span's count, host ms and self ms a step, with the attrs summed."""
    def total(name):
        row = summ.get(name)
        return 0.0 if row is None else row["count"] * row["ms"]

    step = summ.get("train.step", {})
    return {"host_step_ms": step.get("ms"), "step_self_share": (
                step["self_ms"] / step["ms"] if step else None),
            "dau_host_ms": total("dau.forward") + total("dau.backward"),
            "prefetch_wait_ms": total("input.wait"),
            "span_k1_per_step": summ.get("dau.unit_grads", {}).get("attrs", {}).get("k1"),
            "spans": {name: {"count": r["count"], "ms": r["ms"], "self_ms": r["self_ms"],
                             "attrs": r["attrs"]} for name, r in summ.items()}}


def _inside(e: dict, s: dict) -> bool:
    return s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"]


def read_chrome(path: str, span_pid: int, steps: int, top: int = 10) -> dict:
    """Device ms a step, kernels a step, the longest idle gaps labelled by
    the host's aten op and program span, and the DAU backward check, from a
    Chrome trace that holds the program's span track (pid `span_pid`)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    track = [e for e in events if e["pid"] == span_pid]
    dev = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") in DEVICE_CATS]
    ops = sorted((e for e in events if e.get("cat") == "cpu_op" and e["pid"] != span_pid),
                 key=lambda e: e["ts"])
    step_spans = [e for e in track if e["name"] == "train.step"]
    w0 = min(e["ts"] for e in step_spans)
    w1 = max([e["ts"] + e["dur"] for e in step_spans] + [b for _, b in dev])
    busy = trace.union((max(a, w0), min(b, w1)) for a, b in dev if b > w0 and a < w1)
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), key=lambda g: g[0] - g[1])

    def innermost(evs, t):
        inner = [e for e in evs if e["ts"] <= t < e["ts"] + e["dur"]]
        return max(inner, key=lambda e: e["ts"])["name"] if inner else None

    # the step's thread, the producer's, and the others (the autograd
    # engine's device thread): a gap is put down to the innermost span open
    # on another thread, else to the step thread's
    producer = {e["tid"] for e in track if e["name"] == "input.produce"}
    main = [e for e in track if e["tid"] == step_spans[0]["tid"]]
    other = [e for e in track if e["tid"] != step_spans[0]["tid"] and e["tid"] not in producer]
    feeding = [e for e in track if e["tid"] in producer]
    # as the benchmark labels a gap (`trace.reduce_events`): by the aten op
    # open on the host, else "host outside any op"
    aten = [e for e in ops if e["name"].startswith("aten::")]
    labelled, by_span, outside_by_span = [], {}, {}
    for i, (a, b) in enumerate(gaps):
        span = innermost(other, a) or innermost(main, a) or "no span"
        op = innermost(aten, a) or "host outside any op"
        by_span[span] = by_span.get(span, 0.0) + (b - a) / 1e3 / steps
        if op == "host outside any op":
            outside_by_span[span] = outside_by_span.get(span, 0.0) + (b - a) / 1e3 / steps
        if i < top:
            labelled.append({"ms": (b - a) / 1e3, "span": span, "op": op,
                             "producer_busy": innermost(feeding, a) is not None})
    nodes = [e for e in events if e["name"] == DAU_NODE and e["pid"] != span_pid]
    dau_bwd = [e for e in track if e["name"] == "dau.backward"]
    held = outside = 0
    for node in nodes:
        inner = [s for s in dau_bwd if s["tid"] == node["tid"] and _inside(s, node)]
        for e in ops:
            if e["tid"] == node["tid"] and _inside(e, node) and e["name"].startswith("aten::"):
                held += 1
                outside += not any(_inside(e, s) for s in inner)
    return {"steps": steps, "device_ms_per_step": sum(b - a for a, b in busy) / 1e3 / steps,
            "window_ms": (w1 - w0) / 1e3,
            "kernels_per_step": sum(e.get("cat") == "kernel" for e in events) / steps,
            "k1_per_step": sum(e.get("cat") == "kernel" and "spectral_grads_kernel" in e["name"]
                               for e in events) / steps,
            "idle_ms": sum(b - a for a, b in gaps) / 1e3 / steps, "idle_gaps": labelled,
            "idle_ms_by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
            "outside_op_idle_ms_by_span": dict(sorted(outside_by_span.items(),
                                                      key=lambda kv: -kv[1])),
            "dau_backward_nodes": len(nodes), "dau_backward_spans": len(dau_bwd),
            "dau_backward_ops": held, "dau_backward_ops_outside": outside}


def capture(one, steps: int, dev, attempts: int = 4) -> dict:
    """One profiled run of `steps` steps through the program's exporter,
    read back; taken again until it holds the K1 launches counted."""
    from dau_convnet_tpu_torch.utils import profiling

    for taken in range(1, attempts + 1):
        spans.clear()
        before = program.read_counters()["K1"]
        with tempfile.TemporaryDirectory() as logdir:
            with profiling.trace(logdir, device=dev.type):
                for _ in range(steps):
                    one()
            (name,) = os.listdir(logdir)
            out = read_chrome(os.path.join(logdir, name), profiling.SPAN_PID, steps)
        counted = (program.read_counters()["K1"] - before) / steps
        if dev.type != "cuda" or out["k1_per_step"] >= counted:
            break
    out.update(_readings(spans.summary()), counter_k1_per_step=counted, captures=taken)
    spans.clear()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.spancost: needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    cfg, mix = harness.load_config(bench, cell["config"]), harness.load_traffic(cell["traffic"])
    dev = torch.device("cuda", 0)
    one, stop = build(cfg, mix, args.seed, dev)
    for _ in range(mix["check_steps"] + mix["warmup_steps"]):
        one()
    rows = [{"workload": args.workload, "seed": args.seed,
             "device": torch.cuda.get_device_name(0), **r}
            for r in windows(one, mix["batch"], args.seconds, args.windows, dev)]
    rows.append({"workload": args.workload, "seed": args.seed, "capture": True,
                 **capture(one, mix["trace_steps"], dev)})
    stop()
    lines = [json.dumps(r) for r in rows]
    print("\n".join(lines))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
