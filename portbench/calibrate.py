"""Readings that set a cell's limits; the benchmark's own runs never run
this.

    python -m portbench.calibrate --workload <name> --seeds 1,2,3 --control-seeds 4,5,6

For each of `--seeds`, one run of the cell (a short window) gives the
program's readings against the reference. For each of `--control-seeds`,
the reference is put in the program's place, in float8 (the control) and
with half of each batch left out (the mean over the rest, a planted fault),
each held against the float32 reference on the same weights and inputs.
One JSON line per reading goes to standard output.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def train_control(cfg, mix, seed, dev):
    import torch
    from portbench import weights as wts
    from portbench.check import train_readings
    from portbench.loads.train import first_batches
    from portbench.reference import train as ref

    params = wts.make_weights(cfg, seed, dev)
    batches = first_batches(cfg, mix, seed, dev)
    truth = ref.train_steps(cfg, params, batches, mix["lr"])
    out = {}
    for name, run in (("control_fp8", lambda: ref.train_steps(cfg, params, batches, mix["lr"],
                                                              quant=ref.fp8)),
                      ("fault_half_batch", lambda: ref.train_steps(
                          cfg, params, [(x[:len(x) // 2], y[:len(y) // 2]) for x, y in batches],
                          mix["lr"]))):
        losses, grads, final, logits = run()
        cnorm = {k: float((final[k] - params[k].float()).norm()) for k in final
                 if k in grads or k.endswith(ref.STATS)}
        low = {k: final[k].to(params[k].dtype) for k in grads if params[k].dtype != torch.float32}
        readings, detail = train_readings(losses, grads, cnorm, *truth[:2], params, truth[2],
                                          mix["lr"], logits, truth[3], low)
        out[name] = (readings, detail)
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench.calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    cfg = harness.load_config(bench, cell["config"])
    mix = harness.load_traffic(cell["traffic"])
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t = time.perf_counter()
        env = harness.Env(config=cfg, traffic=mix, seed=seed, seconds=args.seconds, trace=False,
                          device=dev, t_start=t, device_kind=kind)
        run = harness.run_cell(env)
        print(json.dumps({"workload": cell["name"], "seed": seed, "side": "program",
                          "readings": run.readings, "setup_s": run.setup_s,
                          "units": run.units, "window_s": run.window_s,
                          "detail": run.detail}), flush=True)
        del run
        torch.cuda.empty_cache()
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        for side, (readings, detail) in train_control(cfg, mix, seed, dev).items():
            print(json.dumps({"workload": cell["name"], "seed": seed, "side": side,
                              "readings": readings, "detail": detail}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
