"""The port's benchmark: one cell, one run, one result line.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds `BENCHMARK.json`, `portbench/`
and the program (`dau_convnet_tpu_torch/`). It needs a CUDA card (as many as
the cell asks for) and never falls back to the CPU. It prints the numbers it
compared, each beside its limit, as the last lines of standard error, and
one JSON object as the last line of standard output.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['chips']} CUDA card(s) needed, found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    limits = harness.load_limits(cell["name"])
    env = harness.Env(config=harness.load_config(bench, cell["config"]),
                      traffic=harness.load_traffic(cell["traffic"]), seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      device=torch.device("cuda", 0), t_start=T_START,
                      device_kind=torch.cuda.get_device_name(0))
    run = harness.run_cell(env)
    found = harness.banned_modules()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    out, lines = harness.result_line(bench, cell, run, bool(args.trace), limits)
    summary = {k: v for k, v in run.detail.items() if k != "leaves"}
    print(json.dumps({"detail": summary}, default=str), file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
