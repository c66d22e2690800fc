"""Finds every piece of a cell by name and turns a run into the result line.

`BENCHMARK.json` names the cells. A cell's configuration is the JSON file
its entry names; its traffic mix is `traffic/<traffic>.json`, whose `kind`
names the generator `loads/<kind>.py`; its limits are
`limits/<workload>.json`; each metric is read by `metrics/<metric>.py` or,
where there is none, by the reader of its quantity, `metrics/<the name up to
its first dot>.py` (`device_idle_pct.resnet` by `device_idle_pct.py`), whose
`read(run)` returns a number, or None where it finds nothing to read (the
metric is then left out of the line).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import typing as tp
from pathlib import Path

__all__ = ["ROOT", "Env", "Run", "load_benchmark", "find_cell", "load_config", "load_traffic",
           "load_limits", "reader", "read_metric", "metrics_of", "run_cell", "result_line", "banned_modules"]

ROOT = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "dau_convnet_tpu")


def load_benchmark(path: tp.Optional[Path] = None) -> dict:
    return json.loads((path or ROOT.parent / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return json.loads((root.parent / entry["file"]).read_text())


def load_traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((root / "traffic" / f"{name}.json").read_text())


def load_limits(workload: str, root: Path = ROOT) -> dict:
    return json.loads((root / "limits" / f"{workload}.json").read_text())


def _module_from(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = ROOT) -> Path:
    """The file that reads metric `name`: its own, else its quantity's."""
    own = root / "metrics" / f"{name}.py"
    return own if own.exists() else root / "metrics" / f"{name.split('.')[0]}.py"


def read_metric(name: str, run: "Run", root: Path = ROOT) -> tp.Optional[float]:
    """The reading of a run by the metric's reader, or None."""
    value = _module_from(reader(name, root)).read(run)
    return None if value is None else float(value)


def metrics_of(bench: dict, cell: str, traced: bool) -> tp.List[dict]:
    """The cell's end-to-end metrics (untraced) or per-layer metrics
    (traced): every metric whose `workloads` lists the cell, or that has no
    such list."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Run:
    """What a generator measured in one run; the metric readers read it.
    `launches`: each kernel's launches a traced step or request (the
    program's counters); `layers`: the DAU layers' shapes
    (`reference.<architecture>.dau_layers`); `layer_launches`: layer name ->
    {"forward": {kernel: launches}, "backward": {...}} in one step;
    `elem_bytes`: the configuration's activation element size."""

    kind: str
    setup_s: float
    window_s: float
    units: int
    images: int
    input_wait_s: tp.List[float]
    flops_per_unit: int
    trace: tp.Any
    launches: tp.Dict[str, float]
    layers: tp.List[dict]
    layer_launches: tp.Dict[str, dict]
    elem_bytes: int
    memory_peak: int
    attempted: int
    failed: int
    readings: tp.Dict[str, float]
    detail: dict
    device_kind: str = ""

    @property
    def card(self) -> tp.Optional[dict]:
        from .work import peak
        return peak(self.device_kind)


@dataclasses.dataclass
class Env:
    """What a generator is given: the cell's configuration and mix, the seed,
    the window's length, whether to trace, the device, the process's start
    on the host clock and, for the harness's tests, a fault to plant."""

    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: tp.Any
    t_start: float
    device_kind: str
    fault: tp.Optional[tp.Callable] = None

    def make_run(self, **kw) -> Run:
        return Run(device_kind=self.device_kind, **kw)


def run_cell(env: Env) -> Run:
    """Drive the cell's generator (`loads/<kind>.py`)."""
    gen = importlib.import_module(f"{__package__}.loads.{env.traffic['kind']}")
    return gen.run(env)


def p_quantile(values: tp.Sequence[float], q: float) -> float:
    """The q-quantile (0..1) by linear interpolation between order statistics."""
    xs = sorted(values)
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def result_line(bench: dict, cell: dict, run: Run, traced: bool, limits: dict,
                root: Path = ROOT) -> tp.Tuple[dict, tp.List[str]]:
    """(the result object, the stderr lines of the numbers compared)."""
    from .check import judge
    ok, checks = judge(run.readings, limits)
    correct = ok and run.failed == 0
    metrics = {}
    for m in metrics_of(bench, cell["name"], traced):
        value = read_metric(m["name"], run, root)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": run.device_kind, "count": cell["chips"],
              "memory_peak_bytes": run.memory_peak}
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if traced and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = checks
    lines = [f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in checks.items()]
    return out, lines


def banned_modules() -> tp.List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))

