"""The port's span recorder (`utils/tracing.py`) on the CPU: off by
default at no cost, on under `record()` and under a profiler capture, the
parents across threads, self time, the bounded store, the spans of a
training step of a tiny DAU model (none under `torch.export`), and the
shared clock with the profiler's events and Chrome trace. The card's
check, a fused backward's K1 delta against the launch counter, is in
`test_torch_cuda.py`."""

import collections
import itertools
import json
import threading
import time
import tracemalloc

import pytest
import torch
from torch import nn

from dau_convnet_tpu_torch.nn import DAUConv2d
from dau_convnet_tpu_torch.ops import fourier_engine
from dau_convnet_tpu_torch.parallel.train import make_train_step
from dau_convnet_tpu_torch.utils import profiling, tracing

H = W = 12


@pytest.fixture(autouse=True)
def _empty_store():
    tracing.clear()
    yield
    tracing.clear()


def _names(records):
    return [s.name for s in records]


def test_the_off_path_records_nothing_and_allocates_nothing():
    assert tracing.span("a") is tracing.span("b", adopt=True)  # the shared no-op
    assert not tracing.span("a")
    tracemalloc.start()
    try:
        start = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        for _ in itertools.repeat(None, 10_000):
            with tracing.span("dau.unit_grads") as sp:
                if sp:
                    sp.set(route="unfused", bins=496)
        current, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert current - start <= 0 and peak - start < 512
    assert tracing.spans() == [] and tracing.enclosing("layer") is None


def test_recording_is_on_under_record_and_under_a_profiler_and_off_after():
    from torch.profiler import ProfilerActivity, profile
    with tracing.record():
        with tracing.record():
            with tracing.span("inner"):
                pass
        with tracing.span("nested"):
            pass
    with tracing.span("after_record"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("profiled"):
            torch.ones(4).add_(1)
    with tracing.span("after_profile") as sp:
        assert not sp
    assert _names(tracing.spans()) == ["inner", "nested", "profiled"]


def test_nesting_parents_and_self_time():
    with tracing.record():
        with tracing.span("train.step") as step:
            with tracing.span("train.forward") as fwd:
                fwd.set(n=2)
                with tracing.span("dau.forward") as dau:
                    dau.set(layer="conv2")
                    assert tracing.enclosing("layer") == "conv2"
                assert tracing.enclosing("layer") is None
    by = {s.name: s for s in tracing.spans()}
    assert _names(tracing.spans()) == ["dau.forward", "train.forward", "train.step"]
    assert by["train.step"].parent is None
    assert by["train.forward"].parent == step.id == by["train.step"].id
    assert by["dau.forward"].parent == fwd.id
    for inner, outer in (("dau.forward", "train.forward"), ("train.forward", "train.step")):
        assert by[outer].start_ns <= by[inner].start_ns <= by[inner].end_ns <= by[outer].end_ns

    # self time on exact intervals: a 10 ms step whose children cover 2-5
    # and 4-8 (their union 6 ms) and one root outside it
    s = tracing.Span
    recs = [s("train.step", 1, None, 7, 0, 10_000_000, {}),
            s("train.forward", 2, 1, 7, 2_000_000, 5_000_000, {"n": 2}),
            s("train.backward", 3, 1, 9, 4_000_000, 8_000_000, {}),
            s("train.step", 4, None, 7, 20_000_000, 30_000_000, {}),
            s("input.wait", 5, None, 7, 19_000_000, 19_500_000, {"depth": 1})]
    out = tracing.summary(records=recs)
    assert out["train.step"]["count"] == 1.0
    assert out["train.step"]["ms"] == pytest.approx(10.0)
    assert out["train.step"]["self_ms"] == pytest.approx((4.0 + 10.0) / 2)
    assert out["train.forward"]["count"] == 0.5 and out["train.forward"]["attrs"] == {"n": 1.0}
    assert out["input.wait"]["ms"] == pytest.approx(0.5)
    assert tracing.summary(root="absent", records=recs) == {}


def test_a_span_on_a_second_thread_takes_the_open_step_as_parent():
    seen = {}

    def worker(key, root=False):
        with tracing.span(key, root=root):
            with tracing.span(key + ".inner"):
                pass

    def run(key, root=False):
        th = threading.Thread(target=worker, args=(key, root))
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()

    with tracing.record():
        run("before")  # no step open: a root
        with tracing.span("train.step", adopt=True) as step:
            run("in_step")
            with tracing.span("train.backward", adopt=True) as bwd:
                run("in_backward")
                run("producer", root=True)
            seen["step"], seen["bwd"] = step.id, bwd.id
    by = {s.name: s for s in tracing.spans()}
    assert by["before"].parent is None
    assert by["in_step"].parent == seen["step"]
    assert by["in_backward"].parent == seen["bwd"]
    assert by["producer"].parent is None
    assert by["in_backward.inner"].parent == by["in_backward"].id
    assert by["in_step"].thread != by["train.step"].thread == threading.get_native_id()


def test_the_bounded_store_drops_the_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(tracing, "_store", collections.deque(maxlen=3))
    with tracing.record():
        for i in range(5):
            with tracing.span(f"s{i}"):
                pass
    assert _names(tracing.spans()) == ["s2", "s3", "s4"]
    assert tracing.dropped() == 2
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0


def _tiny(fused_bwd="auto"):
    torch.manual_seed(0)
    return nn.Sequential(
        DAUConv2d(3, 4, (2, 1), 9, engine="fourier", fused_bwd=fused_bwd, device="cpu"),
        nn.ReLU(),
        DAUConv2d(4, 4, (2, 1), 9, engine="fourier", fused_bwd=fused_bwd, device="cpu"),
        nn.Flatten(), nn.Linear(4 * H * W, 5))


def _batch():
    g = torch.Generator().manual_seed(1)
    return torch.randn(2, 3, H, W, generator=g), torch.tensor([1, 3])


@pytest.mark.parametrize("fused_bwd,route", [("auto", "unfused"), ("on", "phi")])
def test_a_train_step_records_its_phases_and_each_dau_layer(fused_bwd, route):
    model = _tiny(fused_bwd)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1))
    x, y = _batch()
    with tracing.record():
        step(x, y)
    recs = tracing.spans()
    names = _names(recs)
    for name in ("train.step", "train.zero_grad", "train.forward", "train.backward",
                 "train.optimizer"):
        assert names.count(name) == 1, name
    for name in ("dau.forward", "dau.phi", "dau.backward", "dau.blur_stack", "dau.unit_grads"):
        assert names.count(name) == 2, name
    assert names.count("dau.input_grad") == 1  # the first layer's x needs no gradient
    by_id = {s.id: s for s in recs}
    fwd = [s for s in recs if s.name == "dau.forward"]
    assert [s.attrs for s in fwd] == [
        {"layer": "0", "N": 2, "S": 3, "H": H, "W": W, "F": 4},
        {"layer": "2", "N": 2, "S": 4, "H": H, "W": W, "F": 4}]
    assert all(by_id[s.parent].name == "train.forward" for s in fwd)
    bwd = [s for s in recs if s.name == "dau.backward"]
    assert sorted(s.attrs["layer"] for s in bwd) == ["0", "2"]
    assert all(by_id[s.parent].name == "train.backward" for s in bwd)
    p1, _, rb = fourier_engine.plan_bins(H, W, model[0].cfg.synth_kernel_size)
    for s in recs:
        if s.name == "dau.unit_grads":
            assert by_id[s.parent].name == "dau.backward"
            # on the CPU a kernel wrapper runs its twin and counts no launch
            s_in = {"0": 3, "2": 4}[by_id[s.parent].attrs["layer"]]
            assert s.attrs == {"route": route, "dx_fused": False, "bins": p1 * rb, "N": 2,
                               "S": s_in, "H": H, "W": W, "F": 4,
                               "k1": 0, "k2": 0, "k8": 0, "k8_dx": 0, "k6": 0}
    out = tracing.summary()
    assert out["train.step"]["count"] == 1.0
    assert out["dau.unit_grads"]["attrs"]["bins"] == 2 * p1 * rb


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_a_table_engines_backward_records_the_tables_route(engine):
    layer = DAUConv2d(3, 4, (2, 1), 9, engine=engine, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, H, W, generator=torch.Generator().manual_seed(1), requires_grad=True)
    with tracing.record():
        layer(x).sum().backward()
    names = _names(tracing.spans())
    assert "dau.phi" not in names and names.count("dau.input_grad") == 1
    (grads,) = [s for s in tracing.spans() if s.name == "dau.unit_grads"]
    assert grads.attrs == {"route": "tables", "dx_fused": False, "bins": 0, "N": 2, "S": 3,
                           "H": H, "W": W, "F": 4, "k1": 0, "k2": 0, "k8": 0, "k8_dx": 0,
                           "k6": 0}


def test_spans_are_absent_under_torch_export():
    model = _tiny().eval()
    x, _ = _batch()
    with tracing.record(), torch.no_grad():
        torch.export.export(model, (x,))
        assert tracing.spans() == []
        model(x)  # eager, the same block: recorded
    assert _names(tracing.spans()).count("dau.forward") == 2


def test_a_span_brackets_the_profilers_event_of_its_op():
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU], acc_events=True) as prof:
        with tracing.span("outer"):
            time.sleep(0.001)
            a @ a
            time.sleep(0.001)
    (outer,) = tracing.spans()
    base = prof.profiler.kineto_results.trace_start_ns()
    (mm,) = [e for e in prof.events() if e.name == "aten::mm"]
    start, end = base + 1e3 * mm.time_range.start, base + 1e3 * mm.time_range.end
    assert outer.start_ns < start <= end < outer.end_ns


def test_the_chrome_trace_holds_the_span_track_around_the_ops(tmp_path):
    model = _tiny()
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1))
    x, y = _batch()
    step(x, y)
    with tracing.span("outside"):  # off: the profiler has not started
        pass
    with profiling.trace(str(tmp_path), device="cpu"):
        step(x, y)
    (path,) = tmp_path.glob("trace_*.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    track = [e for e in events if e["pid"] == profiling.SPAN_PID]
    assert sorted({e["name"] for e in track}) == [
        "dau.backward", "dau.blur_stack", "dau.forward", "dau.input_grad", "dau.phi",
        "dau.unit_grads", "train.backward", "train.forward", "train.optimizer", "train.step",
        "train.zero_grad"]
    ops = [e for e in events if e["pid"] != profiling.SPAN_PID and e.get("cat") == "cpu_op"]

    def inside(e, s):
        return s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"]

    (st,) = [e for e in track if e["name"] == "train.step"]
    (mm,) = [e for e in ops if e["name"] == "aten::addmm"]  # the Linear's forward
    assert inside(mm, st)
    # every op the DAU layers' backward node runs lies inside a dau.backward
    # span on the same thread
    nodes = [e for e in events if e["name"] == "_DAUConv2dFunctionBackward"]
    dau_bwd = [e for e in track if e["name"] == "dau.backward"]
    assert len(nodes) == len(dau_bwd) == 2
    for node in nodes:
        held = [e for e in ops if e["tid"] == node["tid"] and inside(e, node)
                and e["name"].startswith("aten::")]
        assert held
        (span,) = [s for s in dau_bwd if s["tid"] == node["tid"] and inside(s, node)]
        assert all(inside(e, span) for e in held), [e["name"] for e in held
                                                    if not inside(e, span)]
