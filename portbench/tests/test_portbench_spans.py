"""The span readers (`host_step_ms`, `dau_host_ms`, `unfused_bins`,
`prefetch_wait_ms`) on a synthetic span store, on nothing recorded, on a
program without the recorder, and on the spans of a tiny DAU model's
training step recorded on the CPU."""

from __future__ import annotations

import sys
import types

import pytest
import torch
from torch import nn

from portbench import harness, spans

READERS = ("host_step_ms", "dau_host_ms", "unfused_bins", "prefetch_wait_ms")


def _run(kind="train") -> harness.Run:
    return harness.Run(kind=kind, setup_s=12.5, window_s=10.0, units=100, images=12800,
                       input_wait_s=[0.001] * 100, flops_per_unit=1, trace=None, launches={},
                       layers=[], layer_launches={}, elem_bytes=2, memory_peak=123,
                       attempted=100, failed=0, readings={}, detail={})


def _span(name, ms, **attrs):
    return types.SimpleNamespace(name=name, ms=ms, attrs=attrs)


# two steps: conv2 unfused at 496 bins and conv3 on K1 in each
STORE = [
    _span("input.wait", 0.5, depth=2), _span("train.step", 40.0),
    _span("dau.forward", 3.0, layer="conv2"), _span("dau.forward", 2.0, layer="conv3"),
    _span("dau.unit_grads", 4.0, route="unfused", bins=496),
    _span("dau.unit_grads", 1.0, route="phi", bins=120),
    _span("dau.backward", 6.0, layer="conv2"), _span("dau.backward", 2.0, layer="conv3"),
    _span("input.wait", 1.5, depth=1), _span("train.step", 50.0),
    _span("dau.forward", 3.0, layer="conv2"), _span("dau.forward", 2.0, layer="conv3"),
    _span("dau.unit_grads", 4.0, route="unfused", bins=496),
    _span("dau.unit_grads", 1.0, route="phi", bins=120),
    _span("dau.backward", 6.0, layer="conv2"), _span("dau.backward", 2.0, layer="conv3"),
    _span("input.produce", 9.0, bytes=19787136),
]


@pytest.fixture
def store(monkeypatch):
    held = []
    monkeypatch.setattr(spans, "recorded", lambda: held)
    return held


@pytest.mark.parametrize("cell,suffix", [("alexnet-train-b128", "train"),
                                         ("resnet18-train-b128", "resnet")])
def test_each_reader_reads_a_step_of_the_synthetic_store(store, cell, suffix):
    store.extend(STORE)
    want = {"host_step_ms": 45.0, "dau_host_ms": 13.0, "unfused_bins": 496.0,
            "prefetch_wait_ms": 1.0}
    for name in READERS:
        assert harness.read_metric(f"{name}.{suffix}", _run()) == pytest.approx(want[name]), name
    assert harness.read_metric(f"unfused_bins.{suffix}", _run()) == 496.0
    # every DAU layer on a fused kernel: no unfused bins, which reads 0
    store[:] = [s for s in STORE if s.attrs.get("route") != "unfused"]
    assert harness.read_metric(f"unfused_bins.{suffix}", _run()) == 0.0
    names = {m["name"] for m in harness.metrics_of(harness.load_benchmark(), cell, True)}
    assert {f"{name}.{suffix}" for name in READERS} <= names


@pytest.mark.parametrize("name", READERS)
def test_each_reader_gives_none_without_a_step(store, name):
    assert harness.read_metric(f"{name}.train", _run()) is None
    store.extend(s for s in STORE if s.name != "train.step")  # spans, but no step
    assert harness.read_metric(f"{name}.train", _run()) is None
    store[:] = STORE
    assert harness.read_metric(f"{name}.train", _run(kind="serve")) is None


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    import dau_convnet_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "dau_convnet_tpu_torch.utils.tracing", None)
    assert spans.recorded() == []
    with spans.record():
        pass
    for name in READERS:
        assert harness.read_metric(f"{name}.train", _run()) is None


def test_the_readers_read_the_programs_spans_of_a_step():
    from dau_convnet_tpu_torch.data import prefetch_to_device
    from dau_convnet_tpu_torch.nn import DAUConv2d
    from dau_convnet_tpu_torch.ops import fourier_engine
    from dau_convnet_tpu_torch.parallel.train import make_train_step
    from dau_convnet_tpu_torch.utils import tracing

    torch.manual_seed(0)
    model = nn.Sequential(DAUConv2d(3, 4, (2, 1), 9, engine="fourier", device="cpu"),
                          nn.Flatten(), nn.Linear(4 * 10 * 10, 3))
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1))
    batches = prefetch_to_device(iter([(torch.randn(2, 3, 10, 10).numpy(),
                                        torch.tensor([0, 2]).numpy())] * 2), device="cpu")
    tracing.clear()
    try:
        with spans.record():
            for x, y in batches:
                step(x, y)
        got = {name: harness.read_metric(f"{name}.train", _run()) for name in READERS}
    finally:
        tracing.clear()
    p1, _, rb = fourier_engine.plan_bins(10, 10, model[0].cfg.synth_kernel_size)
    assert got["unfused_bins"] == p1 * rb  # on the CPU the gate sends it unfused
    assert got["host_step_ms"] > got["dau_host_ms"] > 0.0
    assert got["prefetch_wait_ms"] >= 0.0
