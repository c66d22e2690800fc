"""The reader of `graph_replay_pct` on a synthetic span store, on a program
whose steps carry no `graph` attr, on nothing recorded, and on the spans
of a tiny DAU model's training step recorded on the CPU (eager there)."""

from __future__ import annotations

import types

import pytest
import torch
from torch import nn

from portbench import harness, spans


def _run(kind="train") -> harness.Run:
    return harness.Run(kind=kind, setup_s=12.5, window_s=10.0, units=100, images=12800,
                       input_wait_s=[0.001] * 100, flops_per_unit=1, trace=None, launches={},
                       layers=[], layer_launches={}, elem_bytes=2, memory_peak=123,
                       attempted=100, failed=0, readings={}, detail={})


def _step(**attrs):
    return types.SimpleNamespace(name="train.step", ms=40.0, attrs=attrs)


@pytest.fixture
def store(monkeypatch):
    held = []
    monkeypatch.setattr(spans, "recorded", lambda: held)
    return held


@pytest.mark.parametrize("cell,suffix", [("alexnet-train-b128", "train"),
                                         ("resnet18-train-b128", "resnet")])
@pytest.mark.parametrize("steps,want", [
    ([_step(graph="replay")] * 3, 100.0),
    ([_step(graph="eager", graph_reason="hooks"), _step(graph="capture"),
      _step(graph="replay"), _step(graph="replay")], 50.0),
    ([_step(), _step()], 0.0),  # a program whose steps never replay
])
def test_the_reader_reads_the_share_of_replayed_steps(store, cell, suffix, steps, want):
    store.extend(steps + [types.SimpleNamespace(name="dau.unit_grads", ms=0.0,
                                                attrs={"route": "phi", "replayed": True})])
    assert harness.read_metric(f"graph_replay_pct.{suffix}", _run()) == pytest.approx(want)
    names = {m["name"] for m in harness.metrics_of(harness.load_benchmark(), cell, True)}
    assert f"graph_replay_pct.{suffix}" in names


def test_the_reader_gives_none_without_a_step_or_in_a_serving_run(store):
    assert harness.read_metric("graph_replay_pct.train", _run()) is None
    store.append(_step(graph="replay"))
    assert harness.read_metric("graph_replay_pct.train", _run(kind="serve")) is None


def test_the_cpu_steps_read_no_replay():
    from dau_convnet_tpu_torch.nn import DAUConv2d
    from dau_convnet_tpu_torch.parallel.train import make_train_step
    from dau_convnet_tpu_torch.utils import tracing

    torch.manual_seed(0)
    model = nn.Sequential(DAUConv2d(3, 4, (2, 1), 9, engine="fourier", device="cpu"),
                          nn.Flatten(), nn.Linear(4 * 10 * 10, 3))
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1))
    x, y = torch.randn(2, 3, 10, 10), torch.tensor([0, 2])
    tracing.clear()
    try:
        with spans.record():
            step(x, y)
            step(x, y)
        got = harness.read_metric("graph_replay_pct.train", _run())
    finally:
        tracing.clear()
    assert got == 0.0 and step.counts == {"cpu": 2}
