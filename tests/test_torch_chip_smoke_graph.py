"""The helpers by which `chip_smoke.py` holds the replayed train step
(phase 28) and keeps its other phases' steps eager, on the CPU: the
comparison against two eager runs, the hand-kernel classes read from a
trace, and `run_steps`' eager step."""

import pytest
import torch

import chip_smoke as cs


def _three(eager, twin, graphed):
    return {"t": torch.tensor(eager)}, {"t": torch.tensor(twin)}, {"t": torch.tensor(graphed)}


@pytest.mark.parametrize("values, same", [
    (([1.0, 2.0], [1.0, 2.0], [1.0, 2.0]), 1),  # bit for bit, as two eager runs are
    (([1.0, 2.0], [1.0, 2.5], [1.0, 2.25]), 0),  # eager runs differ: within their distance
    (([1.0, 2.0], [1.0, 2.5], [1.0, 1.5]), 0),
])
def test_a_graphed_tensor_held_like_eager_passes(values, same):
    assert cs._held_like_eager("case", *_three(*values)) == same


@pytest.mark.parametrize("values, match", [
    (([1.0, 2.0], [1.0, 2.0], [1.0, 2.0000002]), "two bitwise-equal eager runs"),
    (([1.0, 2.0], [1.0, 2.5], [1.0, 2.75]), "more than eager from eager"),
])
def test_a_graphed_tensor_unlike_eager_fails(values, match):
    with pytest.raises(AssertionError, match=match):
        cs._held_like_eager("case", *_three(*values))


def test_a_graphed_run_missing_a_tensor_fails():
    a, b, c = _three([1.0], [1.0], [1.0])
    with pytest.raises(AssertionError, match="differ"):
        cs._held_like_eager("case", {**a, "u": torch.ones(1)}, {**b, "u": torch.ones(1)}, c)


def test_the_graph_classes_are_the_traces_hand_kernel_classes():
    names = [c for c, _ in cs.CATEGORIES[:6]]
    assert sorted(cs.GRAPH_CLASSES) == sorted(names)
    # each counted kernel of a model step is read in at least one class:
    # K5, K4, K6, K1, K2, K8, K8 dx (K7 and K3 run on no model path)
    read = {i for idx in cs.GRAPH_CLASSES.values() for i in idx}
    assert read == set(range(7))
    assert set(cs.GRAPH_RUNS) <= set(cs.TRAIN_RUNS)


def test_hand_launches_take_the_first_class_a_name_matches():
    events = {"void spectral_grads_kernel<FactoredGather, 2>(Params)": 4,
              "void spectral_grads_kernel<PhiGather, 2>(Params)": 3,
              "void dx::spectral_dx_kernel<64>(DxParams)": 3,
              "dau::fused_forward_kernel<136>": 8, "memcpy128": 7,
              "Memcpy DtoD (Device -> Device)": 3}
    assert cs._hand_launches(events) == {
        "K8 spectral_grads_kernel<FactoredGather>": 4,
        "K1/K2 spectral_grads_kernel<PhiGather>": 3,
        "K2/K8 spectral_dx_kernel": 3, "K5 fused_forward_kernel": 8}


def test_run_steps_builds_an_eager_step(monkeypatch):
    """The steps phases 13 and 18 time again under the plain twins, and
    whose launches reach the kernels line, never replay a graph."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.ReLU(), torch.nn.Flatten(),
                                torch.nn.Linear(4 * 6 * 6, 5))
    data = [(torch.randn(2, 3, 8, 8), torch.tensor([1, 3])) for _ in range(2)]
    step, counts, moved = cs.run_steps("cpu", model, data, (0,) * 9, 1e-2)
    assert dict(step.counts) == {"off": 2}
    assert counts == (0,) * 9
    assert sorted(moved) == sorted(k for k, _ in model.named_parameters())
