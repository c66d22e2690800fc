"""The one-device train step's CUDA graph (`parallel/train.py::GraphedStep`)
on the CPU: when a call may replay and each reason it runs eager, the
signature a graph is keyed by, the kernels' launch counters and their
advance, `tensor_cache` refusing a miss under capture, the recorder's
diverted store and zero-length spans, and the whole call sequence with the
CUDA pieces stood in by fakes (capture runs the step on the CPU, a replay
runs nothing). The CPU step itself is unchanged. The card's checks (eager
against replayed steps, the fallbacks, the launch counts, the bound on
replays in flight) are in `test_torch_cuda.py`."""

import contextlib
import warnings

import pytest
import torch
import torch.optim.optimizer as optim_module
from torch import nn

from dau_convnet_tpu_torch import kernels
from dau_convnet_tpu_torch.kernels import fused_bwd
from dau_convnet_tpu_torch.nn import DAUConv2d
from dau_convnet_tpu_torch.ops import _cache, dau_conv, fourier_engine
from dau_convnet_tpu_torch.parallel import train as ptrain
from dau_convnet_tpu_torch.parallel.train import make_train_step
from dau_convnet_tpu_torch.utils import tracing

H = W = 10


@pytest.fixture(autouse=True)
def _empty_store():
    tracing.clear()
    yield
    tracing.clear()


def _tiny():
    torch.manual_seed(0)
    return nn.Sequential(DAUConv2d(3, 4, (2, 1), 9, engine="fourier", device="cpu"),
                         nn.ReLU(),
                         DAUConv2d(4, 4, (2, 1), 9, engine="fourier", device="cpu"),
                         nn.Flatten(), nn.Linear(4 * H * W, 5))


def _batch(n=2, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, 3, H, W, generator=g), torch.randint(0, 5, (n,), generator=g)


@pytest.fixture
def card(monkeypatch):
    """The step takes CPU tensors for the card's."""
    monkeypatch.setattr(ptrain, "_on_card", lambda x: True)


# --- when a call may replay -------------------------------------------------

def _hook(kind, model, opt):
    """Register one hook of `kind`; returns its handle."""
    sub = model[2]
    noop = lambda *a, **k: None  # noqa: E731
    return {
        "forward": lambda: sub.register_forward_hook(noop),
        "forward_pre": lambda: sub.register_forward_pre_hook(noop),
        "full_backward": lambda: sub.register_full_backward_hook(noop),
        "full_backward_pre": lambda: sub.register_full_backward_pre_hook(noop),
        "root_forward": lambda: model.register_forward_hook(noop),
        "global_forward": lambda: nn.modules.module.register_module_forward_hook(noop),
        "global_forward_pre": lambda: nn.modules.module.register_module_forward_pre_hook(noop),
        "global_full_backward":
            lambda: nn.modules.module.register_module_full_backward_hook(noop),
        "parameter": lambda: model[4].weight.register_hook(lambda g: None),
        "post_accumulate": lambda: model[4].weight.register_post_accumulate_grad_hook(noop),
        "optimizer_pre": lambda: opt.register_step_pre_hook(noop),
        "global_optimizer_post":
            lambda: optim_module.register_optimizer_step_post_hook(noop),
    }[kind]()


@pytest.mark.parametrize("kind", ["forward", "forward_pre", "full_backward",
                                  "full_backward_pre", "root_forward", "global_forward",
                                  "global_forward_pre", "global_full_backward", "parameter",
                                  "post_accumulate", "optimizer_pre", "global_optimizer_post"])
def test_a_hook_keeps_the_call_eager_and_its_removal_lets_it_replay(card, kind):
    model = _tiny()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    step = make_train_step(model, opt)
    x, y = _batch()
    step._warm = step._sign(x, y)  # an eager call of this signature ran
    assert step._route(x, y) == (None, step._warm)
    handle = _hook(kind, model, opt)
    try:
        assert step._route(x, y)[0] == "hooks"
    finally:
        handle.remove()
    assert step._route(x, y)[0] is None


@pytest.mark.parametrize("case,reason", [("cpu", "cpu"), ("off", "off"), ("no_grad", "no_grad"),
                                         ("first", "first_call")])
def test_the_reasons_a_call_runs_eager(monkeypatch, case, reason):
    if case != "cpu":
        monkeypatch.setattr(ptrain, "_on_card", lambda x: True)
    model = _tiny()
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1),
                           cuda_graph=case != "off")
    x, y = _batch()
    with torch.no_grad() if case == "no_grad" else contextlib.nullcontext():
        assert step._route(x, y)[0] == reason


def _change(name, model, opt, x, y):
    """The step's inputs after change `name`: (x, labels)."""
    g = opt.param_groups[0]
    if name == "lr":
        g["lr"] = 0.05
    elif name == "momentum":
        g["momentum"] = 0.9
    elif name == "weight_decay":
        g["weight_decay"] = 1e-4
    elif name == "nesterov":
        g["nesterov"] = True
        g["momentum"] = 0.9
    elif name == "cpu_tensor_lr":
        g["lr"].fill_(0.05)
    elif name == "group":
        opt.add_param_group({"params": [nn.Parameter(torch.zeros(3))], "lr": 0.1})
    elif name == "batch":
        x, y = _batch(n=3)
    elif name == "dtype":
        x = x.double()
    elif name == "labels":
        y = y.int()
    elif name == "eval":
        model.eval()
    elif name == "frozen":
        model[4].bias.requires_grad_(False)
    return x, y


@pytest.mark.parametrize("name", ["lr", "momentum", "weight_decay", "nesterov", "cpu_tensor_lr",
                                  "group", "batch", "dtype", "labels", "eval", "frozen"])
def test_a_changed_signature_runs_eager_then_captures_anew(card, name):
    model = _tiny()
    lr = torch.tensor(0.1) if name == "cpu_tensor_lr" else 0.1
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    step = make_train_step(model, opt)
    x, y = _batch()
    sig = step._sign(x, y)
    step._graph, step._signature = object(), sig  # a graph of this signature
    assert step._route(x, y) == (None, sig)
    x2, y2 = _change(name, model, opt, x, y)
    reason, sig2 = step._route(x2, y2)
    assert reason == "signature" and sig2 != sig
    step._warm = sig2  # after its eager call, the next call captures
    assert step._route(x2, y2) == (None, sig2)


def test_a_hyperparameter_off_the_card_is_keyed_by_value():
    assert ptrain._frozen(torch.tensor(0.1)) == (pytest.approx(0.1),)
    assert ptrain._frozen((0.9, 0.999)) == (0.9, 0.999)
    assert ptrain._frozen([{"a": 1}]) == ("{'a': 1}",)


def test_a_failed_signature_stays_eager(card):
    model = _tiny()
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1))
    x, y = _batch()
    step._warm = sig = step._sign(x, y)
    step.failures[sig] = "RuntimeError: no"
    assert step._route(x, y)[0] == "capture_failed"


# --- the launch counters ------------------------------------------------------

def test_the_launch_counters_are_listed_once_and_advance(monkeypatch):
    for name, (owner, attr) in kernels.LAUNCH_COUNTERS.items():
        monkeypatch.setattr(owner, attr, 10)
    counts = kernels.launch_counts()
    assert set(counts) == set(kernels.LAUNCH_COUNTERS) and set(counts.values()) == {10}
    kernels.advance_launch_counts({"k1": 3, "k5": 1})
    assert fused_bwd.fused_spectral_grads.launches_k1 == 13
    assert kernels.launch_counts(["k1", "k5", "k6"]) == {"k1": 13, "k5": 11, "k6": 10}
    # the unit gradients' spans take theirs from the same list
    assert dau_conv._launch_counts() == {"k1": 13, "k2": 10, "k8": 10, "k8_dx": 10, "k6": 10}


# --- the constant tables under capture ----------------------------------------

def test_tensor_cache_refuses_a_miss_under_capture_and_serves_a_hit(monkeypatch):
    built = []

    @_cache.tensor_cache
    def table(n):
        built.append(n)
        return torch.arange(n)

    assert table(3).tolist() == [0, 1, 2]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert table(3).tolist() == [0, 1, 2]  # a hit: no build
    with pytest.raises(_cache.CaptureCacheMiss, match="table"):
        table(4)
    assert built == [3]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert table(4).tolist() == [0, 1, 2, 3] and built == [3, 4]
    table.cache_clear()
    table(3)
    assert built == [3, 4, 3]


def test_an_engine_table_missed_under_capture_raises(monkeypatch):
    layer = DAUConv2d(1, 2, (2, 1), 9, engine="fourier", device="cpu",
                      generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, 1, 13, 11)
    want = layer(x)
    for fn in _engine_caches():
        fn.cache_clear()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(_cache.CaptureCacheMiss):
        layer(x)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert torch.equal(layer(x), want)


# --- the recorder -------------------------------------------------------------

def test_diverted_spans_stay_out_of_the_store_and_emit_is_zero_length():
    with tracing.diverted() as held:
        with tracing.span("a"):
            with tracing.span("dau.unit_grads") as sp:
                sp.set(route="unfused", bins=496)
    assert [s.name for s in held] == ["dau.unit_grads", "a"] and tracing.spans() == []
    tracing.emit("dau.unit_grads", bins=1)  # not recording: nothing
    assert tracing.spans() == []
    with tracing.record():
        with tracing.span("train.step") as step:
            tracing.emit("dau.unit_grads", replayed=True, **held[0].attrs)
    emitted, closed = tracing.spans()
    assert emitted.parent == step.id and emitted.start_ns == emitted.end_ns
    assert emitted.attrs == {"route": "unfused", "bins": 496, "replayed": True}
    assert tracing.summary()["dau.unit_grads"]["attrs"]["bins"] == 496


# --- the whole sequence, the card's pieces stood in by fakes -------------------

class _Fakes:
    """torch.cuda's graph, stream and event stood in on the CPU: a capture
    runs its block for real, a replay runs nothing; the events count the
    replays in flight."""

    def __init__(self, monkeypatch):
        self.capturing = False
        self.launched = self.done = self.most_in_flight = 0
        fakes = self

        class Graph:
            def capture_begin(self, capture_error_mode="global"):
                assert capture_error_mode == "thread_local"
                fakes.capturing = True

            def capture_end(self):
                fakes.capturing = False

            def replay(self):
                fakes.launched += 1
                fakes.most_in_flight = max(fakes.most_in_flight, fakes.launched - fakes.done)

        class Event:
            upto = 0

            def record(self, stream=None):
                self.upto = fakes.launched

            def synchronize(self):
                fakes.done = max(fakes.done, self.upto)

        class Stream:
            def __init__(self, device=None):
                pass

            def wait_stream(self, other):
                pass

        for name, value in (("CUDAGraph", Graph), ("Event", Event), ("Stream", Stream),
                            ("stream", lambda s: contextlib.nullcontext()),
                            ("synchronize", lambda device=None: None),
                            ("current_stream", lambda device=None: Stream()),
                            ("is_current_stream_capturing", lambda: fakes.capturing)):
            monkeypatch.setattr(torch.cuda, name, value)
        monkeypatch.setattr(ptrain, "_on_card", lambda x: True)


class _Launches(nn.Module):
    """Counts one K1 launch a forward, as a kernel wrapper would."""

    def forward(self, x):
        fused_bwd.fused_spectral_grads.launches_k1 += 1
        return x


def test_the_call_sequence_eager_capture_replay(monkeypatch):
    fakes = _Fakes(monkeypatch)
    model = _tiny()
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1))
    x, y = _batch()
    hook = model.register_forward_hook(lambda *a: None)
    step(x, y)  # eager: the hook
    hook.remove()
    assert dict(step.counts) == {"hooks": 1}
    with tracing.record():
        l1 = step(x, y)  # capture, then its replay
        l2 = step(x, y)
        l3 = step(x, y)
    assert dict(step.counts) == {"hooks": 1, "captures": 1, "replays": 2}
    assert fakes.launched == 3 and fakes.most_in_flight <= 2
    # each call's loss is a tensor of its own
    assert l1 is not l2 and l2.data_ptr() != l3.data_ptr() and torch.equal(l2, l3)
    recs = tracing.spans()
    steps = [s for s in recs if s.name == "train.step"]
    assert [s.attrs["graph"] for s in steps] == ["capture", "replay", "replay"]
    # the capture's own spans are not in the store; each replay emits the
    # captured unit-gradient spans again, under its step, of zero length
    assert not [s for s in recs if s.name in ("dau.forward", "dau.backward", "train.forward")]
    # (the capture's call ends in a replay too)
    grads = [s for s in recs if s.name == "dau.unit_grads"]
    p1, _, rb = fourier_engine.plan_bins(H, W, model[0].cfg.synth_kernel_size)
    assert len(grads) == 6 and all(s.attrs["replayed"] and s.start_ns == s.end_ns
                                   and s.attrs["route"] == "unfused"
                                   and s.attrs["bins"] == p1 * rb for s in grads)
    assert sorted(s.parent for s in grads) == sorted(2 * [s.id for s in steps])
    assert sum(1 for s in recs if s.name == "train.graph_wait") == 3


def test_replays_stay_two_in_flight(monkeypatch):
    fakes = _Fakes(monkeypatch)
    model = _tiny()
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1))
    x, y = _batch()
    for _ in range(8):
        step(x, y)
    assert fakes.launched == 7 and fakes.most_in_flight == 2 and fakes.done == 5


def test_a_replay_advances_the_counters_by_the_captured_launches(monkeypatch):
    _Fakes(monkeypatch)
    model = nn.Sequential(*_tiny(), _Launches())
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1))
    x, y = _batch()
    seen = []
    for _ in range(5):
        before = fused_bwd.fused_spectral_grads.launches_k1
        step(x, y)
        seen.append(fused_bwd.fused_spectral_grads.launches_k1 - before)
    assert dict(step.counts) == {"first_call": 1, "captures": 1, "replays": 3}
    assert seen == [1, 1, 1, 1, 1] and step._delta == {"k1": 1}


def test_the_grads_point_at_the_graphs_again_after_an_eager_call(monkeypatch):
    _Fakes(monkeypatch)
    model = _tiny()
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1))
    x, y = _batch()
    step(x, y)
    step(x, y)  # the capture
    graph_grads = [p.grad for p in model.parameters()]
    assert sum(g is not None for g in graph_grads) == 10
    hook = model.register_forward_hook(lambda *a: None)
    step(x, y)  # eager: new gradient tensors
    hook.remove()
    assert all(p.grad is not g for p, g in zip(model.parameters(), graph_grads)
               if g is not None)
    step(x, y)  # a replay: the graph's gradients again
    assert dict(step.counts) == {"first_call": 1, "captures": 1, "hooks": 1, "replays": 1}
    assert all(p.grad is g for p, g in zip(model.parameters(), graph_grads))


class _Refuses(torch.optim.SGD):
    """An optimizer whose step refuses capture, as a non-capturable Adam's."""

    def step(self, closure=None):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("this optimizer's capturable is False")
        return super().step(closure)


@pytest.mark.parametrize("fault", ["optimizer", "table"])
def test_a_failed_capture_runs_the_call_eager_and_keeps_the_reason(monkeypatch, fault):
    _Fakes(monkeypatch)
    model = _tiny()
    opt = (_Refuses if fault == "optimizer" else torch.optim.SGD)(model.parameters(), lr=0.1)
    step = make_train_step(model, opt)
    ref_model = _tiny()
    ref = make_train_step(ref_model, torch.optim.SGD(ref_model.parameters(), lr=0.1),
                          cuda_graph=False)
    x, y = _batch()
    step(x, y)
    ref(x, y)
    if fault == "table":  # a table first asked for under capture
        for fn in _engine_caches():
            fn.cache_clear()
    before = kernels.launch_counts()
    with pytest.warns(RuntimeWarning, match="capture failed"):
        got = step(x, y)
    want = ref(x, y)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # warned once
        got2, want2 = step(x, y), ref(x, y)
    assert kernels.launch_counts() == before
    assert dict(step.counts) == {"first_call": 1, "capture_failed": 2}
    (reason,) = step.failures.values()
    assert ("capturable" if fault == "optimizer" else "CaptureCacheMiss") in reason
    # the eager calls took the same steps as an eager-only step
    assert torch.equal(got, want) and torch.equal(got2, want2)
    for p, q in zip(model.parameters(), ref_model.parameters()):
        assert torch.equal(p, q)


def _engine_caches():
    from dau_convnet_tpu_torch.ops import gaussian
    return [f for mod in (fourier_engine, gaussian) for f in vars(mod).values()
            if callable(f) and hasattr(f, "cache_clear")]


# --- the CPU step ---------------------------------------------------------------

def test_the_cpu_step_is_the_eager_step():
    model, plain = _tiny(), _tiny()
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9))
    opt = torch.optim.SGD(plain.parameters(), lr=0.1, momentum=0.9)
    for seed in range(3):
        x, y = _batch(seed=seed)
        with tracing.record():
            got = step(x, y)
        opt.zero_grad(set_to_none=True)
        want = nn.functional.cross_entropy(plain(x), y)
        want.backward()
        opt.step()
        assert torch.equal(got, want.detach()) and not got.requires_grad
    for p, q in zip(model.parameters(), plain.parameters()):
        assert torch.equal(p, q)
        assert (p.grad is None) == (q.grad is None) and (p.grad is None or torch.equal(p.grad, q.grad))
    assert dict(step.counts) == {"cpu": 3}
    recs = [s for s in tracing.spans() if s.name == "train.step"]
    assert [s.attrs for s in recs] == 3 * [{"graph": "eager", "graph_reason": "cpu"}]
