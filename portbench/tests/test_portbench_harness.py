"""The harness on the CPU: discovery by name, the result line, the rules
BENCHMARK.json keeps, the yardstick's counts, the trace reduction, the
refusal without a card, and planted faults that `correct` catches. Tests
that need the card are marked `cuda` and skip here."""

from __future__ import annotations

import copy
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import check, harness, trace as tr, work
from portbench.reference import alexnet_dau, dau_resnet

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _run(**kw) -> harness.Run:
    base = dict(kind="train", setup_s=12.5, window_s=10.0, units=100, images=12800,
                input_wait_s=[0.001] * 100, flops_per_unit=904862785536,
                trace=None, launches={}, layers=[], layer_launches={}, elem_bytes=2,
                memory_peak=123, attempted=100, failed=0,
                readings={"loss_gap": 0.001}, detail={}, device_kind="NVIDIA H100 80GB HBM3")
    base.update(kw)
    return harness.Run(**base)


# -- BENCHMARK.json's rules --------------------------------------------------

def test_benchmark_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\t" not in w["why"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_piece_of_every_cell_is_a_file():
    for w in BENCH["workloads"]:
        cfg = harness.load_config(BENCH, w["config"])
        entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
        assert cfg["reduced"] == entry["reduced"] == []
        mix = harness.load_traffic(w["traffic"])
        assert (ROOT / "loads" / f"{mix['kind']}.py").exists()
        assert harness.load_limits(w["name"])
        e2e = [m["name"] for m in harness.metrics_of(BENCH, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(BENCH, w["name"], True)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert harness.reader(m["name"]).exists(), m["name"]
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        for cell in m["workloads"]:
            moves = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
            assert cell in moves.get("workloads", [cell])


# -- discovery by name -------------------------------------------------------

def test_a_config_a_mix_and_a_metric_added_as_files_are_found(tmp_path):
    root = tmp_path / "pb"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((ROOT / "configs" / "alexnet-dau-default.json").read_text())
    cfg["name"] = "alexnet-dau-new"
    (root / "configs" / "alexnet-dau-new.json").write_text(json.dumps(cfg))
    (root / "traffic" / "train-b256.json").write_text(json.dumps(
        {**harness.load_traffic("train-b128"), "batch": 256}))
    (root / "metrics" / "steps_seen.py").write_text("def read(run):\n    return run.units\n")
    bench = copy.deepcopy(BENCH)
    bench["configs"].append({"name": "alexnet-dau-new", "source": "x",
                             "file": "pb/configs/alexnet-dau-new.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new-cell", "config": "alexnet-dau-new",
                               "traffic": "train-b256", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "x", "moves": "setup_s"})
    assert harness.load_config(bench, "alexnet-dau-new", root)["name"] == "alexnet-dau-new"
    assert harness.load_traffic("train-b256", root)["batch"] == 256
    assert "steps_seen" in [m["name"] for m in harness.metrics_of(bench, "new-cell", True)]
    assert harness.read_metric("steps_seen", _run(units=7), root) == 7.0
    # a metric with no reader of its own is read by its quantity's
    assert harness.reader("steps_seen.new-cell", root) == root / "metrics" / "steps_seen.py"
    assert harness.read_metric("steps_seen.new-cell", _run(units=7), root) == 7.0


# -- the result line ---------------------------------------------------------

def _trace():
    return tr.reduce_events([("void gemm_kernel", 10.0, 60.0), ("elementwise_kernel", 70.0, 90.0)],
                            [("aten::mm", 0.0, 65.0), ("aten::add", 60.0, 95.0)], (0.0, 100.0), 2)


@pytest.mark.parametrize("traced", [False, True])
def test_the_last_line_has_the_contract_keys(traced):
    cell = harness.find_cell(BENCH, "alexnet-train-b128")
    # traced: 70 us of device time in 2 steps against 50 us a step untraced
    run = _run(trace=_trace(), launches={"K1": 3}, window_s=0.005) if traced else _run()
    limits = {"loss_gap": 0.01}
    out, lines = harness.result_line(BENCH, cell, run, traced, limits)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[:5] == keys and list(out)[-1] == "checks"
    assert ("breakdown" in out) == traced
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert ("busy_s" in out["device"]) == traced
    assert out["correct"] is True and lines == ["check loss_gap 0.001 limit 0.01"]
    want = {m["name"] for m in harness.metrics_of(BENCH, cell["name"], traced)}
    assert set(out["metrics"]) <= want
    if not traced:
        assert out["metrics"]["train_images_per_s"]["value"] == 1280.0
        assert out["metrics"]["setup_s"]["unit"] == "s"
    else:
        assert out["metrics"]["device_idle_pct.train"]["value"] == pytest.approx(30.0)
        assert out["device"]["busy_s"] == pytest.approx(70e-6)
        assert out["metrics"]["launches_per_step.train"]["value"] == 1.0
        assert "k1_roofline_pct" not in out["metrics"]  # no K1 time in the trace
        json.dumps(out)


def test_a_reading_over_its_limit_or_a_failure_is_not_correct():
    cell = harness.find_cell(BENCH, "alexnet-train-b128")
    assert not harness.result_line(BENCH, cell, _run(), False, {"loss_gap": 1e-4})[0]["correct"]
    assert not harness.result_line(BENCH, cell, _run(failed=1), False,
                                   {"loss_gap": 1.0})[0]["correct"]
    nan = _run(readings={"loss_gap": float("nan")})
    assert not harness.result_line(BENCH, cell, nan, False, {"loss_gap": 1.0})[0]["correct"]


# -- the yardstick -----------------------------------------------------------

def _cfg(name):
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


def test_model_flops_against_hand_counts():
    # AlexNet-DAU, N = 128: the DAU layers' sum of S*F*pixels is
    # 96*256*27^2 + 256*384*13^2 + 384*384*13^2 + 384*256*13^2 = 76,062,720,
    # times 2 FLOPs * 4 taps * G = 2 * 5 passes * 128 images; conv1
    # 96*3*121*55^2 and fc 9216*4096 + 4096^2 + 4096*1000 multiply-adds,
    # 2 FLOPs * 3 passes * 128 images.
    cfg = _cfg("alexnet-dau-default")
    dau_px = 96 * 256 * 27 ** 2 + 256 * 384 * 13 ** 2 + 384 * 384 * 13 ** 2 + 384 * 256 * 13 ** 2
    dense = 96 * 3 * 121 * 55 ** 2 + 9216 * 4096 + 4096 * 4096 + 4096 * 1000
    want = dau_px * 2 * 4 * 2 * 5 * 128 + dense * 2 * 3 * 128
    got = work.model_flops(alexnet_dau.dau_layers(cfg, 128),
                           [m * 128 for m in alexnet_dau.dense_macs(cfg)], train=True)
    assert got == want and round(got / 1e9, 1) == 904.9
    forward = work.model_flops(alexnet_dau.dau_layers(cfg, 64),
                               [m * 64 for m in alexnet_dau.dense_macs(cfg)], train=False)
    assert forward == dau_px * 2 * 4 * 2 * 64 + dense * 2 * 64
    # DAU-ResNet-18, N = 128: S*F*output pixels per stage, G = 4, the
    # strided layers at their output; stem 64*3*49*112^2, projections
    # 64*128*28^2 + 128*256*14^2 + 256*512*7^2, head 512*1000.
    cfg = _cfg("dau-resnet18")
    stage = [4 * 64 * 64 * 56 ** 2] + [(s * f + 3 * f * f) * hw ** 2 for s, f, hw in
                                       ((64, 128, 28), (128, 256, 14), (256, 512, 7))]
    dense = 64 * 3 * 49 * 112 ** 2 + 64 * 128 * 28 ** 2 + 128 * 256 * 14 ** 2 + 256 * 512 * 7 ** 2
    want = sum(stage) * 2 * 4 * 4 * 5 * 128 + (dense + 512 * 1000) * 2 * 3 * 128
    got = work.model_flops(dau_resnet.dau_layers(cfg, 128),
                           [m * 128 for m in dau_resnet.dense_macs(cfg)], train=True)
    assert got == want and round(got / 1e9) == 3920


def test_kernel_work_against_hand_counts():
    layer = dict(n=128, s=256, f=384, g=2, h=13, w=13, h_out=13, w_out=13, kb=9)
    px = 13 * 13 * 128
    ops, nbytes = work.table_work(layer)
    assert ops == 3 * 2 * 4 * 2 * 256 * 384 * px
    assert nbytes == (3 * 256 * px + 384 * px + 2 * 256 * 2 * 384) * 2 + 3 * 256 * 2 * 384 * 4
    card = work.peak("NVIDIA H100 80GB HBM3")
    assert work.bound_s(989.4e12, 0, card) == 1.0 and work.bound_s(0, 3.35e12, card) == 1.0
    assert work.peak("some other card") is None


def test_a_kernel_roofline_sums_the_bound_over_the_layers_it_ran_in():
    layer = dict(name="dau_conv3", n=128, s=256, f=384, g=2, h=13, w=13, h_out=13, w_out=13, kb=9)
    card = work.peak("NVIDIA H100 80GB HBM3")
    bound = work.bound_s(*work.table_work(layer), card)
    t = tr.reduce_events([("void spectral_grads_kernel<bf16, PhiGather>", 0.0, 1000.0)], [],
                         (0.0, 2000.0), 1)
    run = _run(trace=t, launches={"K1": 2}, layers=[layer],
               layer_launches={"dau_conv3": {"forward": {}, "backward": {"K1": 2}}})
    assert harness.read_metric("k1_roofline_pct", run) == pytest.approx(100 * 2 * bound / 1e-3)
    assert harness.read_metric("k1_roofline_pct", _run(trace=t, launches={})) is None


# -- the trace reduction -----------------------------------------------------

def test_the_trace_takes_the_union_and_labels_the_gaps():
    t = tr.reduce_events(
        [("void gemm_kernel", 10.0, 60.0), ("Memcpy HtoD (Pinned -> Device)", 40.0, 80.0),
         ("elementwise_kernel", 70.0, 90.0), ("void gemm_kernel", 200.0, 300.0)],
        [("aten::mm", 0.0, 65.0), ("aten::add", 85.0, 120.0), ("portbench.input_wait", 95.0, 99.0)],
        (0.0, 100.0), units=1)
    assert t.busy_s == pytest.approx(80e-6) and t.window_s == pytest.approx(100e-6)
    assert t.launches == 2
    assert t.by_category == {"gemm": pytest.approx(50e-6), "glue": pytest.approx(20e-6)}
    assert [g[0] for g in t.idle_gaps] == ["aten::mm", "aten::add"]
    assert [g[1] for g in t.idle_gaps] == [pytest.approx(10e-6), pytest.approx(10e-6)]
    b = t.breakdown()
    assert set(b) == {"device_ops", "idle_gaps"} and len(b["device_ops"]) <= 10
    assert tr.category("spectral_grads_kernel<PhiGather, 3>") == "K1"
    assert tr.category("spectral_grads_kernel<FactoredGather>") == "K8"


def test_p95_interpolates():
    assert harness.p_quantile(list(range(101)), 0.95) == 95.0
    assert harness.p_quantile([1.0, 2.0], 0.95) == pytest.approx(1.95)


def _traced(launches: dict, other: int) -> tr.Trace:
    """A trace of one step: `launches` kernels of each hand-kernel class and
    `other` GEMMs."""
    names = {"K1": "spectral_grads_kernel<PhiGather>", "K5": "fused_forward_kernel",
             "K6": "grad_tables_kernel"}
    ev = [(names[c], float(i), i + 0.5) for c, n in launches.items() for i in range(n)]
    ev += [("void gemm_kernel", 100.0 + i, 100.5 + i) for i in range(other)]
    return tr.reduce_events(ev, [], (0.0, 1000.0), 1)


def test_a_trace_must_hold_the_counted_launches_and_agree_with_another():
    whole = _traced({"K1": 3}, 100)
    assert tr.covers(whole, {"K1": 2, "K2": 1, "K5": 0})
    assert not tr.covers(_traced({"K1": 2}, 100), {"K1": 3})
    assert tr.agree(whole, _traced({"K1": 3}, 100))
    assert not tr.agree(whole, _traced({"K1": 3}, 80))  # lost a fifth of the GEMMs
    assert not tr.agree(whole, _traced({"K1": 2}, 101))


def test_whole_retakes_a_partial_trace(monkeypatch):
    import contextlib
    takes = iter([_traced({"K1": 1}, 100), _traced({"K1": 3}, 60), _traced({"K1": 3}, 100),
                  _traced({"K1": 3}, 100)])

    @contextlib.contextmanager
    def fake(out, units):
        yield
        out.append(next(takes))

    monkeypatch.setattr(tr, "capture", fake)
    count = {"K1": 0, "K5": 0}

    def step():
        count["K1"] += 3

    t, per_unit, taken = tr.whole(step, 1, lambda: dict(count))
    assert t.launches == 103 and per_unit == {"K1": 3.0, "K5": 0.0} and taken == 4
    takes = iter([_traced({"K1": 1}, 100)] * 4)
    with pytest.raises(RuntimeError):
        tr.whole(step, 1, lambda: dict(count))


# -- the comparison ----------------------------------------------------------

def test_a_move_under_half_an_ulp_is_hidden():
    one = torch.ones(4, dtype=torch.bfloat16)  # ulp 2^-7
    g = torch.tensor([0.0, 1e-3, 1e-2, 1.0])
    assert check.hidden_share(one, g, 1.0) == pytest.approx(1 / 3)
    assert check.hidden_share(one.float(), g, 1.0) == 0.0


def _readings(hide: float, stat: float):
    """Readings of a program that matches the reference but for a bf16 leaf
    whose moves round to nothing (its change read `hide` times the
    reference's) and a running mean whose change reads `stat` times it."""
    lr = 1e-2
    params0 = {"w": torch.ones(8), "b": torch.ones(8), "u": torch.ones(8, dtype=torch.bfloat16),
               "bn.running_mean": torch.zeros(4)}
    grads = {"w": torch.ones(8), "b": torch.ones(8) * 2, "u": torch.ones(8) * 0.1}
    final = {k: params0[k].float() - lr * grads[k] for k in grads}
    final["u"] = params0["u"].float()
    final["u"][0] -= 2 ** -7
    final["bn.running_mean"] = torch.ones(4)
    changes = {k: float((final[k] - params0[k].float()).norm()) for k in final}
    changes["u"] *= hide
    changes["bn.running_mean"] *= stat
    return check.train_readings([1.0], grads, changes, [1.0], grads, params0, final, lr)


def test_the_worst_change_skips_hidden_leaves_and_the_median_keeps_them():
    sound, detail = _readings(hide=3.0, stat=1.0)
    assert sound["change_gap"] == 0.0 and sound["stats_gap"] == 0.0
    assert detail["leaves"]["u"]["hidden_share"] == 1.0 and detail["resolved"] == 2
    assert detail["leaves"]["u"]["change_gap"] > 0.5  # over the median leaf's change
    assert _readings(hide=3.0, stat=0.0)[0]["stats_gap"] == 1.0
    assert _readings(hide=1.0, stat=1.0)[0]["change_median"] == 0.0


# -- no card -----------------------------------------------------------------

def test_without_a_card_the_run_fails_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "alexnet-train-b128", "--seed", str(2**33 + 1), "--seconds", "1",
                           "--trace", "0"], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


# -- planted faults: `correct` comes out false --------------------------------

def _tiny(config: str, traffic: str, limits: str, fault, seed: int = 2**33 + 3):
    """A run of a configuration and a mix at a tiny size on the CPU, judged
    by a cell's limits."""
    cfg = copy.deepcopy(harness.load_config(BENCH, config))
    image = 67 if cfg["architecture"] == "alexnet_dau" else 64
    cfg["image_size"] = image
    if "image_size" in cfg["program"]["kwargs"]:
        cfg["program"]["kwargs"]["image_size"] = image
    mix = {**harness.load_traffic(traffic), "batch": 4, "dataset_images": 16, "warmup_steps": 0}
    env = harness.Env(config=cfg, traffic=mix, seed=seed, seconds=0.01, trace=False,
                      device=torch.device("cpu"), t_start=time.perf_counter(), device_kind="cpu",
                      fault=fault)
    run = harness.run_cell(env)
    cell = {"name": limits, "chips": 1}
    return harness.result_line(BENCH, cell, run, False, harness.load_limits(limits))[0]


def _unchanged(step, model):
    """A step that computes the loss and gradients and leaves the state as
    it was."""
    def broken(x, labels):
        loss = torch.nn.functional.cross_entropy(model(x), labels)
        loss.backward()
        return loss.detach()
    return broken


def _half_batch(step, model):
    """A step that leaves out half of the batch and takes the mean over the
    rest."""
    return lambda x, labels: step(x[:len(x) // 2], labels[:len(labels) // 2])


def _stats_kept(step, model):
    """A step whose BatchNorm running statistics do not move."""
    def broken(x, labels):
        kept = {k: b.clone() for k, b in model.named_buffers() if k.endswith("running_mean")}
        loss = step(x, labels)
        with torch.no_grad():
            for k, b in model.named_buffers():
                if k in kept:
                    b.copy_(kept[k])
        return loss
    return broken


FAULTS = [("alexnet-dau-default", "alexnet-train-b128", _unchanged),
          ("alexnet-dau-default", "alexnet-train-b128", _half_batch),
          ("dau-resnet18", "resnet18-train-b128", _stats_kept)]


@pytest.mark.parametrize("config,limits,fault", FAULTS,
                         ids=["unchanged", "half_batch", "resnet_stats_kept"])
def test_a_broken_training_step_is_not_correct(config, limits, fault):
    out = _tiny(config, "train-b128", limits, fault)
    assert out["correct"] is False, out["checks"]
    if fault is _stats_kept:
        assert out["checks"]["stats_gap"]["value"] > out["checks"]["stats_gap"]["limit"]


# -- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_on_the_card_is_correct(card, workload):
    del card
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", workload,
                           "--seed", str(2**33 + 17), "--seconds", "2", "--trace", "1"],
                          cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["busy_s"] > 0
