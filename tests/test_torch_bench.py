"""The port's bench (`python -m dau_convnet_tpu_torch.bench`) on the CPU.

- The variant-subprocess capture: the five cases of
  `tests/test_bench_variants.py` (success, own baseline, raw inference
  schema, failure and timeout as error entries) with an injected
  subprocess.run.
- The guard: the null-valued line when the child prints no JSON.
- `--model layer --device cpu` at a tiny size prints one JSON line whose
  metric is the string JAX's `bench.py` builds for the same arguments.
- Without CUDA and without `--device cpu` the bench exits non-zero.
- `gather_flops` against `bench.py`'s formula (:323-328).
- One memtest step and one layer-cell step in f32: the port's gradients of
  (x, w, mu1, mu2) against `jax.grad` of the same clip and vdot through
  `dau_convnet_tpu.ops.dau_conv2d_op` (rtol 1e-4, atol 1e-4 of each
  gradient's max), and the update against lr times them; the inputs are
  drawn as `bench.py` draws them.
"""

import json
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from dau_convnet_tpu.models.alexnet import ALEXNET_DAU_VARIANTS as JAX_VARIANTS
from dau_convnet_tpu.ops import DAUConvSettings as JaxSettings
from dau_convnet_tpu.ops import dau_conv2d_op as jax_op
from dau_convnet_tpu_torch import bench

ROOT = Path(__file__).resolve().parents[1]
MODULE = [sys.executable, "-m", "dau_convnet_tpu_torch.bench"]


class _Args:
    engine = "fourier"
    fused_bwd = "auto"
    fused_dx = "auto"
    fused_gather = "phi"
    iters = 20


def _result(stdout="", stderr="", rc=0):
    return types.SimpleNamespace(stdout=stdout, stderr=stderr, returncode=rc)


SUB_LINE = json.dumps({
    "metric": "alexnet_dau_small_trainstep_images_per_sec(N32,227x227,bf16)",
    "value": 4055.0, "unit": "images/sec", "vs_baseline": 0.302,
    "detail": {"dau_step_ms": 7.89, "conv3x3_step_ms": 2.38,
               "dau_step_pairs_ms": [7.8, 7.89, 7.95],
               "dau_units": 371200},
})


def test_variant_subprocess_success_parses_last_json_line():
    seen = {}

    def fake_run(cmd, **kw):
        seen.update(cmd=cmd, **kw)
        return _result(stdout="a log line\n" + SUB_LINE + "\n")

    out = bench._measure_variant_subprocess("small", _Args(), t_conv=2.4e-3, _run=fake_run)
    assert out["images_per_sec"] == 4055.0
    assert out["dau_step_ms"] == 7.89
    assert out["dau_units"] == 371200
    assert "device_busy_ms" not in out
    # ratio against the HEADLINE run's conv median, not the subprocess's
    assert out["vs_baseline"] == round(2.4 / 7.89, 4)
    # the child runs this module of this tree, with the same config class
    assert seen["cmd"][:3] == MODULE
    assert seen["cwd"] == ROOT
    assert seen["cmd"][3:] == ["--variant", "small", "--engine", "fourier",
                               "--fused-bwd", "auto", "--fused-dx", "auto",
                               "--fused-gather", "phi", "--iters", "20"]
    # recursion guard: the child must not measure variants of its own
    assert seen["env"]["DAU_BENCH_ALL_VARIANTS"] == "0"
    assert seen["timeout"] > 0


SUB_LINE_N128 = json.dumps({
    "metric": "alexnet_dau_default_trainstep_images_per_sec(N128,227x227,bf16)",
    "value": 5581.0, "unit": "images/sec", "vs_baseline": 0.270,
    "detail": {"dau_step_ms": 22.93, "conv3x3_step_ms": 6.19,
               "dau_step_pairs_ms": [22.9, 22.93, 23.0],
               "dau_units": 693248, "device_busy_ms": 12.5, "dau_peak_memory_gib": 9.1},
})


def test_variant_subprocess_own_baseline_for_different_batch():
    seen = {}

    def fake_run(cmd, **kw):
        seen["cmd"] = cmd
        return _result(stdout=SUB_LINE_N128 + "\n")

    out = bench._measure_variant_subprocess(
        "default", _Args(), t_conv=2.4e-3, _run=fake_run,
        extra=("--N", "128"), own_baseline=True)
    # N=128's conv ran at N=128 inside the child; the headline's N=32 conv
    # median must NOT be its denominator
    assert out["vs_baseline"] == 0.270
    assert out["conv3x3_step_ms"] == 6.19
    assert out["device_busy_ms"] == 12.5 and out["dau_peak_memory_gib"] == 9.1
    assert seen["cmd"][-2:] == ["--N", "128"]


SUB_LINE_INFER = json.dumps({
    "metric": ("alexnet_dau_default_inference_images_per_sec"
               "(N32,227x227,bf16,phi_cached)"),
    "value": 21000.0, "unit": "images/sec", "vs_baseline": 0.61,
    "detail": {"dau_serving_ms": 1.5, "dau_plain_fwd_ms": 2.1,
               "conv3x3_fwd_ms": 0.92, "phi_cache_speedup": 1.4,
               "engine": "fourier", "device": "NVIDIA H100 80GB HBM3, 700.00 W"},
})


def test_variant_subprocess_raw_forwards_inference_schema():
    seen = {}

    def fake_run(cmd, **kw):
        seen["cmd"] = cmd
        return _result(stdout=SUB_LINE_INFER + "\n")

    out = bench._measure_variant_subprocess(
        "default", _Args(), t_conv=2.4e-3, _run=fake_run,
        extra=("--model", "inference"), own_baseline=True, raw=True)
    # the serving cell's own ratio and detail come through as they are
    # (its detail has no dau_step_ms; raw mode must not KeyError on it)
    assert out["images_per_sec"] == 21000.0
    assert out["vs_baseline"] == 0.61
    assert out["dau_serving_ms"] == 1.5
    assert out["phi_cache_speedup"] == 1.4
    assert "device" not in out
    assert seen["cmd"][-2:] == ["--model", "inference"]


def test_variant_subprocess_failure_is_error_entry_not_raise():
    def fake_run(cmd, **kw):
        return _result(stdout="", stderr="Traceback...\nRuntimeError: boom", rc=1)

    out = bench._measure_variant_subprocess("large", _Args(), t_conv=2.4e-3, _run=fake_run)
    assert set(out) == {"error"}
    assert "rc=1" in out["error"] and "boom" in out["error"]


def test_variant_subprocess_timeout_is_error_entry():
    def fake_run(cmd, **kw):
        raise subprocess.TimeoutExpired(cmd, kw["timeout"])

    out = bench._measure_variant_subprocess("small", _Args(), t_conv=2.4e-3, _run=fake_run)
    assert set(out) == {"error"}
    assert "TimeoutExpired" in out["error"]


@pytest.mark.parametrize("child, rc, value", [
    ("print('a log line, no JSON')", 1, None),
    ("import sys; sys.exit(3)", 1, None),
    ("print('{\"metric\": \"m\", \"value\": 2.5}')", 0, 2.5),
])
def test_guard_prints_the_null_line_when_the_child_prints_no_json(capsys, child, rc, value):
    assert bench._run_guarded([], _cmd=[sys.executable, "-c", child]) == rc
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["value"] == value
    if value is None:
        assert last["metric"] == "alexnet_dau_default_trainstep_images_per_sec"
        assert "produced no JSON line" in last["error"]


LAYER_ARGS = ["--model", "layer", "--N", "2", "--S", "8", "--F", "8", "--HW", "8",
              "--iters", "2"]


def _jax_metric(monkeypatch, capsys, argv):
    """The metric JAX's bench.py prints for `argv`, its timer stubbed out
    (the name is built from the arguments alone)."""

    def fake_time_chained(step, carry, iters=100, pairs=3):
        fake_time_chained.last_pairs_ms = [1.0]
        return 1e-3

    monkeypatch.setattr(jbench, "time_chained", fake_time_chained)
    monkeypatch.setattr(jbench, "wait_for_backend", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    jbench.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])["metric"]


@pytest.mark.parametrize("extra", [[], ["--static-max-offset", "1"],
                                   ["--engine", "fourier", "--dtype", "bf16"]])
def test_layer_cell_on_the_cpu_prints_one_line_named_as_jax(monkeypatch, capsys, extra):
    proc = subprocess.run(MODULE + LAYER_ARGS + extra + ["--device", "cpu"],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got["value"] > 0 and got["vs_baseline"] > 0
    assert got["detail"]["device"] == "cpu" and got["detail"]["device_busy_ms"] is None
    assert len(got["detail"]["dau_pairs_ms"]) == 5
    assert got["metric"] == _jax_metric(monkeypatch, capsys, LAYER_ARGS + extra)


@pytest.mark.parametrize("model", ["layer", "memtest", "alexnet"])
def test_without_cuda_the_bench_exits_nonzero(monkeypatch, model):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench.main(["--model", model])
    assert exc.value.code not in (0, None)
    assert "no CUDA device" in str(exc.value.code)


def test_without_cuda_the_guarded_bench_exits_nonzero_with_the_null_line():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = subprocess.run(MODULE + LAYER_ARGS, capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert proc.returncode != 0
    assert json.loads(proc.stdout.strip().splitlines()[-1])["value"] is None
    assert "no CUDA device" in proc.stderr


@pytest.mark.parametrize("variant", ["small", "default", "large"])
@pytest.mark.parametrize("n", [32, 128])
def test_gather_flops_is_the_jax_formula(variant, n):
    units = JAX_VARIANTS[variant]
    g_units = units[0] * units[1]
    layer_px = ((96, 256, 27), (256, 384, 13), (384, 384, 13), (384, 256, 13))
    want = sum(2 * n * s * g_units * f * hw * hw * 4 * 5 for s, f, hw in layer_px)
    assert bench.gather_flops(variant, n) == want


def _jax_grads(cfg, x, w, mu1, mu2, sigma, err, bound):
    """bench.py's gradients: those of vdot(dau_conv2d_op(x, w, clip(mu1),
    clip(mu2), sigma), err) with respect to (x, w, mu1, mu2)."""

    def f(x, w, mu1, mu2):
        y = jax_op(cfg, x, w, jnp.clip(mu1, -bound, bound), jnp.clip(mu2, -bound, bound),
                   sigma)
        return jnp.vdot(y, err)

    carry = tuple(jnp.asarray(a) for a in (x, w, mu1, mu2))
    return [np.asarray(g) for g in jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(*carry)]


NAMES = ("x", "w", "mu1", "mu2")


def _check_step(step, carry, draws, jax_grads):
    """The port's draws equal bench.py's; each of its gradients matches
    JAX's (rtol 1e-4, atol 1e-4 of the tensor's max); and the step moves
    each tensor by lr times that gradient. Returns the port's gradients."""
    for name, got, want in zip(NAMES, carry, draws):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"draw of {name}")
    grads = step.grads(carry)
    for name, got, want in zip(NAMES, grads, jax_grads):
        got = got.numpy()
        assert got.dtype == np.float32, name
        scale = float(np.abs(want).max())
        assert scale > 0, f"JAX's gradient of {name} is zero"
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale, err_msg=name)
    new = step(carry)
    for name, old, g, got in zip(NAMES, carry, grads, new):
        assert torch.equal(got, old - step.lr * g), f"{name}: not old - lr * grad"
        assert not torch.equal(got, old), f"{name} did not move"
    return [g.numpy() for g in grads]


def test_memtest_step_matches_a_jax_step():
    n, s, f, g, hw = 2, 4, 6, 2, 6
    step, carry = bench.memtest_setup(torch.float32, torch.device("cpu"), n=n, s=s, f=f)
    rng = np.random.default_rng(0)  # bench.py:500-506
    x = rng.random((n, s, hw, hw)).astype(np.float32)
    err = rng.standard_normal((n, f, hw, hw)).astype(np.float32)
    w = (rng.standard_normal((1, s, g, f)) * 0.1).astype(np.float32)
    mu1 = rng.uniform(-10, 10, (1, s, g, f)).astype(np.float32)
    mu2 = rng.uniform(-10, 10, (1, s, g, f)).astype(np.float32)
    bound = 4 - 0.1
    cfg = JaxSettings(kernel_size=9, compute_sigma_grad=False, precision="highest")
    want = _jax_grads(cfg, x, w, mu1, mu2, jnp.full((1,), 0.5), jnp.asarray(err), bound)
    grads = _check_step(step, carry, (x, w, mu1, mu2), want)
    # the clip runs: no gradient reaches an offset past the bound, and some
    # reaches one within it
    for name, mu, grad in zip(NAMES[2:], (mu1, mu2), grads[2:]):
        clipped = np.abs(mu) > bound
        assert clipped.any() and (~clipped).any(), name
        np.testing.assert_array_equal(grad[clipped], 0, err_msg=name)
        assert np.abs(grad[~clipped]).max() > 0, name


@pytest.mark.parametrize("engine, offset", [("xla", 3.0), ("xla", 1.0), ("fourier", 3.0),
                                            ("pallas_fused", 2.0)])
def test_layer_step_matches_a_jax_step(engine, offset):
    n, s, f, hw, g = 2, 4, 6, 8, 2
    step, carry, conv_step, conv_carry = bench.layer_setup(
        n, s, f, hw, torch.float32, engine, offset, torch.device("cpu"))
    rng = np.random.default_rng(0)  # bench.py:668-678
    x = rng.random((n, s, hw, hw)).astype(np.float32)
    err = rng.standard_normal((n, f, hw, hw)).astype(np.float32)
    w = (rng.standard_normal((1, s, g, f)) * 0.1).astype(np.float32)
    mu_init = min(3.0, offset)
    mu1 = rng.uniform(-mu_init, mu_init, (1, s, g, f)).astype(np.float32)
    mu2 = rng.uniform(-mu_init, mu_init, (1, s, g, f)).astype(np.float32)
    cfg = JaxSettings(kernel_size=9, mu_learning_rate_factor=1.0, static_max_offset=offset,
                      compute_sigma_grad=False, precision="highest", engine=engine)
    want = _jax_grads(cfg, x, w, mu1, mu2, jnp.full((1, s, g, f), 0.5), jnp.asarray(err),
                      4 - 0.01)
    _check_step(step, carry, (x, w, mu1, mu2), want)
    # the baseline's step: a 3x3 conv's, moving x and the kernel
    k3 = (rng.standard_normal((f, s, 3, 3)) * 0.1).astype(np.float32)
    np.testing.assert_array_equal(conv_carry[1].numpy(), k3)
    new = conv_step(conv_carry)
    assert [tuple(a.shape) for a in new] == [(n, s, hw, hw), (f, s, 3, 3)]
    assert not torch.equal(new[1], conv_carry[1])
