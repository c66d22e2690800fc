"""The port's `utils/profiling.py` on the CPU: `device_time` with the host
clock, `trace` writing a Chrome trace, and `device_busy_ms` finding no
device time in a CPU trace; `kernel_ms` and `device_busy_ms` summing the
device rows of a profile by name, all or those whose name holds a fragment. The card's paths (CUDA events, kernel
rows) run in `dau_convnet_tpu_torch.bench` and `chip_smoke.py` on the card."""

import json
import types

import torch

from dau_convnet_tpu_torch.utils import device_busy_ms, device_time, kernel_ms, trace


def test_device_time_on_the_cpu_is_positive_and_counts_every_call():
    calls = []

    def fn(a, b):
        calls.append(1)
        return a @ b

    a = torch.randn(64, 64)
    t = device_time(fn, a, a, iters=4, device="cpu")
    assert t > 0.0
    assert len(calls) == 5  # one warm-up, then the timed calls


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(32, 32)
    with trace(str(tmp_path), device="cpu") as prof:
        (a @ a).sum()
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert device_busy_ms(prof) is None


def test_trace_without_a_logdir_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with trace(device="cpu") as prof:
        torch.ones(4).add_(1)
    assert list(tmp_path.iterdir()) == []
    assert any("add" in e.key for e in prof.key_averages())


def test_device_busy_ms_sums_the_device_rows_whose_name_holds_the_fragment():
    def row(key, kind, us):
        return types.SimpleNamespace(key=key, device_type=kind, self_device_time_total=us)

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    rows = [row("spectral_grads_kernel<2>", cuda, 1500.0), row("Memcpy DtoD", cuda, 250.0),
            row("aten::mm", cpu, 9000.0), row("spectral_grads_kernel<4>", cuda, 500.0)]
    prof = types.SimpleNamespace(key_averages=lambda: rows)
    assert kernel_ms(prof) == {"spectral_grads_kernel<2>": 1.5, "Memcpy DtoD": 0.25,
                               "spectral_grads_kernel<4>": 0.5}
    assert device_busy_ms(prof) == 2.25
    assert device_busy_ms(prof, "spectral_grads_kernel") == 2.0
    assert device_busy_ms(prof, "fused_forward_kernel") == 0.0
    host_only = types.SimpleNamespace(key_averages=lambda: rows[2:3])
    assert kernel_ms(host_only) == {} and device_busy_ms(host_only) is None


def test_a_host_only_trace_on_the_cpu_still_records_the_host():
    with trace(device="cpu", host=False) as prof:
        torch.ones(4).add_(1)
    assert any("add" in e.key for e in prof.key_averages())
