"""The port's probes (P1-P9) against the Pallas probes of `benchmarks/`.

`benchmarks/mosaic_probe.py` and `benchmarks/pallas_ladder.py` are loaded
by path, and their `pl` replaced, in the loaded module only, by one whose
`pallas_call` runs in interpret mode and records each call's inputs and
output. Each probe then runs as written (`time_chained` cut to one call,
`pallas_ladder.C` cut to 16,384 columns), and the port's wrappers, on the
CPU their plain twins, are held against the recorded Pallas outputs on the
recorded inputs:
- P1, P2, P5, P6 (the probe GEMM) within 1e-4 * max|ref|: the bf16
  products are exact in f32, only the order of the sums differs;
- P3, P4, P8 exactly (sums of integers, x + 1 in bf16, a copy);
- P9 (K7's kernel, a bf16 table) within 1e-2 * max|ref|, one bf16 rounding.

P7's Pallas body does not trace as written (`mosaic_probe.py:209`); its twin
is held, exactly, against the probe's own einsum reference (:222-224),
recorded from the probe's run. The card's side of each kernel is in
`tests/test_torch_cuda.py`.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dau_convnet_tpu_torch.kernels import probe_kernels as pk
from dau_convnet_tpu_torch.kernels import spectral as ksp
from dau_convnet_tpu_torch.probes import mosaic_probe as tmp
from dau_convnet_tpu_torch.probes import pallas_ladder as tpl

ROOT = Path(__file__).resolve().parents[1]


class _Recording:
    """A stand-in for a module (`pl` or `jnp`) in a loaded probe: every
    attribute is the module's, but `pallas_call` runs in interpret mode and
    records ([inputs], output) of each call, and `einsum` records its
    results."""

    def __init__(self, module):
        self._module, self.calls, self.einsums = module, [], []

    def __getattr__(self, name):
        return getattr(self._module, name)

    def pallas_call(self, *args, **kwargs):
        run = self._module.pallas_call(*args, **{**kwargs, "interpret": True})

        def call(*xs):
            out = run(*xs)
            self.calls.append(([np.asarray(x) for x in xs], np.asarray(out)))
            return out
        return call

    def einsum(self, *args, **kwargs):
        out = self._module.einsum(*args, **kwargs)
        self.einsums.append(np.asarray(out))
        return out


def _load(name, monkeypatch):
    """The JAX probe script `benchmarks/<name>.py`, loaded by path, its `pl`
    recording and `time_chained` cut to one call."""
    monkeypatch.syspath_prepend(str(ROOT))  # the scripts import the root bench.py
    path = ROOT / "benchmarks" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rec = _Recording(mod.pl)
    monkeypatch.setattr(mod, "pl", rec)
    monkeypatch.setattr(mod, "time_chained", lambda step, carry, *a, **k: (step(carry), 1.0)[1])
    return mod, rec


def _t(a, dtype=None):
    """A recorded numpy array (bf16 ones included) as a torch tensor."""
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t if dtype is None else t.to(dtype)


def _close(got, ref, tol):
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    if tol == 0:
        np.testing.assert_array_equal(got, ref)
    else:
        err = float(np.abs(got - ref).max())
        assert err <= tol * float(np.abs(ref).max()), (err, float(np.abs(ref).max()))


BF = torch.bfloat16


def _p1(mod, rec):
    mod.t_3d_dot()
    (d, t), out = rec.calls[0]
    k, a, b = t.shape
    _close(pk.probe_gemm(_t(d, BF), _t(t, BF).reshape(k, a * b)).reshape(-1, a, b), out, 1e-4)


def _p2(mod, rec):
    mod.t_3d_dot_batched()
    (t, d), out = rec.calls[0]
    _close(pk.probe_gemm(_t(t, BF), _t(d, BF), trans_a=True), out, 1e-4)


def _p3(mod, rec):
    mod.t_vmem(4)
    (x,), out = rec.calls[0]
    _close(pk.scale_colsum(_t(x)), out, 0)


def _p4(mod, rec):
    mod.t_grid_overhead()
    assert len(rec.calls) == 2  # 16 and 256 grid steps
    for (x,), out in rec.calls:
        _close(pk.add_one(_t(x, BF)), out, 0)


def _p5(mod, rec):
    mod.t_batched_dot()
    (a, b), out = rec.calls[0]
    _close(pk.probe_gemm(_t(a, BF), _t(b, BF)), out, 1e-4)


def _p6(mod, rec):
    mod.t_batched_dot_4d()
    (a, b), out = rec.calls[0]
    bb, mm, ss, kk = a.shape
    got = pk.probe_gemm(_t(a, BF).reshape(bb, mm * ss, kk), _t(b, BF))
    _close(got.reshape(out.shape), out, 1e-4)


def _ladder(mod, rec, monkeypatch, n_inputs):
    monkeypatch.setattr(mod, "C", 16384)
    mod.main()
    calls = [c for c in rec.calls if len(c[0]) == n_inputs]
    assert len(calls) == 2  # chunks of 2,048 and 8,192 columns
    return calls


def _p8(mod, rec, monkeypatch):
    for ch, ((x,), out) in zip(tpl.CHUNKS, _ladder(mod, rec, monkeypatch, 1)):
        _close(tpl.run_copy(_t(x, BF), ch), out, 0)


def _p9(mod, rec, monkeypatch):
    for ch, ((cm, sm, tre, tim), out) in zip(tpl.CHUNKS, _ladder(mod, rec, monkeypatch, 4)):
        ops = [_t(v, BF) for v in (cm, sm, tre, tim)]
        _close(ksp.partial_idft(*ops, out_dtype=BF), out, 1e-2)
        _close(tpl.run_dot(*ops, ch), out, 1e-2)


# probe -> (JAX script, check)
PROBES = {"P1": ("mosaic_probe", _p1), "P2": ("mosaic_probe", _p2),
          "P3": ("mosaic_probe", _p3), "P4": ("mosaic_probe", _p4),
          "P5": ("mosaic_probe", _p5), "P6": ("mosaic_probe", _p6),
          "P8": ("pallas_ladder", _p8), "P9": ("pallas_ladder", _p9)}


@pytest.mark.parametrize("probe", sorted(PROBES))
def test_twin_matches_the_pallas_probe_in_interpret_mode(probe, monkeypatch):
    script, check = PROBES[probe]
    mod, rec = _load(script, monkeypatch)
    if script == "pallas_ladder":
        check(mod, rec, monkeypatch)
    else:
        check(mod, rec)


def test_p7_twin_matches_the_probes_einsum_exactly(monkeypatch):
    """The probe runs as written, its Pallas call answered by the port's
    twin on the probe's inputs; the twin must equal the probe's reference
    einsum bit for bit (at most one of its P terms is nonzero)."""
    mod, rec = _load("mosaic_probe", monkeypatch)
    got = []

    def pallas_call(*args, **kwargs):
        def call(tab, tgt, iw):
            got.append(pk.probe_gather(*(_t(v) for v in (tab, tgt, iw))))
            return jnp.asarray(got[-1].numpy())
        return call

    monkeypatch.setattr(rec, "pallas_call", pallas_call)
    jnp_rec = _Recording(mod.jnp)
    monkeypatch.setattr(mod, "jnp", jnp_rec)
    mod.t_gather_loop()
    assert len(got) == 1 and len(jnp_rec.einsums) == 1
    _close(got[0], jnp_rec.einsums[0], 0)


def test_p7_pallas_body_does_not_trace(monkeypatch):
    """Why P7's reference is its einsum: the Pallas body's broadcast of the
    mask (1, S, G, 1, F) against the slab (M, S, 1, F) fails."""
    mod, _ = _load("mosaic_probe", monkeypatch)
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        mod.t_gather_loop()


def test_gather_twin_misses_fractions_negatives_nan_and_out_of_range():
    rng = np.random.default_rng(1)
    tab = torch.from_numpy(rng.standard_normal((5, 2, 3, 4)).astype(np.float32))
    tgt = torch.tensor([[[0.0, 4.0, 5.0, -1.0]], [[2.5, float("nan"), 3.0, 1.0]],
                        [[4.0, -0.0, 1e9, 2.0]]])
    iw = torch.from_numpy(rng.random((3, 1, 4)).astype(np.float32))
    got = pk.probe_gather(tab, tgt, iw)
    want = torch.zeros((2, 3, 1, 4))
    for s in range(3):
        for f in range(4):
            t = float(tgt[s, 0, f])
            if t == t and 0 <= t < 5 and t == int(t):
                want[:, s, 0, f] = iw[s, 0, f] * tab[int(t), :, s, f]
    assert torch.equal(got, want)


# (a shape, b shape, trans_a): P1, P2 and P5's layouts, and views with
# strides TMA takes as they are
GEMM_CASES = {
    "P1 K-major, rows of 153": ((81, 153), (153, 300), False),
    "P2 M-major, shared B of rows 81": ((4, 153, 128), (153, 81), True),
    "P5 batched": ((3, 40, 64), (3, 64, 24), False),
    "shared A": ((17, 24), (2, 24, 16), False),
}


@pytest.mark.parametrize("case", sorted(GEMM_CASES))
def test_probe_gemm_layout_reads_the_operands(case):
    """Emulate the kernel's reads from what `gemm_layout` hands it (strides
    into the padded storage) and hold the product against the twin."""
    a_shape, b_shape, trans_a = GEMM_CASES[case]
    rng = np.random.default_rng(2)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(BF)
            for s in (a_shape, b_shape))
    a3, b3, (lda, a_bs, ldb, b_bs, batch, m, n, k) = pk.gemm_layout(a, b, trans_a)
    for t, ld in ((a3, lda), (b3, ldb)):
        assert ld % 8 == 0 and t.data_ptr() % 16 == 0
    a_strides = (a_bs, 1, lda) if trans_a else (a_bs, lda, 1)
    av = torch.as_strided(a3, (batch, m, k), a_strides, a3.storage_offset())
    bv = torch.as_strided(b3, (batch, k, n), (b_bs, ldb, 1), b3.storage_offset())
    got = torch.bmm(av.float(), bv.float())
    want = pk.probe_gemm_plain(a, b, trans_a)
    assert torch.equal(got.reshape(want.shape), want)


def test_gemm_operand_pads_only_rows_tma_cannot_read():
    ragged = torch.ones((81, 153), dtype=BF)
    padded = pk.gemm_operand(ragged)
    assert padded.shape == ragged.shape and padded.stride(0) == 160
    assert torch.equal(padded, ragged)
    ready = torch.ones((153, 16384), dtype=BF)
    assert pk.gemm_operand(ready) is ready
    view = torch.ones((4, 160), dtype=BF)[:, :153]
    assert pk.gemm_operand(view) is view


def test_stream_twins():
    x = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    assert torch.equal(pk.scale_colsum(x), 2 * x.sum(0, keepdim=True))
    y = torch.tensor([0.5, 255.0, 256.0, -1.0, 3.0, 7.0, 1e30, -2.0], dtype=BF)
    out = torch.empty_like(y)
    assert pk.add_one(y, out=out) is out
    assert torch.equal(out, (y.float() + 1).to(BF))
    z = torch.randn((3, 16)).to(BF)
    assert torch.equal(pk.copy_tiles(z, 8), z)


def _meta_calls():
    meta = torch.device("meta")
    return {
        "probe_gemm": lambda: pk.probe_gemm(torch.empty((8, 8), dtype=BF, device=meta),
                                            torch.empty((8, 8), dtype=BF, device=meta)),
        "probe_gather": lambda: pk.probe_gather(torch.empty((2, 1, 3, 4), device=meta),
                                                torch.empty((3, 1, 4), device=meta),
                                                torch.empty((3, 1, 4), device=meta)),
        "scale_colsum": lambda: pk.scale_colsum(torch.empty((4, 8), device=meta)),
        "add_one": lambda: pk.add_one(torch.empty((4, 8), dtype=BF, device=meta)),
        "copy_tiles": lambda: pk.copy_tiles(torch.empty((4, 8), dtype=BF, device=meta), 8),
    }


@pytest.mark.parametrize("name", sorted(_meta_calls()))
def test_wrapper_raises_on_a_device_other_than_cpu_or_cuda(name):
    before = getattr(pk, name).launches
    with pytest.raises(RuntimeError, match="has no kernel for device meta"):
        _meta_calls()[name]()
    assert getattr(pk, name).launches == before


@pytest.mark.parametrize("bad", ["f32 operand", "K mismatch", "batches differ"])
def test_probe_gemm_refuses_what_the_kernel_does_not_take(bad):
    a, b = torch.ones((2, 4, 8), dtype=BF), torch.ones((2, 8, 16), dtype=BF)
    if bad == "f32 operand":
        a = a.float()
    elif bad == "K mismatch":
        b = torch.ones((2, 9, 16), dtype=BF)
    else:
        b = torch.ones((3, 8, 16), dtype=BF)
    with pytest.raises((TypeError, ValueError)):
        pk.probe_gemm(a, b)


def test_mosaic_probe_cli_runs_the_named_probes_on_the_cpu(capsys):
    assert tmp.main(["--device", "cpu", "batched_dot"]) == 0
    out = capsys.readouterr().out
    assert out.count("PASS ") == 2 and "FAIL" not in out  # P5 and P6
    assert "P5 (B,M,K)x(B,K,N) [probe_gemm]" in out and "no device times" in out


def test_mosaic_probe_cli_fails_when_a_probe_fails(monkeypatch, capsys):
    def broken(device):
        raise AssertionError("mismatch")
    monkeypatch.setattr(tmp, "TESTS", (("gather_loop", broken),))
    assert tmp.main(["--device", "cpu"]) == 1
    assert "FAIL gather_loop: AssertionError: mismatch" in capsys.readouterr().out


def test_pallas_ladder_cli_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(tpl, "C", 16384)
    assert tpl.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("PASS ") == 2 and "P9 dot ch=2048 (8 launches)" in out


@pytest.mark.parametrize("main", [tmp.main, tpl.main], ids=["mosaic_probe", "pallas_ladder"])
def test_probe_clis_stop_without_a_card(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main([])
