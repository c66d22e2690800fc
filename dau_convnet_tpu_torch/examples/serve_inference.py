"""Serving-path example: export a DAU model and run batched inference.

Counterpart of `examples/serve_inference.py` (the JAX example, :1-68),
where `jax.export` traces the jitted forward into a serialized StableHLO
artifact. Here `torch.export.export` traces `DAUCifarNet` in eval mode (f32)
into an `ExportedProgram`, `torch.export.save` writes it to bytes, and the
serving side rehydrates it with `torch.export.load` and calls `.module()`,
with no model code. The round trip must hold max|diff| < 1e-5 (:44-45
there); then 50 chained batch-8 requests are timed (CUDA events on the
card). The net is exported on two engines: 'xla' (what 'auto' resolves to
at f32, cuDNN convolutions) and 'fourier' (matmuls against DFT matrices),
as tests/test_export.py exports both; neither forward launches a
hand-written kernel (their kernels are backward-only or on the 'pallas'
engines), so the exported programs hold torch ops only.

    python -m dau_convnet_tpu_torch.examples.serve_inference

It runs on the CUDA card, and on the CPU only under `--device cpu`.
"""

from __future__ import annotations

import argparse
import io

import numpy as np
import torch

from ..models import DAUCifarNet
from ..utils.profiling import device_time
from . import device_for

__all__ = ["export_forward", "load_forward", "serve", "parse_args", "main"]

ENGINES = ("xla", "fourier")


def export_forward(model: torch.nn.Module, x: torch.Tensor) -> bytes:
    """The model's forward on inputs shaped like x, traced by
    `torch.export.export` (without gradients) and serialized by
    `torch.export.save`."""
    with torch.no_grad():
        program = torch.export.export(model, (x,))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_forward(blob: bytes):
    """The serving side: the exported program's callable module, loaded
    from bytes without the model's code."""
    return torch.export.load(io.BytesIO(blob)).module()


def serve(engine: str, device, iters: int = 50, seed: int = 0) -> dict:
    """Export `DAUCifarNet(engine)` at batch 8 of 3x32x32 f32, check the
    round trip and time `iters` chained requests through the loaded
    program. Returns the artifact's size, the round trip's max|diff| and
    the ms per request."""
    rng = np.random.default_rng(seed)
    model = DAUCifarNet(train=False, engine=engine, device=device,
                        generator=torch.Generator().manual_seed(seed))
    x = torch.from_numpy(rng.random((8, 3, 32, 32), dtype=np.float32)).to(device)
    blob = export_forward(model, x)
    served = load_forward(blob)
    with torch.no_grad():
        err = float((model(x) - served(x)).abs().max())
    if not err < 1e-5:
        raise AssertionError(f"{engine}: round trip max|diff| {err}")

    state = {"x": x, "out": None}

    def request():
        # a data-dependent chain, so no request can be skipped or reordered
        if state["out"] is not None:
            state["x"] = state["x"] + state["out"].mean() * 1e-30
        state["out"] = served(state["x"])

    with torch.no_grad():
        ms = device_time(request, iters=iters, device=torch.device(device).type) * 1e3
    return dict(engine=engine, artifact_mb=len(blob) / 1e6, roundtrip_max_abs_diff=err,
                ms_per_request=ms)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=50, help="timed requests per engine")
    ap.add_argument("--device", choices=["default", "cpu"], default="default",
                    help="default: the CUDA card; cpu runs on the CPU")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Export, check and time each engine; returns their results."""
    args = parse_args(argv)
    dev = device_for(args.device)
    results = []
    for engine in ENGINES:
        r = serve(engine, dev, args.iters)
        print(f"{engine}: exported program {r['artifact_mb']:.2f} MB; round-trip max |diff| "
              f"= {r['roundtrip_max_abs_diff']:.2e}")
        print(f"{engine}: batch-8 32x32 inference: {r['ms_per_request']:.3f} ms/batch "
              f"({8e3 / r['ms_per_request']:.0f} img/s) on {dev.type}", flush=True)
        results.append(r)
    return results


if __name__ == "__main__":
    main()
