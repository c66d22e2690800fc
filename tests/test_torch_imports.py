"""The port stands alone: importing it (its bench, utilities, input
pipeline, examples and probes included), or the chip smoke test that drives
it, pulls in no JAX; the probes pull in nothing of `benchmarks/` either."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import dau_convnet_tpu_torch\n"
        "import dau_convnet_tpu_torch.kernels, dau_convnet_tpu_torch.models\n"
        "import dau_convnet_tpu_torch.nn, dau_convnet_tpu_torch.utils\n"
        "import dau_convnet_tpu_torch.parallel, dau_convnet_tpu_torch.ops.fourier_engine\n"
        "import dau_convnet_tpu_torch.parallel.mesh, dau_convnet_tpu_torch.parallel._collectives\n"
        "import dau_convnet_tpu_torch.parallel._spawn\n"
        "from dau_convnet_tpu_torch.parallel.train import (TrainState, gather_state,\n"
        "    init_sharded, make_train_step)\n"
        "import dau_convnet_tpu_torch.kernels.fused_bwd, dau_convnet_tpu_torch.tools.k1_variants\n"
        "import dau_convnet_tpu_torch.bench, dau_convnet_tpu_torch.utils.tiers\n"
        "import dau_convnet_tpu_torch.utils.profiling, dau_convnet_tpu_torch.data\n"
        "from dau_convnet_tpu_torch.examples import (analyze_spatial, serve_inference,\n"
        "    train_alexnet_synth, train_cifar10)\n"
        "import dau_convnet_tpu_torch.kernels.probe_kernels, dau_convnet_tpu_torch.probes\n"
        "from dau_convnet_tpu_torch.probes import mosaic_probe, pallas_ladder\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'dau_convnet_tpu', 'benchmarks', 'bench')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
