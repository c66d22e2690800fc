"""The port stands alone: importing it pulls in no JAX."""

import subprocess
import sys


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import dau_convnet_tpu_torch\n"
        "import dau_convnet_tpu_torch.kernels, dau_convnet_tpu_torch.models\n"
        "import dau_convnet_tpu_torch.nn, dau_convnet_tpu_torch.utils\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'dau_convnet_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
