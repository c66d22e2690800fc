"""The example scripts of the port, each run as `python -m
dau_convnet_tpu_torch.examples.<name>`: `train_cifar10`,
`train_alexnet_synth`, `serve_inference`, `analyze_spatial`."""

import torch


def device_for(name: str) -> torch.device:
    """The device of an example's `--device`: 'default' is the CUDA card,
    and without one the example stops; 'cpu' runs on the CPU."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")
    return torch.device("cuda")
