"""Confusion analysis of a trained spatial-task model.

Counterpart of `examples/analyze_spatial.py` (the JAX example, :1-88). The
original `--dataset spatial` task has an exact class aliasing: the two
blobs are identical, so the displacement v is indistinguishable from -v and
class k aliases class k + 5: the Bayes top-1 ceiling is 50%. This tool
loads a saved params npz (`train_cifar10 --save-params`, or the repo's
`docs/spatial_*_params.npz`; either package's layout) into the matching eval
net, predicts the 2,000-image test split of `synthetic_spatial(n=50000)`
in padded batches, and reports top-1, the accuracy onto the merged class
pairs (the information-limit metric of the aliased task), the fraction
predicted as exactly the aliased class, and the confusion matrix.

    python -m dau_convnet_tpu_torch.examples.analyze_spatial \\
        --params docs/spatial_dau_4000_params.npz --engine fourier

It runs on the CUDA card, and on the CPU only under `--device cpu`.
`load_model`, `predictions` (train_cifar10's padded loop) and `summarize`
are its parts, for tests and callers.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models import ConvCifarNet, DAUCifarNet
from ..utils.checkpoint import load_params_npz, params_from_flax
from . import device_for
from .train_cifar10 import predictions, synthetic_spatial

__all__ = ["load_model", "predictions", "summarize", "parse_args", "main"]


def load_model(path: str, arch: str, engine: str, device) -> torch.nn.Module:
    """The eval-mode net of `arch` ('dau' on `engine`, or 'conv') with the
    npz's parameters and BatchNorm statistics."""
    if arch == "dau":
        net = DAUCifarNet(train=False, engine=engine, device=device)
    else:
        net = ConvCifarNet(train=False, device=device)
    net.load_state_dict(params_from_flax(load_params_npz(path)))
    return net


def summarize(pred: np.ndarray, y: np.ndarray) -> dict:
    """top-1, pair accuracy (k and k + C/2 merged), the fraction predicted as
    exactly the aliased class, and the confusion matrix (rows true, columns
    predicted), as the JAX example computes them (:73-84)."""
    ncls = int(y.max()) + 1
    half = ncls // 2
    conf = np.zeros((ncls, ncls), int)
    np.add.at(conf, (y, pred), 1)
    return dict(top1=float((pred == y).mean()),
                pair=float(((pred % half) == (y % half)).mean()),
                aliased=float((pred == (y + half) % ncls).mean()),
                half=half, confusion=conf)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0], allow_abbrev=False)
    ap.add_argument("--params", required=True)
    ap.add_argument("--arch", choices=["dau", "conv"], default="dau")
    ap.add_argument("--dataset", choices=["spatial", "spatial2"], default="spatial")
    ap.add_argument("--engine", choices=["auto", "xla", "fourier"], default="fourier")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--predictions-out", default=None,
                    help="also save the test split's predictions to this .npy")
    ap.add_argument("--device", choices=["default", "cpu"], default="default",
                    help="default: the CUDA card; cpu runs on the CPU")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Predict, print the analysis and return `summarize`'s dict."""
    args = parse_args(argv)
    dev = device_for(args.device)
    _, _, x_test, y_test = synthetic_spatial(n=50000, distinct=args.dataset == "spatial2")
    net = load_model(args.params, args.arch, args.engine, dev)
    pred = predictions(net, x_test, args.batch, dev)
    if args.predictions_out:
        np.save(args.predictions_out, pred)
    s = summarize(pred, y_test)
    print(f"top-1 accuracy: {s['top1']:.4f}")
    print(f"pair (k vs k+{s['half']} merged) accuracy: {s['pair']:.4f}")
    print(f"fraction predicted exactly the aliased class: {s['aliased']:.4f}")
    print("confusion (rows=true, cols=pred):")
    print(s["confusion"], flush=True)
    return s


if __name__ == "__main__":
    main()
