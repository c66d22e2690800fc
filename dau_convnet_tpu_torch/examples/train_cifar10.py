"""Train the 3-layer DAU ConvNet on CIFAR-10 (or digits / synthetic data).

Counterpart of `examples/train_cifar10.py` (the JAX example, :1-395): the
3-layer DAU network with batch norm (`DAUCifarNet`, or its 3x3-conv control
`ConvCifarNet` under `--arch conv`), trained with SGD + momentum 0.9 and
the reference defaults (mu_learning_rate_factor=500, sigma=0.5, units 2x2,
k=9), its DAU parameters clipped into their bounds after every step.

    python -m dau_convnet_tpu_torch.examples.train_cifar10 --dataset spatial --steps 600
    python -m dau_convnet_tpu_torch.examples.train_cifar10 --device cpu --dataset digits

It runs on the CUDA card, and on the CPU only under `--device cpu`.
Datasets: `--dataset digits` (sklearn's bundled digits, upscaled to
32x32x3), `synthetic` (random images with class-dependent means),
`spatial`/`spatial2` (the spatial-relation task at CIFAR scale, made from a
seed), or `--data-npz PATH`, a CIFAR-10 npz (x_train [N, 32, 32, 3] uint8,
y_train, optionally x_test/y_test). Every flag of the JAX example is here
but its pre-import `--device` scan; `--device default` is the card.

The pieces are module-level functions, so tests and the chip smoke test
drive them: `check_dau_health` (:64 there), `synthetic_cifar` (:75),
`load_data` (:160), `save_params_npz` (:185), `make_train_step` and
`test_accuracy` (closures of `main` there, :276 and :307; its padded
loop is `predictions`), the
`--auto-tier` decisions `initial_offset` and `retier` (:267-274, :345-357)
with `set_static_max_offset`, and `main(argv)` (:193), which returns the
result it prints as its JSON line (:364-382).

BatchNorm momentum: the JAX example's default decay min(0.9999, max(0.9,
1 - 25/total_steps)) (:248-249) is flax's; the models here take PyTorch's
convention, so they get 1 minus it (`flax_bn_momentum`), and the run
prints flax's number as JAX does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from ..bench import device_label
from ..data import epoch_batches, prefetch_to_device
from ..models import ConvCifarNet, DAUCifarNet
from ..nn import DAUConv2d, project_dau_params
from ..utils.checkpoint import params_to_flax, save_checkpoint
from ..utils.checkpoint import save_params_npz as _save_npz
from ..utils.math import validate_dau_params
from ..utils.tiers import max_offset_in_tree, retier_offset, snap_kernel_tier
from . import device_for

__all__ = ["synthetic_spatial", "digits_32x32", "synthetic_cifar", "load_data",
           "check_dau_health", "save_params_npz", "flax_bn_momentum", "build_model",
           "make_train_step", "predictions", "test_accuracy", "initial_offset", "retier",
           "set_static_max_offset", "parse_args", "main"]


def _dau_layers(model):
    return [m for m in model.modules() if isinstance(m, DAUConv2d)]


def check_dau_health(model: torch.nn.Module, kernel_size: int) -> None:
    """Host-side runtime guards between steps: the live equivalent of the
    reference's per-step NaN/offset-bound checks (dau_conv_op.cpp:258-262,
    dau_conv_forward.cpp:156-158), `validate_dau_params` on every DAU layer
    of the model. Raises ValueError on divergence."""
    for layer in _dau_layers(model):
        validate_dau_params(layer.weights, layer.mu1, layer.mu2, layer.sigma,
                            kernel_size=kernel_size)


def synthetic_cifar(n=2048, num_classes=10, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, (n,))
    # class-dependent means make the task learnable
    means = rng.normal(0, 0.5, (num_classes, 3, 1, 1)).astype(np.float32)
    x = rng.normal(0, 1.0, (n, 3, 32, 32)).astype(np.float32) + means[y]
    return x, y.astype(np.int32), x[:512], y[:512].astype(np.int32)


def synthetic_spatial(n=50000, num_classes=10, seed=0, n_test=2000,
                      distinct=False):
    """CIFAR-scale spatial-RELATION task (zero-egress stand-in for real
    CIFAR at full 50k x 32x32x3 scale): every image contains two
    Gaussian blobs; the class is encoded ONLY in the displacement vector
    between them (angle = class * 2pi/10, radius 9px, +-1px jitter), at a
    random absolute position, polarity-randomized per blob pair, over
    pixel noise with a distractor blob. No class-dependent color/intensity
    statistics exist, so a classifier must integrate features at
    class-specific relative offsets - the aggregation-by-displacement
    regime DAUs target (reference paper positioning) - rather than match
    local appearance.

    distinct=False (the original task): the two blobs are IDENTICAL, so v
    and -v are indistinguishable and classes k and k + num_classes/2 alias
    exactly - the Bayes ceiling is 50% top-1 (measured: trained nets sit
    at 0.49-0.50 top-1 with ~0.97 accuracy onto the merged class-pairs,
    i.e. the task is solved to its information limit; see
    examples/analyze_spatial.py). distinct=True ('spatial2') breaks the
    ambiguity - blob B is wider (sigma 2.4 vs 1.4) at the same amplitude,
    so the displacement DIRECTION is identifiable and the ceiling is
    ~100%."""
    rng = np.random.default_rng(seed)
    total = n + n_test
    y = rng.integers(0, num_classes, (total,))
    size = 32
    r = 9.0
    ang = 2 * np.pi * y / num_classes
    jitter = rng.uniform(-1, 1, (2, total))
    dx = r * np.cos(ang) + jitter[0]
    dy = r * np.sin(ang) + jitter[1]
    # blob A center anywhere such that both blobs stay in-frame
    ax = rng.uniform(np.maximum(3, 3 - dx), np.minimum(size - 3, size - 3 - dx))
    ay = rng.uniform(np.maximum(3, 3 - dy), np.minimum(size - 3, size - 3 - dy))
    bx, by = ax + dx, ay + dy
    # distractor at an unrelated position
    cx = rng.uniform(3, size - 3, total)
    cy = rng.uniform(3, size - 3, total)
    sign = rng.choice([-1.0, 1.0], total).astype(np.float32)
    ii = np.arange(size, dtype=np.float32)
    x = rng.normal(0, 0.3, (total, size, size)).astype(np.float32)
    sig_b = 2.4 if distinct else 1.4
    for px, py, amp, sg in ((ax, ay, sign, 1.4), (bx, by, sign, sig_b),
                            (cx, cy, 0.7 * sign, 1.4)):
        gx = np.exp(-0.5 * ((ii[None, :] - px[:, None]) / sg) ** 2)
        gy = np.exp(-0.5 * ((ii[None, :] - py[:, None]) / sg) ** 2)
        x += amp[:, None, None] * gy[:, :, None] * gx[:, None, :]
    x = np.broadcast_to(x[:, None], (total, 3, size, size)).reshape(
        total, 3, size, size).copy()
    y = y.astype(np.int32)
    return x[:n], y[:n], x[n:], y[n:]


def digits_32x32(test_frac=0.2, seed=0):
    """sklearn's bundled digits set as 32x32x3 NCHW: each real 8x8 image is
    4x nearest-upscaled and replicated across channels; a stratified split
    holds out `test_frac` for the accuracy measurement."""
    from sklearn.datasets import load_digits

    d = load_digits()
    x = d.images.astype(np.float32) / 16.0 - 0.5         # (N, 8, 8)
    x = x.repeat(4, axis=1).repeat(4, axis=2)            # (N, 32, 32)
    x = np.broadcast_to(x[:, None], (x.shape[0], 3, 32, 32)).copy()
    y = d.target.astype(np.int32)
    rng = np.random.default_rng(seed)
    test_idx = []
    for cls in range(10):
        cls_idx = np.flatnonzero(y == cls)
        take = int(round(len(cls_idx) * test_frac))
        test_idx.append(rng.permutation(cls_idx)[:take])
    test_idx = np.concatenate(test_idx)
    mask = np.zeros(len(y), bool)
    mask[test_idx] = True
    return x[~mask], y[~mask], x[mask], y[mask]


def load_data(args):
    """(x_train, y_train, x_test, y_test) as NCHW f32 and int32 numpy arrays
    for `args.data_npz`, else `args.dataset` (`args.train_size` images for
    the spatial tasks)."""
    if args.data_npz:
        d = np.load(args.data_npz)
        x = (d["x_train"].astype(np.float32) / 255.0 - 0.5).transpose(0, 3, 1, 2)
        y = d["y_train"].astype(np.int32).reshape(-1)
        if "x_test" in d:
            xt = (d["x_test"].astype(np.float32) / 255.0 - 0.5).transpose(0, 3, 1, 2)
            yt = d["y_test"].astype(np.int32).reshape(-1)
        else:
            # shuffle before the 90/10 carve: a class-sorted npz would
            # otherwise yield a single-class test set
            perm = np.random.default_rng(0).permutation(len(x))
            x, y = x[perm], y[perm]
            n = int(len(x) * 0.9)
            x, xt, y, yt = x[:n], x[n:], y[:n], y[n:]
        return x, y, xt, yt
    if args.dataset == "digits":
        return digits_32x32()
    if args.dataset == "spatial":
        return synthetic_spatial(n=args.train_size)
    if args.dataset == "spatial2":
        return synthetic_spatial(n=args.train_size, distinct=True)
    return synthetic_cifar()


def save_params_npz(path, model: torch.nn.Module) -> None:
    """Record the model's parameters and BatchNorm statistics as one npz in
    the JAX package's layout ('params/...', 'batch_stats/...'), the artifact
    that either package's `load_params_npz` reads back
    (`docs/*_params.npz`)."""
    _save_npz(path, **params_to_flax(model.state_dict()))


def flax_bn_momentum(total_steps: int, bn_momentum: tp.Optional[float] = None) -> float:
    """The JAX example's BatchNorm momentum (flax's EMA decay): the given
    one, else the reference's 0.9999 scaled down to the run, so the EMA
    horizon 1/(1 - m) is at most ~4% of it (at 2,750 digits steps 0.9999
    leaves the running variance ~80x stale and eval accuracy at chance,
    docs/TRAINING_RESULTS.md). The models take 1 minus it."""
    if bn_momentum is not None:
        return bn_momentum
    return min(0.9999, max(0.9, 1.0 - 25.0 / total_steps))


def build_model(args, bn_momentum: float, device) -> torch.nn.Module:
    """The run's net in train mode (`bn_momentum` is flax's), its weights
    drawn from `args.seed`."""
    gen = torch.Generator().manual_seed(args.seed)
    if args.arch == "conv":
        return ConvCifarNet(train=True, bn_momentum=1.0 - bn_momentum, device=device,
                            generator=gen)
    return DAUCifarNet(train=True, bn_momentum=1.0 - bn_momentum,
                       dau_sigma_trainable=args.sigma_trainable, engine=args.engine,
                       device=device, generator=gen)


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer, arch: str,
                    kernel_size: int):
    """`step(x, y) -> (loss, acc)`, both 0-d tensors left on the device: the
    mean softmax cross-entropy and the batch accuracy of one train-mode
    forward, its backward, one optimizer step, and for the DAU net the
    parameters' storage clipped into the reference bounds
    (`project_dau_params`, the reference's in-place guard; the gradients at
    the bounds keep flowing). Reads the model's DAU layers' settings at each
    call, so `set_static_max_offset` takes effect at the next step."""
    def step(x, y):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model(x)
        loss = F.cross_entropy(logits, y)
        acc = (logits.argmax(-1) == y).float().mean()
        loss.backward()
        optimizer.step()
        if arch == "dau":
            project_dau_params(model, kernel_size=kernel_size)
        return loss.detach(), acc

    return step


def predictions(model: torch.nn.Module, x: np.ndarray, batch: int, device) -> np.ndarray:
    """argmax of the model's logits (in its current mode, without gradients)
    for every image of x, in batches of `batch`: the last one padded with
    the first images and its padding dropped, so every forward has the same
    shape."""
    n_pad = (-len(x)) % batch
    xt = np.concatenate([x, x[:n_pad]]) if n_pad else x
    preds = []
    with torch.no_grad():
        for i in range(0, len(xt), batch):
            logits = model(torch.from_numpy(xt[i:i + batch]).to(device))
            preds.append(logits.argmax(-1).cpu().numpy())
    return np.concatenate(preds)[:len(x)]


def test_accuracy(model: torch.nn.Module, x_test, y_test, batch: int, device) -> float:
    """Top-1 of the model in eval mode (running BatchNorm statistics) on the
    test split, through `predictions`. The model is left in train mode."""
    if len(x_test) == 0:
        return float("nan")
    model.eval()
    try:
        pred = predictions(model, x_test, batch, device)
    finally:
        model.train()
    return int((pred == y_test).sum()) / len(x_test)


test_accuracy.__test__ = False  # not a pytest test, whatever its name


def set_static_max_offset(model: torch.nn.Module, offset: float) -> None:
    """Every DAU layer's tap bound, in place: the layer's clip
    (`static_max_offset`) and its op's settings (`cfg.static_max_offset`,
    which sizes the synthesized kernel and the Fourier bins). The JAX
    example rebuilds the net with `net.clone(static_max_offset=...)` and
    re-jits; here the parameters and the optimizer's state stay as they
    are."""
    for layer in _dau_layers(model):
        layer.static_max_offset = offset
        layer.cfg = dataclasses.replace(layer.cfg, static_max_offset=offset)
        layer.clear_phi_cache()


def initial_offset(model: torch.nn.Module, kernel_size: int) -> float:
    """The first tier of `--auto-tier`: the live max|mu| plus 0.5 of slack
    (so small drifts do not force a re-tier at every check), rounded up and
    capped at kernel_size // 2."""
    return float(min(math.ceil(max_offset_in_tree(model) + 0.5), kernel_size // 2))


def retier(model: torch.nn.Module, kernel_size: int):
    """One `--auto-tier` check between steps, in both directions: grow at
    once when the live offsets pass the bound (the op clips to it), shrink
    when the snapped bound falls (smaller synthesized kernel, fewer bins);
    `retier_offset`'s policy, the full replacement of the reference's
    per-step amax dispatch. Applies the new bound and returns (live, old,
    new), or None when it stays."""
    live = max_offset_in_tree(model)
    current = _dau_layers(model)[0].static_max_offset
    off = retier_offset(live, current, kernel_size)
    if off is None:
        return None
    set_static_max_offset(model, off)
    return live, current, off


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0], allow_abbrev=False)
    ap.add_argument("--steps", type=int, default=None,
                    help="total train steps (overrides --epochs)")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--dataset", choices=["synthetic", "digits", "spatial", "spatial2"],
                    default="synthetic")
    ap.add_argument("--train-size", type=int, default=50000,
                    help="train-set size for --dataset spatial (CIFAR scale)")
    ap.add_argument("--data-npz", default=None,
                    help="real CIFAR-10 npz (overrides --dataset)")
    ap.add_argument("--arch", choices=["dau", "conv"], default="dau")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-params", default=None,
                    help="write final params/batch_stats to this npz")
    ap.add_argument("--check-every", type=int, default=100,
                    help="host-side param guard + kernel-tier check interval")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="eval on the test split every N steps (0 = only at end)")
    ap.add_argument("--bn-momentum", type=float, default=None,
                    help="batch-norm EMA momentum as flax counts it (0.9999 keeps "
                         "99.99%% of the running value); default scales the reference's "
                         "0.9999 (a ~10k-step horizon, README.md:252) down to the run "
                         "length so eval-mode running stats can actually converge")
    ap.add_argument("--engine", default="auto", choices=["auto", "xla", "fourier"],
                    help="DAU engine; 'auto' is 'xla' at f32; fourier runs its unit "
                         "gradients through the fused spectral kernel (K1) at G = 4")
    ap.add_argument("--sigma-trainable", action="store_true",
                    help="learn the layer-shared sigma (reference dau_sigma_trainable, "
                         "dau_conv.py:254); the op clips it into [0.3, blur support]")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["default", "cpu"], default="default",
                    help="default: the CUDA card; cpu runs on the CPU")
    ap.add_argument("--auto-tier", action="store_true",
                    help="pick static_max_offset from live offsets and change it when "
                         "the tier moves (the reference's dynamic kernel-size "
                         "optimization, dau_conv_op.cpp:223-256)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train, evaluate and print the JSON result line; returns the result.
    Beside the JAX example's fields, it carries `all_finite` (every step's
    loss) and, under --auto-tier, the tier of each change as `auto_tier`
    ([step, static_max_offset], the first at step 0)."""
    args = parse_args(argv)
    dev = device_for(args.device)
    x_all, y_all, x_test, y_test = load_data(args)
    steps_per_epoch = max(1, len(x_all) // args.batch)
    total_steps = args.steps or args.epochs * steps_per_epoch
    bn_momentum = flax_bn_momentum(total_steps, args.bn_momentum)
    model = build_model(args, bn_momentum, dev)
    kernel_size = model.dau_conv1.max_kernel_size if args.arch == "dau" else 0
    print(f"arch={args.arch} train={len(x_all)} test={len(x_test)} "
          f"steps={total_steps} ({steps_per_epoch}/epoch) "
          f"bn_momentum={bn_momentum:.4f}", flush=True)

    optimizer = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9)
    tiers = []
    if args.auto_tier and args.arch == "dau":
        off = initial_offset(model, kernel_size)
        set_static_max_offset(model, off)
        tiers.append([0, off])
        print(f"auto-tier: static_max_offset={off:g} (tier {snap_kernel_tier(off)})")
    train_step = make_train_step(model, optimizer, args.arch, kernel_size)

    data_rng = np.random.default_rng(args.seed + 1)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    t0 = time.time()
    step = 0
    while step < total_steps:
        batches = epoch_batches(x_all, y_all, args.batch, rng=data_rng)
        for x, y in prefetch_to_device(batches, size=2, device=dev):
            loss, acc = train_step(x, y.long())
            finite &= torch.isfinite(loss)
            if step % 50 == 0 or step == total_steps - 1:
                print(f"step {step:4d}  loss {float(loss):.4f}  "
                      f"acc {float(acc):.3f}  ({(time.time() - t0):.1f}s)", flush=True)
            step += 1
            if args.eval_every and step % args.eval_every == 0:
                print(f"step {step:4d}  TEST acc "
                      f"{test_accuracy(model, x_test, y_test, args.batch, dev):.4f}",
                      flush=True)
            if args.check_every and step % args.check_every == 0 and args.arch == "dau":
                # runtime guards on the parameters' values, between steps
                check_dau_health(model, kernel_size)
                if args.auto_tier:
                    moved = retier(model, kernel_size)
                    if moved is not None:
                        live, old, off = moved
                        print(f"offsets now {live:.2f}: static_max_offset {old:g} -> "
                              f"{off:g}", flush=True)
                        tiers.append([step, off])
            if step >= total_steps:
                break

    final_acc = test_accuracy(model, x_test, y_test, args.batch, dev)
    wall = time.time() - t0
    result = {
        "arch": args.arch,
        "dataset": "cifar10-npz" if args.data_npz else args.dataset,
        "steps": total_steps,
        "test_accuracy": round(float(final_acc), 4),
        "wall_s": round(wall, 1),
        "device": device_label(dev),
        "all_finite": bool(finite),
    }
    if tiers:
        result["auto_tier"] = tiers
    if args.arch == "dau":
        # raw param + the effective (clipped) sigma the op actually uses;
        # the raw value can sit below the 0.3 floor by a momentum tail
        # (the clip in the op zeroes the out-of-range gradient)
        result["sigma"] = {layer: round(float(m.sigma.detach().reshape(-1)[0]), 4)
                           for layer, m in model.named_children() if hasattr(m, "mu1")}
        result["sigma_effective"] = {k: round(min(max(v, 0.3), 1.6), 4)
                                     for k, v in result["sigma"].items()}
        result["sigma_trainable"] = bool(args.sigma_trainable)
    print(json.dumps(result), flush=True)

    if args.save_params:
        save_params_npz(args.save_params, model)
        print(f"saved params to {args.save_params}")
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, total_steps, {"model": model})
        print(f"saved checkpoint to {args.ckpt_dir}")
    return result


if __name__ == "__main__":
    main()
