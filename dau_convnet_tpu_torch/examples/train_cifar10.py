"""Data of the 3-layer CIFAR example: the spatial-relation task and the
digits set.

Counterpart of the generators in `examples/train_cifar10.py`, copied so the
port stands alone; the same seeds give the same arrays bit for bit, so the
recorded artifacts (`docs/*_params.npz`) are checked on the same test
slices. The example's training loop is not ported yet.

    python -m dau_convnet_tpu_torch.examples.train_cifar10

prints the shapes of both data sets (`digits_32x32` needs scikit-learn).
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthetic_spatial", "digits_32x32"]


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


if __name__ == "__main__":
    for name, data in (("synthetic_spatial", synthetic_spatial(n=1000, n_test=100)),
                       ("digits_32x32", digits_32x32())):
        print(name, [a.shape for a in data])
