"""Port vs JAX: the input pipeline (`data/loader.py`) and the CIFAR
example's data loading.

`epoch_batches` must give the JAX iterator's batches bit for bit from the
same generator state; `prefetch_to_device` on the CPU yields the batches in
order as `torch.from_numpy` views (no copy) and raises the producer's
exception in the consumer, as JAX's does; `load_data` reads a CIFAR-10 npz
(with and without a test split) into the arrays JAX's `load_data` gives,
bit for bit. The card path of the prefetcher (pinned copies on a side
stream) is tested on the card in tests/test_torch_cuda.py.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

from dau_convnet_tpu.data import epoch_batches as jax_epoch_batches
from dau_convnet_tpu_torch.data import epoch_batches, prefetch_to_device
from dau_convnet_tpu_torch.examples import train_cifar10 as tc


def _jax_example():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from examples import train_cifar10
    return train_cifar10


@pytest.mark.parametrize("n,batch,drop,seed", [(100, 32, True, 0), (100, 32, False, 1),
                                               (64, 64, True, 2), (7, 3, False, 3)])
def test_epoch_batches_equal_jax_bit_for_bit(n, batch, drop, seed):
    x = np.random.default_rng(9).standard_normal((n, 3, 2, 2)).astype(np.float32)
    y = np.arange(n, dtype=np.int32)
    got = list(epoch_batches(x, y, batch, rng=np.random.default_rng(seed),
                             drop_remainder=drop))
    ref = list(jax_epoch_batches(x, y, batch, rng=np.random.default_rng(seed),
                                 drop_remainder=drop))
    assert len(got) == len(ref) > 0
    for (gx, gy), (rx, ry) in zip(got, ref):
        assert gx.dtype == rx.dtype and gy.dtype == ry.dtype
        np.testing.assert_array_equal(gx, rx)
        np.testing.assert_array_equal(gy, ry)


def test_prefetch_to_device_cpu_order_values_and_views():
    batches = [(np.full((2, 2), i, np.float32), np.array([i])) for i in range(5)]
    out = list(prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert len(out) == 5
    for i, (bx, by) in enumerate(out):
        assert isinstance(bx, torch.Tensor) and bx.device.type == "cpu"
        assert float(bx[0, 0]) == i and int(by[0]) == i
        # a view of the host array, not a copy
        assert np.shares_memory(bx.numpy(), batches[i][0])


def test_prefetch_to_device_cpu_keeps_the_batch_structure():
    batch = {"x": np.ones((2, 3), np.float32), "ys": [np.arange(2), np.zeros(1)]}
    (out,) = list(prefetch_to_device(iter([batch]), device="cpu"))
    assert set(out) == {"x", "ys"} and isinstance(out["ys"], list)
    assert tuple(out["x"].shape) == (2, 3) and out["ys"][0].tolist() == [0, 1]


def test_prefetch_propagates_errors():
    def gen():
        yield (np.zeros(1),)
        raise RuntimeError("boom")

    it = prefetch_to_device(gen(), device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        list(it)


def _cifar_npz(path, rng, n, with_test):
    arrays = dict(x_train=rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8),
                  y_train=rng.integers(0, 10, (n,), dtype=np.int64))
    if with_test:
        arrays.update(x_test=rng.integers(0, 256, (16, 32, 32, 3), dtype=np.uint8),
                      y_test=rng.integers(0, 10, (16,), dtype=np.int64))
    np.savez(path, **arrays)


@pytest.mark.parametrize("with_test", [True, False])
def test_load_data_reads_a_cifar_npz_as_jax_does(tmp_path, with_test):
    """The --data-npz path on a tiny CIFAR-10 npz: NCHW f32 in [-0.5, 0.5]
    and int32 labels; without x_test a shuffled 90/10 carve. Equal to the
    JAX example's `load_data` bit for bit."""
    path = str(tmp_path / "cifar.npz")
    _cifar_npz(path, np.random.default_rng(0), 64 if with_test else 50, with_test)
    args = types.SimpleNamespace(data_npz=path, dataset="synthetic")
    got = tc.load_data(args)
    ref = _jax_example().load_data(args)
    assert got[0].shape == (64, 3, 32, 32) if with_test else len(got[0]) == 45
    assert len(got[2]) == (16 if with_test else 5)
    assert float(np.abs(got[0]).max()) <= 0.5 + 1e-6
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def test_synthetic_cifar_is_the_examples_bit_for_bit():
    for got, ref in zip(tc.synthetic_cifar(n=64, seed=4), _jax_example().synthetic_cifar(
            n=64, seed=4)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
