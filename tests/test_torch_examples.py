"""Port vs JAX: the example scripts (`dau_convnet_tpu_torch/examples/`).

Weights come from the JAX models' init and go to the port through
`params_from_flax`; inputs and labels come from numpy seeds; the JAX
examples are imported from `examples/` as tests/test_data.py does.
Tolerances:
- the train_cifar10 step (3 SGD-momentum steps, f32 'xla', then the DAU
  parameters projected): the loss, every parameter and the BatchNorm
  running statistics within 1e-4 of the JAX step's max|.| of that tensor
  (the mu gradients are scaled by the mu learning-rate factor 500, so
  f32 rounding of the gradients moves mu by ~1e-6 of its range per step);
- the Adam chain (global-norm clip 1.0, Adam, projection; 3 steps): every
  parameter within 1e-4 of max|.| of that tensor plus 1e-6 of the learning
  rate: torch's clip divides by norm + 1e-6 where optax's divides by the
  norm (a relative 1e-6 of the clipped gradient), and Adam's update is
  lr * m/(sqrt(v) + eps), bounded by lr whatever the gradient's scale;
- the torch.export round trip: atol 1e-6, rtol 1e-5 against the eager
  forward (tests/test_export.py's tolerance), and the eager forward within
  rtol 1e-4 and 1e-4 of max|y| of the JAX net's (tests/test_torch_models.py's);
- analyze_spatial on the spatial artifact: the port's predictions equal
  JAX's except where JAX's two largest logits lie within 1e-3 of max|logits|
  of each other (a near-tie the order of the f32 sums may break either way).
"""

import contextlib
import io
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from dau_convnet_tpu.models import DAUCifarNet as JaxDAUCifarNet
from dau_convnet_tpu.nn import DAUConv2d as JaxDAUConv2d
from dau_convnet_tpu.nn import project_dau_params as jax_project
from dau_convnet_tpu.utils import checkpoint as jax_ckpt
from dau_convnet_tpu.utils.tiers import max_offset_in_tree as jax_max_offset
from dau_convnet_tpu.utils.tiers import retier_offset as jax_retier_offset
from dau_convnet_tpu_torch.examples import analyze_spatial as az
from dau_convnet_tpu_torch.examples import serve_inference as si
from dau_convnet_tpu_torch.examples import train_alexnet_synth as ta
from dau_convnet_tpu_torch.examples import train_cifar10 as tc
from dau_convnet_tpu_torch.nn import DAUConv2d
from dau_convnet_tpu_torch.utils import params_from_flax, params_to_flax

DOCS = os.path.join(os.path.dirname(__file__), "..", "docs")


def _jax_example(name):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    return __import__(f"examples.{name}", fromlist=[name])


def _args(**kw):
    return tc.parse_args([f"--{k.replace('_', '-')}={v}" for k, v in kw.items()])


def _close(got, ref, name, rel=1e-4, atol=0.0):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * float(np.abs(ref).max()) + atol, err_msg=name)


def _jax_flat(params):
    return params_from_flax(jax.device_get(params))


# ---- train_cifar10

@pytest.mark.parametrize("kind", ["ok", "nan", "offset", "sigma"])
def test_check_dau_health_raises_where_jax_does(kind):
    """The same bad parameters make both guards raise ValueError (and good
    ones pass both): NaN in mu, an offset past the kernel bound, sigma below
    its lower bound."""
    model = tc.build_model(_args(), 0.9, "cpu")
    with torch.no_grad():
        if kind == "nan":
            model.dau_conv2.mu1[0, 1, 0, 2] = float("nan")
        elif kind == "offset":
            model.dau_conv3.mu2[0, 0, 1, 0] = 4.2
        elif kind == "sigma":
            model.dau_conv1.sigma.fill_(0.2)
    params = params_to_flax(model.state_dict())["params"]
    jax_check = _jax_example("train_cifar10").check_dau_health
    if kind == "ok":
        tc.check_dau_health(model, 9)
        jax_check(params, 9)
        return
    with pytest.raises(ValueError) as got:
        tc.check_dau_health(model, 9)
    with pytest.raises(ValueError) as ref:
        jax_check(params, 9)
    assert str(got.value).split()[:2] == str(ref.value).split()[:2]  # the same cause


def _jax_cifar_step(net, lr):
    """The JAX example's train step (examples/train_cifar10.py:276-301)."""
    tx = optax.sgd(lr, momentum=0.9)

    @jax.jit
    def train_step(params, batch_stats, opt_state, x, y):
        def loss_fn(p):
            logits, updates = net.apply({"params": p, "batch_stats": batch_stats}, x,
                                        mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
            return loss, updates["batch_stats"]

        (loss, bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state)
        params = jax_project(optax.apply_updates(params, updates), kernel_size=9)
        return params, bs, opt_state, loss

    return tx, train_step


def test_train_cifar10_step_matches_jax_over_three_steps():
    """3 steps of `make_train_step` (SGD momentum 0.9, lr 0.01, f32 'xla',
    DAU parameters projected) against the JAX example's step from the same
    weights and batches; the model built by `build_model` with the example's
    BatchNorm momentum for a 3-step run (flax 0.9, PyTorch 0.1)."""
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((3, 4, 3, 32, 32)).astype(np.float32)
    ys = rng.integers(0, 10, (3, 4)).astype(np.int32)
    m = tc.flax_bn_momentum(3)
    net = JaxDAUCifarNet(train=True, bn_momentum=m, engine="xla")
    v = jax.device_get(jax.jit(net.init)(jax.random.PRNGKey(0), jnp.asarray(xs[0])))
    tx, jax_step = _jax_cifar_step(net, 0.01)
    params, bs, opt = v["params"], v["batch_stats"], tx.init(v["params"])

    model = tc.build_model(_args(engine="xla"), m, "cpu")
    assert {b.momentum for b in model.modules() if hasattr(b, "running_var")} == {1.0 - m}
    model.load_state_dict(params_from_flax(v))
    step = tc.make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.01,
                                                     momentum=0.9), "dau", 9)
    for i in range(3):
        params, bs, opt, loss = jax_step(params, bs, opt, jnp.asarray(xs[i]),
                                         jnp.asarray(ys[i]))
        got, acc = step(torch.from_numpy(xs[i]), torch.from_numpy(ys[i]).long())
        np.testing.assert_allclose(float(got), float(loss), rtol=1e-4, err_msg=f"loss {i}")
        assert 0.0 <= float(acc) <= 1.0
    ref = _jax_flat({"params": params, "batch_stats": bs})
    state = model.state_dict()
    assert set(ref) == set(state)
    for key, want in ref.items():
        _close(state[key].numpy(), want.numpy(), key)


@pytest.mark.parametrize("total_steps,override", [(3, None), (250, None), (600, None),
                                                  (1000, None), (10 ** 6, None),
                                                  (600, 0.99)])
def test_bn_momentum_is_the_examples(total_steps, override):
    """flax's decay as examples/train_cifar10.py:248-249 computes it, and the
    models get 1 minus it."""
    want = (override if override is not None
            else min(0.9999, max(0.9, 1.0 - 25.0 / total_steps)))
    assert tc.flax_bn_momentum(total_steps, override) == want
    model = tc.build_model(_args(), want, "cpu")
    assert model.BatchNorm_0.momentum == 1.0 - want


def test_auto_tier_decisions_equal_jax():
    """`initial_offset` and `retier` on a sequence of live offsets against the
    JAX example's decisions (:267-274 and :345-357: `max_offset_in_tree` and
    `retier_offset` on the same parameters). Every change moves both copies
    of each layer's bound; parameters and momentum stay as they are."""
    model = tc.build_model(_args(), 0.9, "cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    for p in model.parameters():
        p.grad = torch.full_like(p, 1e-3)
    opt.step()  # momentum buffers exist

    def jax_params():
        return params_to_flax(model.state_dict())["params"]

    off = tc.initial_offset(model, 9)
    assert off == float(min(math.ceil(jax_max_offset(jax_params()) + 0.5), 9 // 2))
    tc.set_static_max_offset(model, off)
    decisions = []
    for live in (1.2, 2.4, 3.3, 3.99, 2.2, 0.4, 0.4, 3.0):
        with torch.no_grad():
            for layer in (model.dau_conv1, model.dau_conv2, model.dau_conv3):
                layer.mu1.clamp_(-0.3, 0.3)
                layer.mu2.clamp_(-0.3, 0.3)
            model.dau_conv2.mu1[0, 0, 0, 0] = live
        current = model.dau_conv1.static_max_offset
        want = jax_retier_offset(jax_max_offset(jax_params()), current, 9)
        params = {k: p.detach().clone() for k, p in model.named_parameters()}
        bufs = [s["momentum_buffer"].clone() for s in opt.state.values()]
        moved = tc.retier(model, 9)
        assert (None if moved is None else moved[2]) == want, live
        if moved is not None:
            off = moved[2]
        for layer in (model.dau_conv1, model.dau_conv2, model.dau_conv3):
            assert layer.static_max_offset == layer.cfg.static_max_offset == off
        assert all(torch.equal(p, params[k]) for k, p in model.named_parameters())
        assert all(torch.equal(s["momentum_buffer"], b)
                   for s, b in zip(opt.state.values(), bufs))
        decisions.append(want)
    assert any(d is None for d in decisions) and len({d for d in decisions if d}) >= 3
    # the op reads the new bound: the forward after a change runs at its kernel size
    assert model.dau_conv1.cfg.synth_kernel_size == 2 * (math.floor(min(off, 3.99)) + 1) + 1
    with torch.no_grad():
        assert model(torch.zeros((1, 3, 32, 32))).shape == (1, 10)


def test_train_cifar10_main_on_the_cpu(tmp_path):
    """`main` end to end on a tiny CIFAR npz under --device cpu, with every
    per-step path on (eval, health check, auto-tier, params npz, checkpoint):
    flax's BatchNorm momentum printed, the JSON result with the JAX
    example's fields, and an npz in the layout of the repo's artifacts."""
    path = str(tmp_path / "cifar.npz")
    rng = np.random.default_rng(0)
    np.savez(path, x_train=rng.integers(0, 256, (32, 32, 32, 3), dtype=np.uint8),
             y_train=rng.integers(0, 10, (32,)), x_test=rng.integers(
                 0, 256, (8, 32, 32, 3), dtype=np.uint8), y_test=rng.integers(0, 10, (8,)))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = tc.main(["--device", "cpu", "--data-npz", path, "--steps", "2", "--batch",
                          "8", "--engine", "xla", "--auto-tier", "--check-every", "1",
                          "--eval-every", "1", "--save-params", str(tmp_path / "p.npz"),
                          "--ckpt-dir", str(tmp_path / "ck")])
    assert "bn_momentum=0.9000" in out.getvalue()
    assert {"arch", "dataset", "steps", "test_accuracy", "wall_s", "device", "sigma",
            "sigma_effective", "sigma_trainable"} <= set(result)
    assert result["dataset"] == "cifar10-npz" and result["device"] == "cpu"
    assert result["all_finite"] and result["auto_tier"][0] == [0, 3.0]
    saved = np.load(tmp_path / "p.npz")
    with np.load(os.path.join(DOCS, "spatial_dau_4000_params.npz")) as ref:
        assert set(saved.files) == set(ref.files)
    assert os.listdir(tmp_path / "ck") == ["2.pt"]


# ---- train_alexnet_synth

class _JaxSmall(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        x = JaxDAUConv2d(filters=8, dau_units=(2, 1), max_kernel_size=9)(x)
        return fnn.Dense(5)(x.mean(axis=(2, 3)))


class _Small(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.DAUConv2d_0 = DAUConv2d(3, 8, (2, 1), 9, device="cpu")
        self.Dense_0 = torch.nn.Linear(8, 5)

    def forward(self, x):
        return self.Dense_0(self.DAUConv2d_0(x).mean(dim=(2, 3)))


def _small_variables():
    x = np.random.default_rng(3).random((4, 3, 12, 12)).astype(np.float32)
    return jax.device_get(_JaxSmall().init(jax.random.PRNGKey(1), jnp.asarray(x)))


def _small_builder(variables, lr):
    def build():
        model = _Small()
        model.load_state_dict(params_from_flax(variables))
        return model, torch.optim.Adam(model.parameters(), lr=lr)
    return build


def test_adam_chain_matches_optax():
    """`make_step` (clip to global norm 1.0, Adam, projection) against
    optax.chain(clip_by_global_norm(1.0), adam(lr)) + project_dau_params,
    3 steps of a small DAU net from the same weights and batches; the
    gradients' global norm is above 1 (mu's carry the factor 500), so the
    clip acts."""
    lr = 1e-2
    v = _small_variables()
    data, labels = ta.make_data(3, 4, 5, torch.float32, "cpu", image_size=12)
    data = data * 20.0  # large enough gradients for the clip to act
    net = _JaxSmall()
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(lr))

    @jax.jit
    def jax_step(params, opt_state, x, y):
        def loss_fn(p):
            return optax.softmax_cross_entropy_with_integer_labels(
                net.apply(p, x), y).mean()
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        params = jax_project(optax.apply_updates(params, updates), kernel_size=9)
        return params, opt_state, loss, optax.global_norm(grads)

    params, opt = v, tx.init(v)
    model, optimizer = _small_builder(v, lr)()
    step = ta.make_step(model, optimizer, 9)
    for i in range(3):
        x, y = data[i].numpy(), labels[i].numpy()
        params, opt, loss, norm = jax_step(params, opt, jnp.asarray(x), jnp.asarray(y))
        assert float(norm) > 1.0
        got = step(data[i], labels[i])
        np.testing.assert_allclose(float(got), float(loss), rtol=1e-5, err_msg=f"loss {i}")
    ref = _jax_flat(params)
    for key, p in model.state_dict().items():
        _close(p.numpy(), ref[key].numpy(), key, atol=1e-6 * lr)


JAX_RECORD_FIELDS = {  # examples/train_alexnet_synth.py:167-182
    "variant", "dau_units", "steps", "loss_first20_mean", "loss_last20_mean",
    "loss_curve_every10", "step_ms_steady_mean", "step_ms_spread_frac", "chunk_ms_per_step",
    "resume_logits_delta", "restore_transfer_s", "final_max_abs_mu", "mu_bound", "device"}


def test_alexnet_synth_chunk_loop_and_resume(tmp_path):
    """`train`'s chunk loop on a small model: at step 4 of 8 (chunks of 2) it
    checkpoints, restores fresh objects and goes on; the probe logits are
    equal exactly and the losses equal an uninterrupted run's bit for bit
    (model and Adam state restored). The record has the JAX example's
    fields."""
    v = _small_variables()
    build = _small_builder(v, 1e-2)
    data, labels = ta.make_data(2, 4, 5, torch.float32, "cpu", image_size=12)
    logs = []
    model, run = ta.train(build, data, labels, steps=8, chunk=2,
                          ckpt_dir=str(tmp_path / "ck"), kernel_size=9, log=logs.append)
    assert run["resume_logits_delta"] == 0.0
    assert any("checkpoint+resume at step 4" in line for line in logs)
    assert len(run["losses"]) == 8 and len(run["chunk_ms"]) == 4
    plain, opt = build()
    step = ta.make_step(plain, opt, 9)
    want = [float(step(data[i % 2], labels[i % 2])) for i in range(8)]
    assert run["losses"] == want
    for key, p in model.state_dict().items():
        assert torch.equal(p, plain.state_dict()[key]), key
    record = ta.record_of(run, model, "small-test", 9, "cpu")
    assert set(record) == JAX_RECORD_FIELDS and record["mu_bound"] == 3.99


# ---- serve_inference

class _JaxTiny(fnn.Module):
    """tests/test_export.py::_Tiny with its two layers' engines given."""
    engines: tuple

    @fnn.compact
    def __call__(self, x):
        x = JaxDAUConv2d(filters=8, dau_units=(2, 1), max_kernel_size=9,
                         activation=fnn.relu, engine=self.engines[0])(x)
        x = JaxDAUConv2d(filters=8, dau_units=(1, 2), max_kernel_size=9,
                         engine=self.engines[1])(x)
        return x.mean(axis=(2, 3))


class _Tiny(torch.nn.Module):
    def __init__(self, engines):
        super().__init__()
        self.DAUConv2d_0 = DAUConv2d(4, 8, (2, 1), 9, activation=torch.relu,
                                     engine=engines[0], device="cpu")
        self.DAUConv2d_1 = DAUConv2d(8, 8, (1, 2), 9, engine=engines[1], device="cpu")

    def forward(self, x):
        return self.DAUConv2d_1(self.DAUConv2d_0(x)).mean(dim=(2, 3))


@pytest.mark.parametrize("engines", [("xla", "xla"), ("fourier", "fourier"),
                                     ("auto", "fourier")], ids="-".join)
def test_export_roundtrip(engines):
    """`export_forward` + `load_forward` (torch.export save and load) of the
    two-layer net against its eager forward, which matches JAX's on the same
    parameters; ('auto', 'fourier') is tests/test_export.py's net ('auto'
    is 'xla' at f32)."""
    x = np.random.default_rng(0).random((2, 4, 12, 12)).astype(np.float32)
    v = jax.device_get(jax.jit(_JaxTiny(engines).init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    ref = np.asarray(_JaxTiny(engines).apply(v, jnp.asarray(x)))
    model = _Tiny(engines)
    model.load_state_dict(params_from_flax(v))
    xt = torch.from_numpy(x)
    served = si.load_forward(si.export_forward(model, xt))
    with torch.no_grad():
        eager = model(xt).numpy()
        got = served(xt).numpy()
    np.testing.assert_allclose(got, eager, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(eager, ref, rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))
    # the trace left no traced constant in the engines' caches: eager runs on
    np.testing.assert_array_equal(model(xt).detach().numpy(), eager)


# ---- analyze_spatial

@pytest.fixture(scope="module")
def spatial_test_split():
    _, _, x_test, y_test = tc.synthetic_spatial(n=50000)
    return x_test, y_test


def test_analyze_spatial_predictions_match_jax(spatial_test_split):
    """`load_model` + `predictions` on docs/spatial_dau_4000_params.npz, the
    first 250 test images in padded batches of 128 ('fourier', f32), against
    the JAX net's argmax; then `summarize` on JAX's predictions against the
    JAX example's formulas (examples/analyze_spatial.py:73-84)."""
    x, y = (a[:250] for a in spatial_test_split)
    path = os.path.join(DOCS, "spatial_dau_4000_params.npz")
    trees = jax_ckpt.load_params_npz(path)
    net = JaxDAUCifarNet(train=False, engine="fourier")
    fn = jax.jit(lambda v: net.apply(trees, v))
    logits = np.concatenate([np.asarray(fn(jnp.asarray(x[i:i + 125])))
                             for i in range(0, 250, 125)])
    ref = logits.argmax(-1)
    got = az.predictions(az.load_model(path, "dau", "fourier", "cpu"), x, 128, "cpu")
    top2 = np.sort(logits, axis=-1)[:, -2:]
    tie = (top2[:, 1] - top2[:, 0]) <= 1e-3 * float(np.abs(logits).max())
    assert got.shape == ref.shape and np.all((got == ref) | tie)
    assert (got == ref).mean() >= 0.99

    s = az.summarize(ref, y)
    half = 5
    conf = np.zeros((10, 10), int)
    np.add.at(conf, (y, ref), 1)
    assert s["top1"] == (ref == y).mean()
    assert s["pair"] == ((ref % half) == (y % half)).mean()
    assert s["aliased"] == (ref == (y + half) % 10).mean()
    np.testing.assert_array_equal(s["confusion"], conf)


def test_analyze_spatial_main_on_the_conv_artifact(tmp_path, spatial_test_split):
    """`main` under --device cpu on docs/spatial_conv_2500_params.npz (the
    plain-conv net, quick on the CPU) over the 2,000 test images: the
    recorded top-1 0.4905 and pair 0.9735 (docs/TRAINING_RESULTS.md) within
    0.005 (ten near-ties), and the saved predictions."""
    out = tmp_path / "pred.npy"
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        s = az.main(["--device", "cpu", "--arch", "conv", "--params",
                     os.path.join(DOCS, "spatial_conv_2500_params.npz"),
                     "--predictions-out", str(out)])
    assert abs(s["top1"] - 0.4905) <= 0.005 and abs(s["pair"] - 0.9735) <= 0.005
    assert "top-1 accuracy" in printed.getvalue()
    pred = np.load(out)
    assert pred.shape == (2000,)
    assert az.summarize(pred, spatial_test_split[1])["top1"] == s["top1"]


@pytest.mark.parametrize("module,argv", [(tc, []), (ta, []), (si, []),
                                         (az, ["--params", "unused.npz"])],
                         ids=["train_cifar10", "train_alexnet_synth", "serve_inference",
                              "analyze_spatial"])
def test_examples_run_on_the_card_unless_asked_for_the_cpu(module, argv):
    """Without --device cpu an example wants the card: where there is none it
    stops before any work, and does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(SystemExit, match="no CUDA device"):
        module.main(argv)
