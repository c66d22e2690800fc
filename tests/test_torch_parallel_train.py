"""Port vs JAX: the sharded train step under `torch.distributed`.

The port's steps run once per module, in 4 CPU processes of a `gloo` group
(`tests/torch_parallel_ranks.py::train_cases`) on the meshes 4x1 (data)
and 2x2 (data x model); JAX's sharded steps (`init_sharded`,
`make_train_step`) run in this process on the same meshes of its 8 virtual
CPU devices, as `tests/test_distributed.py` runs them; both start from
JAX's initial variables. The models: `test_distributed.py`'s TinyDAUNet on
the engines 'xla' and 'fourier', the same net with a trainable sigma (its
gradient, a sum over every unit, summed over the model axis), and
DAUCifarNet, whose BatchNorms train on the global batch's statistics (as
JAX's sharded step, which computes the single-device program, does). SGD
with momentum 0.9 (torch's SGD without dampening is optax's
`sgd(momentum=)` trace): two steps of TinyDAUNet, one of DAUCifarNet.

Tolerances, in f32, against JAX's sharded step and against the port's own
one-process step: TinyDAUNet's losses, gathered parameters and momentum
buffers to rtol 5e-5 / atol 5e-6 (JAX's bound for its sharded fused
backward); DAUCifarNet's to tests/test_torch_models.py's bounds for its
step: the loss to rtol 1e-5, the momentum (the first step's gradient) to
rtol 1e-3 with a floor of 1e-4*max|grad| of that tensor, the parameters to
rtol 1e-6 with a floor of 1e-3*LR*max|grad| and the BatchNorm statistics
to rtol 1e-5 with a floor of 1e-6. Through three BatchNorms, ReLUs and
2x2 max-pools, last-bit differences of the forward move single gradient
elements by whole steps (a near-tie broken the other way); a second step
from the moved parameters shows them in the parameters (up to 3e-2 of
max|momentum| against JAX, 7e-6 against the port's one-process step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from dau_convnet_tpu.models import DAUCifarNet as JaxDAUCifarNet
from dau_convnet_tpu.nn import DAUConv2d as JaxDAUConv2d
from dau_convnet_tpu.parallel import init_sharded as jax_init_sharded
from dau_convnet_tpu.parallel import make_mesh as jax_make_mesh
from dau_convnet_tpu.parallel import make_train_step as jax_make_train_step
from dau_convnet_tpu_torch.parallel import make_train_step
from dau_convnet_tpu_torch.parallel._spawn import run_ranks
from dau_convnet_tpu_torch.utils import params_from_flax

import torch_parallel_ranks as ranks

MOMENTUM = 0.9
RTOL, ATOL = 5e-5, 5e-6


class JaxTinyDAUNet(nn.Module):
    """`test_distributed.py`'s TinyDAUNet, with sigma trainable or not."""
    engine: str = "xla"
    sigma_trainable: bool = False

    @nn.compact
    def __call__(self, x):
        x = JaxDAUConv2d(filters=8, dau_units=(2, 1), max_kernel_size=9, use_bias=False,
                         engine=self.engine, dau_sigma_trainable=self.sigma_trainable)(x)
        x = nn.relu(x).mean(axis=(2, 3))
        return nn.Dense(4)(x)


# case -> (kind, engine, mesh, lr, steps)
CASES = {
    f"{kind} {engine} {m[0]}x{m[1]}": (kind, engine, m, lr, steps)
    for kind, engine, lr, steps in (("tiny", "xla", 0.1, 2), ("tiny", "fourier", 0.1, 2),
                                    ("tiny_sigma", "xla", 0.1, 2), ("cifar", "auto", 1e-3, 1))
    for m in ranks.MESHES
}


def _jax_model(kind, engine):
    if kind == "cifar":
        return JaxDAUCifarNet(train=True)
    return JaxTinyDAUNet(engine=engine, sigma_trainable=kind == "tiny_sigma")


def _data(kind):
    rng = np.random.default_rng(0)
    side, classes = (32, 10) if kind == "cifar" else (8, 4)
    return (rng.random((8, 3, side, side)).astype(np.float32),
            rng.integers(0, classes, 8))


def _torch_state(params, extra):
    variables = {"params": params, **extra}
    return {k: v.numpy() for k, v in params_from_flax(jax.device_get(variables)).items()}


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's sharded steps: {case: dict(state (the initial variables as the
    port's state dict), losses, params, momentum, extra)}."""
    out = {}
    for key, (kind, engine, mesh_shape, lr, steps) in CASES.items():
        x, y = _data(kind)
        model = _jax_model(kind, engine)
        tx = optax.sgd(lr, momentum=MOMENTUM)
        mesh = jax_make_mesh(jax.devices()[:ranks.WORLD], model=mesh_shape[1])
        state, sh = jax_init_sharded(model, tx, mesh, jnp.asarray(x),
                                     rng=jax.random.PRNGKey(0))
        initial = _torch_state(state.params, state.extra_vars)
        step = jax_make_train_step(model, tx, mesh, sh, donate=False)
        losses = []
        for _ in range(steps):
            state, loss = step(state, jnp.asarray(x), jnp.asarray(y))
            losses.append(float(loss))
        trace = state.opt_state[0].trace
        out[key] = dict(state=initial, x=x, y=y, losses=losses,
                        params=_torch_state(state.params, {}),
                        momentum=_torch_state(trace, {}),
                        extra=_torch_state({}, state.extra_vars) if state.extra_vars else {})
    return out


@pytest.fixture(scope="module")
def port(jax_runs):
    cases = {key: dict(kind=kind, engine=engine, mesh=mesh, lr=lr, momentum=MOMENTUM,
                       steps=steps, state=jax_runs[key]["state"], x=jax_runs[key]["x"],
                       y=jax_runs[key]["y"])
             for key, (kind, engine, mesh, lr, steps) in CASES.items()}
    return run_ranks(ranks.train_cases, ranks.WORLD, cases, threads=2, timeout=900)


@pytest.fixture(scope="module")
def single(jax_runs):
    """The port's one-process step from the same state: {case: losses,
    params, momentum, extra}. The meshes of a model share it."""
    out = {}
    for key, (kind, engine, _, lr, steps) in CASES.items():
        run = jax_runs[key]
        model = ranks.build(kind, engine)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in run["state"].items()})
        opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=MOMENTUM)
        step = make_train_step(model, opt)
        x, y = torch.from_numpy(run["x"]), torch.from_numpy(run["y"])
        losses = [float(step(x, y)) for _ in range(steps)]
        params = dict(model.named_parameters())
        out[key] = dict(
            losses=losses, params={k: p.detach().numpy() for k, p in params.items()},
            momentum={k: opt.state[p]["momentum_buffer"].numpy() for k, p in params.items()
                      if p in opt.state},
            extra={k: v.numpy() for k, v in model.state_dict().items() if k not in params})
    return out


def _close(key, what, got, want, ref):
    """got against want (the tensors `what` of a run) within the case's
    bounds (module docstring); `ref` is the reference run, whose momentum
    scales DAUCifarNet's floors."""
    assert set(got) == set(want), what
    cifar, lr = CASES[key][0] == "cifar", CASES[key][3]
    for k in want:
        rtol, atol = RTOL, ATOL
        if cifar:
            g = float(np.abs(ref["momentum"].get(k, 0.0)).max())
            rtol, atol = {"momentum": (1e-3, 1e-4 * g), "params": (1e-6, 1e-3 * lr * g),
                          "extra": (1e-5, 1e-6)}[what]
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=f"{what} {k}")


def _losses(key, got, want):
    rtol, atol = (1e-5, 0.0) if CASES[key][0] == "cifar" else (RTOL, ATOL)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _momentum(got, ref):
    """A fixed sigma takes no gradient: torch's SGD keeps no momentum for
    it, optax's trace keeps zeros."""
    assert all(not np.any(v) for k, v in ref.items() if k not in got)
    return got, {k: v for k, v in ref.items() if k in got}


CHECKS = [(key, what) for key in CASES for what in ("losses", "params", "momentum", "extra")
          if what != "extra" or CASES[key][0] == "cifar"]


@pytest.mark.parametrize("key,what", CHECKS, ids=[f"{k}-{w}" for k, w in CHECKS])
def test_sharded_step_matches_jax(port, jax_runs, key, what):
    got, want = port[0][key][what], jax_runs[key][what]
    if what == "losses":
        _losses(key, got, want)
        return
    if what == "momentum":
        got, want = _momentum(got, want)
    _close(key, what, got, want, jax_runs[key])


@pytest.mark.parametrize("key", list(CASES))
def test_sharded_step_matches_the_port_on_one_process(port, single, key):
    case, ref = port[0][key], single[key]
    _losses(key, case["losses"], ref["losses"])
    for what in ("params", "momentum", "extra"):
        _close(key, what, case[what], ref[what], ref)


@pytest.mark.parametrize("key", list(CASES))
def test_every_rank_holds_the_global_loss_and_its_slices(port, jax_runs, key):
    """The loss comes back replicated; each parameter (and its momentum
    slot, keyed by the parameter) is this rank's slice: F halved on the 2x2
    mesh where the spec splits it, whole on 4x1."""
    full = jax_runs[key]["state"]
    specs = port[0][key]["specs"]
    for rank in range(ranks.WORLD):
        case = port[rank][key]
        assert case["losses"] == port[0][key]["losses"] and case["step"] == CASES[key][4]
        for k, shape in case["local"].items():
            want = list(full[k].shape)
            for dim, axis in enumerate(specs[k]):
                if axis == "model":
                    want[dim] //= 2
            assert list(shape) == want, k
            if k in case["slots"]:
                assert case["slots"][k] == shape, k
    if CASES[key][2] == (2, 2):
        assert any(any(v) for v in specs.values())


def test_sharded_step_refuses_an_unsharded_model_and_modules_that_cannot_shard(port):
    errors = port[0]["guards"]
    assert len(errors) == 2
    assert "run init_sharded first" in errors[0]
    assert "0.weight: its module Linear cannot run sharded" in errors[1]
