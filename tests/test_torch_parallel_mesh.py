"""Port vs JAX: the mesh helpers, the F-sharded DAU op and the spatial
sharding of its forward, under `torch.distributed`.

The port's sharded cases run once per module, in 4 CPU processes of a
`gloo` group (`tests/torch_parallel_ranks.py::mesh_cases`) on the meshes
4x1 (data) and 2x2 (data x model); JAX's run in this process on the same
meshes of its 8 virtual CPU devices (`tests/conftest.py`), as
`tests/test_distributed.py` runs them. A rank (i, j) of the port's mesh
is JAX's device mesh.devices[i, j].

Tolerances: the slices, specs and gathers exactly; the F-sharded op's
output and gradients JAX's own bounds for its shard_map route
(`test_distributed.py`): y rtol 2e-5 / atol 2e-6, the gradients rtol 5e-5
/ atol 5e-6, against JAX's route and against the port's one-process op;
the spatial forward rtol 2e-5 / atol 2e-6, JAX's bound for its spatial
sharding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as JaxP

from dau_convnet_tpu.data.loader import epoch_batches as jax_epoch_batches
from dau_convnet_tpu.data.loader import prefetch_to_device as jax_prefetch
from dau_convnet_tpu.models import AlexNetDAU as JaxAlexNetDAU
from dau_convnet_tpu.models import DAUCifarNet as JaxDAUCifarNet
from dau_convnet_tpu.models import DAUResNet as JaxDAUResNet
from dau_convnet_tpu.ops import DAUConvSettings as JaxSettings
from dau_convnet_tpu.ops import dau_conv2d_op as jax_op
from dau_convnet_tpu.parallel import batch_sharding as jax_batch_sharding
from dau_convnet_tpu.parallel import dau_param_spec as jax_param_spec
from dau_convnet_tpu.parallel import make_mesh as jax_make_mesh
from dau_convnet_tpu.parallel import param_shardings as jax_param_shardings
from dau_convnet_tpu.parallel import spatial_sharding as jax_spatial_sharding
from dau_convnet_tpu_torch.ops import DAUConvSettings, dau_conv2d_op
from dau_convnet_tpu_torch.parallel import dau_param_spec, make_mesh
from dau_convnet_tpu_torch.parallel._spawn import run_ranks

import torch_parallel_ranks as ranks

OP_CONFIGS = [(g, dx) for g in ("phi", "factored") for dx in ("off", "on")]


def _jax_mesh(shape):
    return jax_make_mesh(jax.devices()[:ranks.WORLD], model=shape[1])


def _op_arrays():
    """test_distributed.py::test_tp_sharded_fused_backward_partitions_f's
    inputs: F = 16, so a model shard's 8 has a kernel plan."""
    rng = np.random.default_rng(2)
    n, s, g, f, h, w = 8, 8, 2, 16, 12, 10
    return dict(x=rng.random((n, s, h, w)).astype(np.float32),
                err=rng.standard_normal((n, f, h, w)).astype(np.float32),
                w=(rng.standard_normal((1, s, g, f)) * 0.1).astype(np.float32),
                mu1=rng.uniform(-3, 3, (1, s, g, f)).astype(np.float32),
                mu2=rng.uniform(-3, 3, (1, s, g, f)).astype(np.float32),
                sig=np.full((1, s, g, f), 0.5, np.float32))


def _spatial_arrays():
    """test_distributed.py::test_spatial_sharding_matches_single_device's."""
    rng = np.random.default_rng(0)
    s, g, f = 3, 2, 4
    return dict(x=rng.random((2, s, 64, 16)).astype(np.float32),
                w=(rng.standard_normal((1, s, g, f)) * 0.1).astype(np.float32),
                mu1=rng.uniform(-3, 3, (1, s, g, f)).astype(np.float32),
                mu2=rng.uniform(-3, 3, (1, s, g, f)).astype(np.float32),
                sig=np.full((1, s, g, f), 0.5, np.float32))


@pytest.fixture(scope="module")
def spec():
    rng = np.random.default_rng(0)
    return dict(x=rng.random((8, 3, 16, 12)).astype(np.float32),
                y=rng.integers(0, 10, 8),
                m=rng.random((8, 6)).astype(np.float32),
                op=_op_arrays(), op_configs=OP_CONFIGS, spatial=_spatial_arrays())


@pytest.fixture(scope="module")
def port(spec):
    return run_ranks(ranks.mesh_cases, ranks.WORLD, spec, threads=2, timeout=900)


# ---- make_mesh and dau_param_spec (no process group needed)

@pytest.mark.parametrize("n,kw", [(8, dict(model=3)), (8, dict(data=3, model=2)),
                                  (6, dict(data=4)), (4, dict(data=1, model=3))])
def test_make_mesh_errors_match_jax(n, kw):
    with pytest.raises(ValueError) as want:
        jax_make_mesh(jax.devices()[:n], **kw)
    with pytest.raises(ValueError) as got:
        make_mesh(range(n), device_type="cpu", **kw)
    assert str(got.value) == str(want.value)


def _full(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


# (JAX name, JAX shape, the port's name, the permutation from JAX's layout to
# the port's, as utils/checkpoint.py::params_from_flax moves it)
SPEC_CASES = [
    ("weights", (1, 3, 2, 8), "weights", (0, 1, 2, 3)),
    ("mu1", (1, 3, 2, 8), "mu1", (0, 1, 2, 3)),
    ("mu2", (1, 3, 2, 8), "mu2", (0, 1, 2, 3)),
    ("weights", (3, 2, 8), "weights", (0, 1, 2)),
    ("kernel", (16, 4), "weight", (1, 0)),
    ("kernel", (3, 3, 2, 8), "weight", (3, 2, 0, 1)),
    ("bias", (8,), "bias", (0,)),
    ("sigma", (1,), "sigma", (0,)),
    ("scale", (8,), "weight", (0,)),
    ("mean", (8,), "running_mean", (0,)),
]


@pytest.mark.parametrize("jax_name,shape,name,perm", SPEC_CASES,
                         ids=[f"{c[0]}{len(c[1])}d" for c in SPEC_CASES])
def test_dau_param_spec_matches_jax_in_torch_layout(jax_name, shape, name, perm):
    want = _full(jax_param_spec(("layer", jax_name), np.zeros(shape)), len(shape))
    value = torch.zeros([shape[i] for i in perm])
    got = _full(dau_param_spec(("layer", name), value), len(shape))
    assert got == tuple(want[i] for i in perm)


def _jax_specs(model, x, shape):
    """{port key: JAX's spec in the port's layout} for a flax model."""
    variables = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)
    shardings = jax_param_shardings(variables, _jax_mesh(shape))
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        keys = [str(getattr(p, "key", p)) for p in path]
        leaf = variables
        for k in keys:
            leaf = leaf[k]
        spec = _full(sh.spec, len(leaf.shape))
        *mods, name = keys[1:]
        if name == "kernel":
            name, spec = "weight", (tuple(spec[i] for i in (3, 2, 0, 1)) if len(spec) == 4
                                    else spec[::-1])
        name = {"scale": "weight", "mean": "running_mean", "var": "running_var"}.get(name, name)
        out[".".join(mods + [name])] = spec
    return out


MODEL_SPECS = {
    "alexnet": (lambda: JaxAlexNetDAU(num_classes=999, train=False), (1, 3, 67, 67), (2, 2)),
    "cifar": (lambda: JaxDAUCifarNet(train=True), (1, 3, 32, 32), (2, 2)),
    "resnet": (lambda: JaxDAUResNet(train=True), (1, 3, 64, 64), (2, 2)),
    "cifar dp": (lambda: JaxDAUCifarNet(train=True), (1, 3, 32, 32), (4, 1)),
}


@pytest.mark.parametrize("name", list(MODEL_SPECS))
def test_param_shardings_match_jax_name_for_name(port, name):
    make, shape, mesh = MODEL_SPECS[name]
    want = _jax_specs(make(), jnp.zeros(shape, jnp.float32), mesh)
    got = port[0][f"specs {name}"]
    assert {k: _full(v, len(want[k])) for k, v in got.items()} == want
    if mesh[1] == 1:
        assert not any(any(v) for v in got.values())
    else:
        assert any(any(v) for v in got.values())
        if name == "alexnet":  # 999 classes do not divide over model=2
            assert got["fc8.weight"] == () and got["fc7.weight"] == ("model", None)


# ---- NamedSharding: slices, gathers and the input pipeline

def _jax_shards(arr, shape):
    """{port rank: JAX's shard of `arr` on the device at that mesh place}."""
    devices = list(_jax_mesh(shape).devices.flat)
    return {devices.index(s.device): np.asarray(s.data) for s in arr.addressable_shards}


@pytest.mark.parametrize("shape", ranks.MESHES, ids=["4x1", "2x2"])
@pytest.mark.parametrize("kind", ["batch", "spatial"])
def test_shard_is_jax_device_slice(port, spec, kind, shape):
    sharding = (jax_batch_sharding if kind == "batch" else jax_spatial_sharding)(
        _jax_mesh(shape))
    want = _jax_shards(jax.device_put(spec["x"], sharding), shape)
    for rank in range(ranks.WORLD):
        np.testing.assert_array_equal(port[rank][f"shard {kind} {shape}"], want[rank])


@pytest.mark.parametrize("shape", ranks.MESHES, ids=["4x1", "2x2"])
def test_gather_puts_the_slices_together(port, spec, shape):
    for rank in range(ranks.WORLD):
        np.testing.assert_array_equal(port[rank][f"roundtrip {shape}"], spec["m"])


@pytest.mark.parametrize("shape", ranks.MESHES, ids=["4x1", "2x2"])
@pytest.mark.parametrize("kind", ["batch", "spatial"])
def test_prefetch_yields_jax_device_slices(port, spec, kind, shape):
    mesh = _jax_mesh(shape)
    sharding = (jax_batch_sharding(mesh) if kind == "batch" else
                (jax_spatial_sharding(mesh), JaxNamedSharding(mesh, JaxP())))
    want = list(jax_prefetch(jax_epoch_batches(spec["x"], spec["y"], 4,
                                               rng=np.random.default_rng(0)),
                             sharding=sharding))
    for rank in range(ranks.WORLD):
        got = port[rank][f"prefetch {kind} {shape}"]
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, _jax_shards(b, shape)[rank])


def test_copy_to_model_sums_the_gradient_over_the_model_axis(port):
    # ranks (0, 1) and (2, 3) are the model groups; each scaled by rank + 1
    for rank in range(ranks.WORLD):
        want = 3.0 if rank < 2 else 7.0
        np.testing.assert_array_equal(port[rank]["collectives"]["copy_grad"], np.full(3, want))


def test_gather_from_model_concatenates_and_slices_the_gradient(port):
    for rank in range(ranks.WORLD):
        c = port[rank]["collectives"]
        np.testing.assert_array_equal(c["gathered"], [0.0, 1.0, 10.0, 11.0])
        i = rank % 2
        np.testing.assert_array_equal(c["gather_grad"], [2.0 * i, 2.0 * i + 1])


# ---- the F-sharded op (fused_bwd='on') against JAX's shard_map route

@pytest.fixture(scope="module")
def jax_op_runs():
    """JAX's op on the 2x2 mesh: x over data, the params and sigma over
    model, the error over both, under its mesh context (the shard_map
    route of `_fused_grads_call`)."""
    a = _op_arrays()
    mesh = _jax_mesh((2, 2))
    bsh = JaxNamedSharding(mesh, JaxP("data"))
    fsh = JaxNamedSharding(mesh, JaxP(None, None, None, "model"))
    esh = JaxNamedSharding(mesh, JaxP("data", "model"))
    out = {}
    for gather, fused_dx in OP_CONFIGS:
        cfg = JaxSettings(kernel_size=9, engine="fourier", fused_bwd="on", fused_dx=fused_dx,
                          fused_gather=gather)

        def fwd_bwd(x, w, mu1, mu2, sig, err, cfg=cfg):
            y, vjp = jax.vjp(lambda *p: jax_op(cfg, *p), x, w, mu1, mu2, sig)
            return y, vjp(err)

        with jax.sharding.set_mesh(mesh):
            y, g = jax.jit(fwd_bwd, in_shardings=(bsh,) + (fsh,) * 4 + (esh,))(
                *(jax.device_put(a[k], s) for k, s in (("x", bsh), ("w", fsh), ("mu1", fsh),
                                                       ("mu2", fsh), ("sig", fsh),
                                                       ("err", esh))))
        out[(gather, fused_dx)] = (np.asarray(y), [np.asarray(t) for t in g])
    return out


def _port_op_single(gather, fused_dx):
    a = _op_arrays()
    cfg = DAUConvSettings(kernel_size=9, engine="fourier", fused_bwd="on", fused_dx=fused_dx,
                          fused_gather=gather)
    ins = [torch.from_numpy(a[k]).requires_grad_() for k in ("x", "w", "mu1", "mu2", "sig")]
    y = dau_conv2d_op(cfg, *ins)
    y.backward(torch.from_numpy(a["err"]))
    return y.detach().numpy(), [t.grad.numpy() for t in ins]


def _check_op(got, y, grads):
    np.testing.assert_allclose(got["y"], y, rtol=2e-5, atol=2e-6)
    for a, b, name in zip([got["dx"], *got["grads"]], grads,
                          ["dx", "dw", "dmu1", "dmu2", "dsig"]):
        np.testing.assert_allclose(a, b, rtol=5e-5, atol=5e-6, err_msg=name)


@pytest.mark.parametrize("gather,fused_dx", OP_CONFIGS)
def test_f_sharded_op_matches_jax_shard_map_route(port, jax_op_runs, gather, fused_dx):
    _check_op(port[0]["op"][(gather, fused_dx)], *jax_op_runs[(gather, fused_dx)])


@pytest.mark.parametrize("gather,fused_dx", OP_CONFIGS)
def test_f_sharded_op_matches_the_port_on_one_process(port, gather, fused_dx):
    _check_op(port[0]["op"][(gather, fused_dx)], *_port_op_single(gather, fused_dx))


@pytest.mark.parametrize("gather,fused_dx", OP_CONFIGS)
def test_f_sharded_op_runs_the_fused_kernel_per_shard(port, gather, fused_dx):
    """Each rank logs its axes, and its backward's `dau.unit_grads` span
    records the route taken on its own shard: N = 4 rows, F = 8 units, the
    fused kernel of the gather asked for, emitting dx where fused_dx='on'."""
    for rank in range(ranks.WORLD):
        case = port[rank]["op"][(gather, fused_dx)]
        logs = "\n".join(case["logs"])
        assert "sharded axes: data=data model=model" in logs, logs
        (attrs,) = case["unit_grads"]
        assert (attrs["N"], attrs["S"], attrs["F"]) == (4, 8, 8), attrs
        assert attrs["route"] == gather and attrs["dx_fused"] == (fused_dx == "on"), attrs


# ---- spatial sharding of the op's forward

@pytest.fixture(scope="module")
def jax_spatial():
    a = _spatial_arrays()
    mesh = _jax_mesh((4, 1))
    sh = jax_spatial_sharding(mesh)
    out = {}
    for engine in ("xla", "fourier"):
        cfg = JaxSettings(kernel_size=9, engine=engine)
        out[engine] = np.asarray(jax.jit(
            lambda *p, cfg=cfg: jax_op(cfg, *p), in_shardings=(sh, None, None, None, None),
            out_shardings=sh)(jax.device_put(a["x"], sh), a["w"], a["mu1"], a["mu2"], a["sig"]))
    return out


@pytest.mark.parametrize("engine", ["xla", "fourier"])
def test_spatial_sharding_matches_jax(port, jax_spatial, engine):
    for rank in range(ranks.WORLD):
        np.testing.assert_allclose(port[rank]["spatial"][engine], jax_spatial[engine],
                                   rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("engine", ["xla", "fourier"])
def test_spatial_sharding_matches_the_port_on_one_process(port, engine):
    a = _spatial_arrays()
    cfg = DAUConvSettings(kernel_size=9, engine=engine)
    with torch.no_grad():
        want = dau_conv2d_op(cfg, *(torch.from_numpy(a[k])
                                    for k in ("x", "w", "mu1", "mu2", "sig"))).numpy()
    np.testing.assert_allclose(port[0]["spatial"][engine], want, rtol=2e-5, atol=2e-6)
