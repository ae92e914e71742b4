"""The port's Torch7 `.t7` reader, writer, importer and exporter
(dcgan_sr_tpu_torch/compat/) against the JAX package's (dcgan_sr_tpu/compat/),
on the CPU: the writers' bytes for the same trees, both readers on the
hand-authored layouts of tests/test_t7_external_golden.py, the generator
exporters' bytes, and a JAX-exported gray-3 generator imported by the port
running the JAX forward (rtol/atol 1e-5 in fp32: the port's convolutions
sum in oneDNN's order, XLA:CPU's in its own)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from dcgan_sr_tpu.compat import t7 as jt7
from dcgan_sr_tpu.compat.torch_export import (
    export_torch_generator as j_export_torch_generator)
from dcgan_sr_tpu.core import get_config as j_get_config
from dcgan_sr_tpu.models import (apply_network as j_apply_network,
                                 generator_spec as j_generator_spec,
                                 init_network as j_init_network)
from dcgan_sr_tpu_torch.compat import t7
from dcgan_sr_tpu_torch.compat.torch_export import export_torch_generator
from dcgan_sr_tpu_torch.compat.torch_import import (import_torch_generator,
                                                    import_torch_sequential)
from dcgan_sr_tpu_torch.core import get_config
from dcgan_sr_tpu_torch.models import Network, generator_spec, init_network
from dcgan_sr_tpu_torch.train.checkpoint import load_generator

from test_t7_external_golden import _i, _l, _s, build_fixture_bytes

import torch_threads  # noqa: F401


def _trees():
    """Trees of every kind the writer takes: scalars, strings, nested and
    shared tables, a tensor of each storage type, T7Objects, and one tensor
    referenced twice."""
    rng = np.random.RandomState(0)
    shared_t = rng.rand(4, 3).astype(np.float32)
    shared = {"w": np.ones(3, np.float32)}
    tensors = [rng.rand(3, 4, 5).astype(np.float32),
               rng.rand(2, 3).astype(np.float64),
               np.arange(10, dtype=np.int64),
               np.arange(-3, 3, dtype=np.int32).reshape(2, 3),
               np.arange(6, dtype=np.uint8).reshape(2, 3)]
    return {
        "scalars": [None, True, False, 3, 2.5, -7, "hello", ""],
        "nested_shared": {"a": shared, "b": shared, "name": "net",
                          1: {2: {3: "deep"}}},
        "tensors": tensors,
        "torch_object": ("nn.SpatialConvolution",
                         {"weight": rng.rand(4, 2, 3, 3).astype(np.float32),
                          "nInputPlane": 2, "nOutputPlane": 4}),
        "shared_tensor": {"m1": {"weight": shared_t},
                          "m2": {"weight": shared_t}},
    }


def _obj(kind, tree, mod):
    """`tree` as an object of `mod` (T7Object of that package)."""
    if kind == "torch_object":
        return mod.T7Object(*tree)
    if kind == "scalars":
        return {i + 1: v for i, v in enumerate(tree) if v is not None}
    if kind == "tensors":
        return {i + 1: a for i, a in enumerate(tree)}
    return tree


@pytest.mark.parametrize("kind", list(_trees()))
def test_writer_bytes_equal_the_jax_packages(kind, tmp_path):
    tree = _trees()[kind]
    mine, theirs = tmp_path / "port.t7", tmp_path / "jax.t7"
    t7.save_t7(str(mine), _obj(kind, tree, t7))
    jt7.save_t7(str(theirs), _obj(kind, tree, jt7))
    assert mine.read_bytes() == theirs.read_bytes()
    back = t7.load_t7(str(mine))
    if kind == "shared_tensor":
        # one heap object, read back as one array
        assert back["m1"]["weight"] is back["m2"]["weight"]
        np.testing.assert_array_equal(back["m1"]["weight"],
                                      tree["m1"]["weight"])
    elif kind == "nested_shared":
        assert back["a"] is back["b"]
        assert back[1][2][3] == "deep"
    elif kind == "tensors":
        for i, a in enumerate(tree):
            assert back[i + 1].dtype == a.dtype
            np.testing.assert_array_equal(back[i + 1], a)
    elif kind == "torch_object":
        assert isinstance(back, t7.T7Object)
        assert back.torch_type == "nn.SpatialConvolution"
        np.testing.assert_array_equal(back["weight"], tree[1]["weight"])


def _strided():
    base = np.arange(6, dtype=np.float32)
    raw = _i(4) + _i(1) + _s("V 1") + _s("torch.FloatTensor")
    raw += _i(2) + _l(3) + _l(2) + _l(1) + _l(3) + _l(1)
    raw += _i(4) + _i(2) + _s("V 1") + _s("torch.FloatStorage")
    return raw + _l(6) + base.tobytes(), base.reshape(2, 3).T


def _offset():
    base = np.arange(10, dtype=np.float32)
    raw = _i(4) + _i(1) + _s("V 1") + _s("torch.FloatTensor")
    raw += _i(1) + _l(4) + _l(1) + _l(3)
    raw += _i(4) + _i(2) + _s("V 1") + _s("torch.FloatStorage")
    return raw + _l(10) + base.tobytes(), base[2:6]


def _old_classname():
    x = np.array([1.5, -2.5, 3.5], np.float32)
    raw = _i(4) + _i(1) + _s("torch.FloatTensor")
    raw += _i(1) + _l(3) + _l(1) + _l(1)
    raw += _i(4) + _i(2) + _s("torch.FloatStorage")
    return raw + _l(3) + x.tobytes(), x


def _cuda_tensor():
    """torch.CudaTensor reads as Float (its storage class is Float's)."""
    x = np.array([0.25, -4.0], np.float32)
    raw = _i(4) + _i(1) + _s("V 1") + _s("torch.CudaTensor")
    raw += _i(1) + _l(2) + _l(1) + _l(1)
    raw += _i(4) + _i(2) + _s("V 1") + _s("torch.CudaStorage")
    return raw + _l(2) + x.tobytes(), x


@pytest.mark.parametrize("layout", [_strided, _offset, _old_classname,
                                    _cuda_tensor])
def test_both_readers_parse_hand_authored_tensors(layout, tmp_path):
    raw, want = layout()
    p = tmp_path / "x.t7"
    p.write_bytes(raw)
    mine, theirs = t7.load_t7(str(p)), jt7.load_t7(str(p))
    assert mine.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(mine, want)
    np.testing.assert_array_equal(mine, theirs)


def test_both_readers_parse_the_hand_authored_sequential(tmp_path):
    """nn.Sequential with a Lua-number module key, a FloatTensor, its
    back-reference and conv geometry numbers: equal values from both
    readers, and the port's importer maps it onto a one-conv spec."""
    raw, w = build_fixture_bytes()
    p = tmp_path / "golden.t7"
    p.write_bytes(raw)
    mine, theirs = t7.load_t7(str(p)), jt7.load_t7(str(p))
    for obj in (mine, theirs):
        conv = obj["modules"][1]
        assert conv.torch_type == "nn.SpatialConvolution"
        assert conv["gradWeight"] is conv["weight"]
        assert obj["train"] is True
        np.testing.assert_array_equal(conv["weight"], w)
    assert ({k: v for k, v in mine["modules"][1].attrs.items()
             if not isinstance(v, np.ndarray)}
            == {k: v for k, v in theirs["modules"][1].attrs.items()
                if not isinstance(v, np.ndarray)})
    spec = ({"kind": "conv", "cin": 1, "cout": 2, "k": 2, "s": 1, "p": 0,
             "bn": False, "act": None},)
    params, _ = init_network(spec, torch.Generator().manual_seed(0))
    out = import_torch_generator(str(p), spec, params)
    assert isinstance(out[0]["w"], np.ndarray)
    np.testing.assert_array_equal(out[0]["w"], w)


def _gray3(ngf=4):
    """(jax cfg, spec, params, state) of gray-3 at `ngf` with distinctive
    running statistics (the init's are 0 and 1)."""
    jcfg = j_get_config("gray-3", env_override=False, ngf=ngf)
    spec = j_generator_spec(jcfg)
    params, state = j_init_network(jax.random.PRNGKey(0), spec)
    rng = np.random.RandomState(7)
    state = [({"bn": {"mean": rng.randn(*np.shape(s["bn"]["mean"]))
                      .astype(np.float32),
                      "var": (1 + rng.rand(*np.shape(s["bn"]["var"])))
                      .astype(np.float32)}} if s else s) for s in state]
    params = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, spec, params, state


def test_generator_export_bytes_equal_the_jax_packages(tmp_path):
    """gray-3 at ngf 4 with running statistics: the port's exporter, fed
    the module's own tensors (Network.trees()), writes the JAX file."""
    jcfg, spec, params, state = _gray3()
    theirs = j_export_torch_generator(str(tmp_path / "jax.t7"), spec, params,
                                      state)
    net = Network(generator_spec(get_config("gray-3", env_override=False,
                                            ngf=4)),
                  params, state, device="cpu")
    mine = export_torch_generator(str(tmp_path / "port.t7"), net.spec,
                                  *net.trees())
    assert open(mine, "rb").read() == open(theirs, "rb").read()


@pytest.mark.parametrize("bn", ["pooled", "running"])
def test_jax_exported_generator_runs_the_jax_forward(bn, tmp_path):
    """A JAX-exported gray-3 `.t7`, served by the port (load_generator's t7
    route: imported over a random init, the fused pair on its plain
    version), against JAX's apply_network on the source weights."""
    jcfg, spec, params, state = _gray3()
    path = j_export_torch_generator(str(tmp_path / "net_G.t7"), spec, params,
                                    state)
    cfg = get_config("gray-3", env_override=False, ngf=4)
    net, msg = load_generator(cfg, t7=path, device="cpu")
    assert msg == f"loaded Torch checkpoint {path}"
    x = np.random.RandomState(1).rand(2, 1, 32, 32).astype(np.float32)
    want, _ = j_apply_network(spec, params, jnp.asarray(x), state,
                              train=bn == "pooled")
    with torch.no_grad():
        got = net(torch.from_numpy(x), bn).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_import_without_running_statistics_keeps_the_init_state(tmp_path):
    """BN running statistics go into `state` only where the module has
    them; parameters always."""
    jcfg, spec, params, state = _gray3()
    obj = t7.load_t7(j_export_torch_generator(str(tmp_path / "g.t7"), spec,
                                              params, state))
    for m in obj["modules"].values():
        for k in ("running_mean", "running_var"):
            m.attrs.pop(k, None)
    pspec = generator_spec(get_config("gray-3", env_override=False, ngf=4))
    p0, s0 = init_network(pspec, torch.Generator().manual_seed(3))
    p1, s1 = import_torch_sequential(obj, pspec, p0, s0)
    for i, s in enumerate(s1):
        if s:
            np.testing.assert_array_equal(s["bn"]["mean"], s0[i]["bn"]["mean"])
            np.testing.assert_array_equal(params[i]["bn_scale"],
                                          p1[i]["bn_scale"])
    assert all(isinstance(v, np.ndarray) for p in p1 for v in p.values())


@pytest.mark.parametrize("wrong", ["widths", "module"])
def test_import_rejects_a_wrong_topology(wrong, tmp_path):
    jcfg, spec, params, state = _gray3()
    path = j_export_torch_generator(str(tmp_path / "g.t7"), spec, params,
                                    state)
    cfg = get_config("gray-3", env_override=False,
                     ngf=8 if wrong == "widths" else 4)
    pspec = generator_spec(cfg)
    if wrong == "module":         # a conv where the spec has a convT
        pspec = tuple(dict(l, kind="conv") if l["kind"] == "convT" else l
                      for l in pspec)
    p0, s0 = init_network(pspec, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="layer"):
        import_torch_generator(path, pspec, p0, s0)
    with pytest.raises(ValueError, match="nn.Sequential"):
        import_torch_sequential(t7.T7Object("nn.Concat", {}), pspec, p0)
