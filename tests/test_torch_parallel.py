"""The port's data-parallel building blocks (parallel/mesh.py,
parallel/collectives.py, cross-replica BN in ops/nn.py) on the CPU.

`local_batch_slice` against the JAX package's, as pure functions.  Then ONE
launch of four gloo ranks (tests/torch_dp_worker.py job "parallel",
a file store in tmp_path) runs the collectives and cross-replica BN over the
world and over a two-rank mesh of ranks 0-1; each rank writes one npz and
the cases below read them.

Cross-replica BN at (8, 3, 4, 4): each rank's slice goes through
batch_norm(axis_name=mesh) and its local weighted MSE is differentiated.
Against the port's single-process BN over the whole batch (whose loss is
the mean over all of it): y and the parameter gradients (pmean'd over the
ranks) to 1e-6; each rank's input gradient is WORLD times the
single-process one to 1e-6 (JAX transposes pmean into a sum across ranks,
so each rank differentiates the sum of the ranks' losses); the running
statistics, with n counting every rank's elements, to 1e-6."""

import os
import sys

import numpy as np
import pytest
import torch

from dcgan_sr_tpu.parallel.mesh import local_batch_slice as j_local_batch_slice
from dcgan_sr_tpu_torch.models import Network
from dcgan_sr_tpu_torch.ops import nn as N
from dcgan_sr_tpu_torch.parallel import Mesh, device_count, local_batch_slice

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_threads  # noqa: E402,F401
from torch_dp_worker import BN_SHAPE, bn_inputs, launch  # noqa: E402


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return launch("parallel", 4, tmp_path_factory.mktemp("parallel"))


# ---- local_batch_slice: the cases of tests/test_multihost_feed.py ----------

@pytest.mark.parametrize("global_batch,n", [(96, 4), (32, 2), (10, 1)])
def test_local_batch_slice_partitions_like_jax(global_batch, n):
    got = []
    for i in range(n):
        s = local_batch_slice(global_batch, process_count=n, process_index=i)
        assert s == j_local_batch_slice(global_batch, process_count=n,
                                        process_index=i)
        assert s.stop - s.start == global_batch // n
        got.extend(range(s.start, s.stop))
    assert got == list(range(global_batch))
    batch = np.random.RandomState(0).rand(global_batch, 2)
    np.testing.assert_array_equal(np.concatenate([
        batch[local_batch_slice(global_batch, n, i)] for i in range(n)]),
        batch)


def test_local_batch_slice_outside_a_group_is_everything():
    assert local_batch_slice(10) == slice(0, 10)
    assert device_count() == 1


# ---- collectives -----------------------------------------------------------

def _x(r):
    return np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r


@pytest.mark.parametrize("tag,world", [("world", 4), ("pair", 2)])
def test_collectives(ranks, tag, world):
    xs = [_x(r) for r in range(world)]
    total = sum(xs)
    for r in range(world):
        got = ranks[r]
        np.testing.assert_array_equal(got[f"{tag}/psum"], total)
        np.testing.assert_allclose(got[f"{tag}/pmean"], total / world,
                                   rtol=1e-6)
        np.testing.assert_allclose(got[f"{tag}/pmean_list"], np.concatenate(
            [total.ravel(), total[0] * 2]) / world, rtol=1e-6)
        np.testing.assert_array_equal(got[f"{tag}/all_gather"],
                                      np.concatenate(xs))
        np.testing.assert_array_equal(got[f"{tag}/all_gather_stacked"],
                                      np.stack(xs, 1))
        np.testing.assert_array_equal(got[f"{tag}/ppermute_ring"],
                                      xs[(r - 1) % world])
        np.testing.assert_array_equal(got[f"{tag}/ppermute_partial"],
                                      xs[r - 1] if r else np.zeros((2, 3)))
        big = sum(np.arange(4 * world, dtype=np.float32).reshape(2 * world, 2)
                  * (s + 1) for s in range(world))
        np.testing.assert_array_equal(got[f"{tag}/reduce_scatter"],
                                      big[2 * r:2 * r + 2])
        np.testing.assert_array_equal(got[f"{tag}/index_size"], [r, world])
        # psum's transpose sums the cotangents: sum over s of (s + 1)
        np.testing.assert_array_equal(
            got[f"{tag}/psum_grad"], np.full((2, 3), world * (world + 1) / 2))


def test_a_smaller_mesh_leaves_the_other_ranks_out(ranks):
    assert [int(r["device_count"]) for r in ranks] == [4] * 4
    assert [bool(r["pair_is_none"]) for r in ranks] == [False, False, True,
                                                        True]
    assert "pair/psum" not in ranks[2]


# ---- cross-replica BN ------------------------------------------------------

def _single_bn():
    x, w, t, scale, bias = (torch.from_numpy(a) for a in bn_inputs())
    x.requires_grad_(True)
    sc = scale.clone().requires_grad_(True)
    bi = bias.clone().requires_grad_(True)
    state = {"mean": torch.zeros(3), "var": torch.ones(3)}
    y, new = N.batch_norm(x, sc, bi, state=state)
    loss = (w * (y - t) ** 2).mean()
    gx, gs, gb = torch.autograd.grad(loss, (x, sc, bi))
    return {k: v.detach().numpy() for k, v in (
        ("y", y), ("gx", gx), ("gscale", gs), ("gbias", gb),
        ("mean", new["mean"]), ("var", new["var"]))}


@pytest.mark.parametrize("tag,world", [("world", 4), ("pair", 2)])
def test_cross_replica_bn_is_the_whole_batch_bn(ranks, tag, world):
    want = _single_bn()
    for r in range(world):
        got = {k.split("/")[1]: v for k, v in ranks[r].items()
               if k.startswith(f"{tag}/") and "/" in k}
        sl = local_batch_slice(BN_SHAPE[0], world, r)
        np.testing.assert_allclose(got["y"], want["y"][sl], atol=1e-6)
        # JAX's transpose: each rank differentiates the sum of the ranks'
        # losses, world times the whole batch's mean loss
        np.testing.assert_allclose(got["gx"], world * want["gx"][sl],
                                   atol=1e-6)
        for k in ("gscale", "gbias", "mean", "var"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


def test_cross_replica_statistics_refuse_the_inference_modes():
    mesh = Mesh(group=None, rank=0, size=1, axis_name="data",
                device=torch.device("cpu"))
    x = torch.rand(4, 2, 3, 3)
    one, zero = torch.ones(2), torch.zeros(2)
    for kw in ({"per_image": True}, {"groups": 2}):
        with pytest.raises(ValueError, match="inference modes"):
            N.batch_norm(x, one, zero, axis_name=mesh, **kw)
    spec = ({"kind": "convT", "cin": 2, "cout": 2, "k": 4, "s": 2, "p": 1,
             "bn": True, "act": "relu"},
            {"kind": "conv", "cin": 2, "cout": 1, "k": 4, "s": 2, "p": 1})
    from dcgan_sr_tpu_torch.models import init_network
    fused = Network(spec, *init_network(spec, torch.Generator().manual_seed(0)),
                    device="cpu")
    with pytest.raises(ValueError, match="never cross-replica"):
        fused(x, axis_name=mesh)
    plain = Network(spec, *init_network(spec, torch.Generator().manual_seed(0)),
                    device="cpu", fuse=False)
    with pytest.raises(ValueError, match="never cross-replica"):
        plain(x, bn_stats="running", axis_name=mesh)
