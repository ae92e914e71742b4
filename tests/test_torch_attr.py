"""The port's attribution tools (python -m dcgan_sr_tpu_torch.attr_variant
and .attr_overlap) against the JAX tools, on the CPU at tiny widths: the
values they time equal the JAX tools' in fp32 (weights carried across from
the JAX package's init, rtol 1e-4), and they print the JAX tools' keys and
row labels.  Times from these runs are the host's and are not asserted."""

import contextlib
import functools
import io
import json
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from dcgan_sr_tpu.core import get_config as j_get_config
from dcgan_sr_tpu.image.ops import box_downsample2 as j_box_downsample2
from dcgan_sr_tpu.image.patches import (
    extract_overlap_patches as j_extract_overlap_patches,
    stitch_overlap_naive as j_stitch_overlap_naive)
from dcgan_sr_tpu.infer.seam_device import (
    seam_stitch_device as j_seam_stitch_device)
from dcgan_sr_tpu.infer.tiled import make_overlap_sr_fn as j_make_overlap_sr_fn
from dcgan_sr_tpu.models import apply_network as j_apply_network
from dcgan_sr_tpu.models import discriminator_spec as j_discriminator_spec
from dcgan_sr_tpu.models import generator_spec as j_generator_spec
from dcgan_sr_tpu.models import init_network as j_init_network
from dcgan_sr_tpu_torch import attr_overlap, attr_variant
from dcgan_sr_tpu_torch.core import VARIANTS, get_config
from dcgan_sr_tpu_torch.models import Network, generator_spec
from dcgan_sr_tpu_torch.train.multi_step import counted
from tools import attr_variant as j_attr_variant

import torch_threads  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-6)
WIDTHS = dict(ngf=4, ndf=8)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(argv)
    return ret, buf.getvalue().splitlines()


def _jax_weights(spec, seed=1):
    params, bn = j_init_network(jax.random.PRNGKey(seed), spec)
    return (jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, bn))


# ---- attr_variant -------------------------------------------------------------

@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("net", ["g", "d"])
def test_scan_apply_equals_the_jax_tools(net, grad):
    """K = 2 passes of G (as the trainer runs it: layers 3-4 unfused and
    trainable) or D, forward or forward + backward, folded into one scalar:
    the port's scan_apply against tools/attr_variant.scan_apply."""
    cfg = j_get_config("gray-3", env_override=False, **WIDTHS)
    spec = (j_generator_spec if net == "g" else j_discriminator_spec)(cfg)
    params, bn = _jax_weights(spec)
    hw = 32 if net == "g" else 64
    xs = np.random.RandomState(3).rand(2, 2, 1, hw, hw).astype(np.float32)
    want = j_attr_variant.scan_apply(spec, params, bn, jnp.asarray(xs),
                                     dtype=None, grad=grad)
    port = Network(spec, params, bn, device="cpu", fuse=False, trainable=True)
    got = attr_variant.scan_apply(port, torch.from_numpy(xs), grad)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def _jax_tool_json(monkeypatch, variant):
    """The JAX tool's main at tiny widths with its timing and its jitted
    programs replaced (nothing compiles): its last line, parsed."""
    from dcgan_sr_tpu.train import multi_step as JMS

    def fake_multi_step(cfg):
        return lambda state, sb: (state, {"errG": jnp.zeros(sb.shape[0])})

    monkeypatch.setattr(JMS, "jit_multi_step", fake_multi_step)
    monkeypatch.setattr(j_attr_variant, "_timed", lambda *a: 1e-3)
    monkeypatch.setattr(sys, "argv", [
        "attr_variant.py", "--cpu", "--config", variant, "--batch", "2",
        "--steps", "1", "--reps", "1", "--ngf", "4", "--ndf", "8"])
    _, lines = _run(lambda argv: j_attr_variant.main(), None)
    return json.loads(lines[-1])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefix_rows_are_labelled_as_the_jax_tools(monkeypatch, variant):
    want = [r["layer"] for r in _jax_tool_json(monkeypatch, variant)
            ["g_layers"]]
    cfg = get_config(variant, env_override=False, **WIDTHS)
    assert [attr_variant.layer_desc(l) for l in generator_spec(cfg)] == want


def test_attr_variant_prints_the_jax_tools_keys(monkeypatch):
    want = _jax_tool_json(monkeypatch, "gray-3")
    ran = {}
    got, lines = _run(functools.partial(attr_variant.main, launches=ran), [
        "--cpu", "--config", "gray-3", "--batch", "2", "--steps", "2",
        "--reps", "1", "--ngf", "4", "--ndf", "8"])
    # every kernel's launches that ran in the step's chunks: none on the CPU
    assert ran == dict.fromkeys(counted(), 0)
    assert json.loads(lines[-1]) == got
    assert list(got) == list(want)
    assert [r["layer"] for r in got["g_layers"]] == \
        [r["layer"] for r in want["g_layers"]]
    assert list(got["g_layers"][0]) == ["layer", "prefix_ms", "delta_ms"]
    assert (got["config"], got["dtype"], got["step_batch"]) == \
        ("gray-3", "bfloat16", 2)
    assert lines[0].startswith("full step ") and "img-eq/s" in lines[0]
    assert [l.split()[0] for l in lines[1:5]] == ["g_fwd", "g_fwd_bwd",
                                                  "d_fwd", "d_fwd_bwd"]
    assert lines[5].startswith("-- G prefix ablation")


# ---- attr_overlap -------------------------------------------------------------

OVERLAP = dict(ngf=4, fineSize=16)     # 9 tiles an image


@pytest.fixture(scope="module")
def overlap_case():
    """(JAX cfg, port cfg, JAX weights, the port's served network on them,
    2 images of 16x16)."""
    jcfg = j_get_config("gray-patch-batch-overlap", env_override=False,
                        **OVERLAP)
    cfg = get_config("gray-patch-batch-overlap", env_override=False,
                     **OVERLAP)
    params, bn = _jax_weights(j_generator_spec(jcfg), seed=0)
    net = Network(generator_spec(cfg), params, bn, device="cpu")
    images = np.random.RandomState(4).rand(2, 16, 16).astype(np.float32)
    return jcfg, cfg, (params, bn), net, images


def _jax_stage(cfg, params, bn, stage, image):
    """tools/attr_overlap.py:204-221 (one_image), fp32."""
    patch, ov = cfg.patchSize, cfg.overlap
    fine = (cfg.fineSize, cfg.fineSize)
    spec = j_generator_spec(cfg)
    tiles = j_extract_overlap_patches(image, patch, ov)
    lr = j_box_downsample2(tiles)[:, None]
    if stage == "extract":
        return lr.astype(jnp.float32).mean()
    fake, _ = j_apply_network(spec, params, lr, bn, train=True)
    fake = fake[:, 0]
    if stage == "gen":
        return fake.astype(jnp.float32).mean()
    acc = j_stitch_overlap_naive(fake, fine, patch, ov).astype(
        jnp.float32).mean()
    if stage == "naive":
        return acc
    return acc + j_seam_stitch_device(fake, fine, patch, ov).astype(
        jnp.float32).mean()


@pytest.mark.parametrize("stage", attr_overlap.STAGES)
def test_overlap_stage_values_equal_the_jax_tools(overlap_case, stage):
    jcfg, cfg, (params, bn), net, images = overlap_case
    want = jax.vmap(lambda im: _jax_stage(jcfg, params, bn, stage, im))(
        jnp.asarray(images)).sum()
    got = attr_overlap.stage_fns(cfg, net)[stage](torch.from_numpy(images))
    np.testing.assert_allclose(float(got), float(want), **TOL)


def _jax_sweep(cfg, params, bn, name, images):
    """tools/attr_overlap.py:88-121, fp32."""
    patch, ov = cfg.patchSize, cfg.overlap
    fine = (cfg.fineSize, cfg.fineSize)
    if name == "flat_pooled":
        tiles = jax.vmap(
            lambda im: j_extract_overlap_patches(im, patch, ov))(images)
        n = tiles.shape[0]
        nt = n * tiles.shape[1]
        lr = j_box_downsample2(tiles.reshape(nt, patch, patch))[:, None]
        fake, _ = j_apply_network(j_generator_spec(cfg), params, lr, bn,
                                  train=True)

        def stitch(f):
            return (j_stitch_overlap_naive(f, fine, patch, ov).mean()
                    + j_seam_stitch_device(f, fine, patch, ov).mean())
        return jax.vmap(stitch)(fake[:, 0].reshape(n, -1, patch, patch)).sum()
    bn_eval, flat = {"vmap_train": (False, False), "vmap_eval": (True, False),
                     "flat_eval": (True, True)}[name]
    out = j_make_overlap_sr_fn(cfg, bn_eval=bn_eval, flat_tiles=flat)(
        params, bn, images)
    return out["naive"].mean() + out["seam"].mean()


@pytest.mark.parametrize("name", ["vmap_train", "vmap_eval", "flat_eval",
                                  "flat_pooled"])
def test_overlap_sweep_structures_equal_the_jax_tools(overlap_case, name):
    jcfg, cfg, (params, bn), net, images = overlap_case
    want = _jax_sweep(jcfg, params, bn, name, jnp.asarray(images))
    got = attr_overlap.sweep_fns(cfg, net)[name](torch.from_numpy(images))
    np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("sweep", [False, True])
def test_attr_overlap_prints_the_jax_tools_fields(sweep):
    res, lines = _run(attr_overlap.main, [
        "--cpu", "--images", "2", "--steps", "2", "--reps", "1",
        "--ngf", "4"] + ["--sweep-bn"] * sweep)
    assert json.loads("\n".join(lines)) == res
    names = (["vmap_train", "vmap_eval", "flat_eval", "flat_pooled"] if sweep
             else list(attr_overlap.STAGES))
    fields = (["_ms", "_mp_per_s", "_gflop", "_cost_error"] if sweep
              else ["_ms", "_mp_per_s"])
    head = ["images_per_dispatch", "scan_steps", "dtype"]
    tail = ([] if sweep else ["delta_gen_ms", "delta_naive_ms",
                              "delta_seam_ms", "flops_per_step_g",
                              "cost_analysis_error"])
    assert list(res) == head + [n + f for n in names for f in fields] + tail
    assert (res["images_per_dispatch"], res["scan_steps"], res["dtype"]) == \
        (2, 2, "bfloat16")
    # 2 images x 225 tiles through the spec's convolutions
    cfg = get_config("gray-patch-batch-overlap", env_override=False, ngf=4)
    gflop = round(450 * attr_overlap.conv_flops(generator_spec(cfg), 4) / 1e9,
                  2)
    key = "vmap_train_gflop" if sweep else "flops_per_step_g"
    assert res[key] == gflop > 0
    err = res["vmap_train_cost_error" if sweep else "cost_analysis_error"]
    assert err == "no XLA cost analysis in PyTorch"


def test_conv_flops_counts_each_convolution():
    spec = ({"kind": "upsample", "factor": 2},
            {"kind": "convT", "cin": 1, "cout": 8, "k": 4, "s": 2, "p": 1},
            {"kind": "conv", "cin": 8, "cout": 2, "k": 4, "s": 2, "p": 1})
    # 4 -> 8 (upsample) -> 16 (convT: 2*1*8*16 MACs per input pixel, 64
    # input pixels) -> 8 (conv: 2*8*2*16 per output pixel, 64 of them)
    assert attr_overlap.conv_flops(spec, 4) == 2 * 128 * 64 + 2 * 256 * 64
