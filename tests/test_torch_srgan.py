"""SRGAN's generator (a port-only model, core/config.py MODELS) on the
port's spec-driven network, against the plain reference
(dcgan_sr_tpu_torch/reference/srgan.py) on seeded random weights at the
published widths: two LR images of 12x12, in fp32 and in bf16.

The running statistics are made by the benchmark's own recipe
(benchmark/drivers/bulk_srresnet.py calibrate_running): the pooled
statistics of a seed-drawn batch through the reference, each variance
scaled and each mean moved a little, so that no BN layer is the identity.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.drivers.bulk_srresnet import calibrate_running
from dcgan_sr_tpu_torch.core import MODELS, VARIANTS, resolve_config
from dcgan_sr_tpu_torch.infer.tiled import make_full_sr_fn
from dcgan_sr_tpu_torch.models import Network, generator_spec, init_network
from dcgan_sr_tpu_torch.ops import bn as BN
from dcgan_sr_tpu_torch.ops import nn as N
from dcgan_sr_tpu_torch.reference import srgan as R
from dcgan_sr_tpu_torch.train.checkpoint import load_generator, \
    save_generator
from dcgan_sr_tpu_torch.utils import profiling as prof

import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = torch.bfloat16
M = MODELS["srgan-x4"]
SIZES = dataclasses.asdict(M)

# fp32: the same float32 operations as the reference; the room is for a
# convolution algorithm that sums in another order (about 100 ulps of the
# output's scale, 0.1).
FP32_ATOL = 1e-5
# bf16: every conv, BN, PReLU and sum rounds to 8 significant bits, 90 of
# them in a row.  Over seeds 1-8 the port reads a mean gap of 0.0023-0.0026
# (the worst image's) and a largest of 0.015-0.018 against the reference;
# the reference with every conv in float8 (the control) reads 0.026-0.030
# and 0.15-0.21.  The tolerances sit between: about 2.4x the port's worst,
# and a quarter to a third of the control's best.
BF16_MEAN_TOL = 0.006
BF16_MAX_TOL = 0.045


def _setup(seed):
    """(params, state, x): seeded weights with running statistics, and two
    LR images of 12x12."""
    gen = torch.Generator().manual_seed(seed)
    params, state = R.draw(SIZES, gen)
    calibrate_running(SIZES, params, state,
                      torch.rand((2, 3, 12, 12), generator=gen), gen)
    return params, state, torch.rand((2, 3, 12, 12), generator=gen)


def _gaps(a, b):
    d = (a - b).abs().reshape(a.shape[0], -1)
    return float(d.mean(1).max()), float(d.max())


def _port(spec, params, state, x, dtype=None):
    net = Network(spec, params, state, device="cpu")
    return make_full_sr_fn(net, compute_dtype=dtype, lr_input=True,
                           bn_eval=True)(x)


def test_the_table_and_the_spec():
    assert "srgan-x4" in MODELS and "srgan-x4" not in VARIANTS
    assert resolve_config("srgan-x4") is M
    assert resolve_config("gray-3", env_override=False).variant == "gray-3"
    assert M.scale == 4 and M.up_blocks == 2
    spec = generator_spec(M)
    assert spec == R.spec(SIZES)
    convs, bns = [], []

    def walk(layers):
        for layer in layers:
            if layer["kind"] == "residual":
                walk(layer["body"])
            elif layer["kind"] == "conv":
                convs.append(layer)
                bns.extend([layer] if layer["bn"] else [])

    walk(spec)
    assert len(convs) == 37 and len(bns) == 33
    assert all(c["bias"] and c["s"] == 1 for c in convs)
    params, _ = R.draw(SIZES, torch.Generator().manual_seed(0))
    n = 0

    def count(t):
        nonlocal n
        if isinstance(t, list):
            for v in t:
                count(v)
        elif isinstance(t, dict):
            for v in t.values():
                count(v)
        else:
            n += t.numel()

    count(params)
    assert n == 1_550_659          # the paper's 1.5 M
    # the port's own init has the same structure and the same leaves
    p0, s0 = init_network(spec, torch.Generator().manual_seed(0))
    net = Network(spec, p0, s0, device="cpu")
    assert sum(p.numel() for p in net.parameters()) == n


@pytest.mark.parametrize("seed", [1, 2])
def test_fp32_is_the_reference(seed):
    params, state, x = _setup(seed)
    ref = R.forward(params, state, x)
    got = _port(generator_spec(M), params, state, x)
    assert got.shape == (2, 3, 48, 48)
    assert float(ref.std()) > 0.03
    assert torch.allclose(got, ref, rtol=0, atol=FP32_ATOL)


@pytest.mark.parametrize("seed", [1, 2])
def test_bf16_within_its_tolerances_and_fp8_outside(seed):
    params, state, x = _setup(seed)
    ref = R.forward(params, state, x)
    mean, top = _gaps(_port(generator_spec(M), params, state, x, BF16), ref)
    assert mean < BF16_MEAN_TOL and top < BF16_MAX_TOL, (mean, top)
    mean8, top8 = _gaps(R.forward(params, state, x, precision="fp8"), ref)
    assert mean8 > BF16_MEAN_TOL and top8 > BF16_MAX_TOL, (mean8, top8)


def _without(spec, params, state, which):
    """The spec and trees with the long skip ("long") or every block's sum
    ("blocks") left out: the residual layer's body spliced in its place."""
    spec, params, state = list(spec), list(params), list(state)
    if which == "long":
        body = spec[1]["body"]
        return (spec[:1] + list(body) + spec[2:],
                params[:1] + params[1]["body"] + params[2:],
                state[:1] + state[1]["body"] + state[2:])
    trunk, p, s = [], [], []
    for layer, lp, ls in zip(spec[1]["body"], params[1]["body"],
                             state[1]["body"]):
        if layer["kind"] == "residual":
            trunk += layer["body"]
            p += lp["body"]
            s += ls["body"]
        else:
            trunk.append(layer)
            p.append(lp)
            s.append(ls)
    spec[1] = {"kind": "residual", "body": tuple(trunk)}
    params[1], state[1] = {"body": p}, {"body": s}
    return spec, params, state


@pytest.mark.parametrize("which", ["long", "blocks"])
def test_leaving_out_a_sum_fails(which):
    params, state, x = _setup(3)
    ref = R.forward(params, state, x)
    got = _port(*_without(generator_spec(M), params, state, which), x)
    assert got.shape == ref.shape
    mean, top = _gaps(got, ref)
    # beyond the bf16 tolerances, so a bf16 run without it fails them
    assert mean > 2 * BF16_MEAN_TOL and top > BF16_MAX_TOL, (mean, top)


@pytest.mark.parametrize("factor,c", [(2, 8), (2, 256), (3, 18)])
def test_pixel_shuffle_is_torchs(factor, c):
    # the order the spec states: channel c * r * r + i * r + j of x goes to
    # channel c at (h * r + i, w * r + j)
    r = factor
    x = torch.randperm(2 * c * 5 * 7).float().reshape(2, c, 5, 7)
    for dtype in (torch.float32, BF16):
        y = N.pixel_shuffle(x.to(dtype), r)
        assert y.shape == (2, c // (r * r), 5 * r, 7 * r)
        want = x.reshape(2, c // (r * r), r, r, 5, 7).permute(
            0, 1, 4, 2, 5, 3).reshape(y.shape)
        assert torch.equal(y, want.to(dtype))
        assert torch.equal(y[1, -1, 4 * r + r - 1, r - 1],
                           x[1, c - 1, 4, 0].to(dtype))


def test_conv_bias_in_the_compute_dtype_and_its_gradient():
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 5, 6, 6), generator=g, requires_grad=True)
    w = torch.randn((7, 5, 3, 3), generator=g, requires_grad=True)
    b = torch.randn((7,), generator=g, requires_grad=True)
    y = N.conv2d(x, w, 1, 1, bias=b)
    want = F.conv2d(x, w, b, padding=1)
    assert torch.allclose(y, want, atol=1e-5)
    gy = torch.randn(y.shape, generator=g)
    got = torch.autograd.grad(y, (x, w, b), gy)
    exp = torch.autograd.grad(want, (x, w, b), gy)
    for a, e in zip(got, exp):
        assert torch.allclose(a, e, atol=1e-4)
    # bf16: both operands and the bias rounded to bf16, summed in fp32,
    # rounded once
    yb = N.conv2d(x.detach(), w.detach(), 1, 1, compute_dtype=BF16,
                  bias=b.detach())
    ref = F.conv2d(x.detach().to(BF16).float(), w.detach().to(BF16).float(),
                   b.detach().to(BF16).float(), padding=1).to(BF16)
    assert yb.dtype == BF16 and torch.equal(yb, ref)


def test_prelu_is_channel_wise():
    x = torch.randn((2, 4, 3, 3), generator=torch.Generator().manual_seed(5))
    a = torch.tensor([0.25, 0.0, -0.5, 1.0])
    want = torch.where(x >= 0, x, a[None, :, None, None] * x)
    assert torch.equal(N.prelu(x, a), want)
    assert N.ACTIVATIONS["prelu"] is N.prelu


def test_every_bn_layer_takes_the_kernels_with_no_activation(monkeypatch):
    """With the rule holding (as for a bf16 map on the card) and the kernel
    path stood in for by its plain version: all 33 BN layers go to
    BN.bn_act on the running statistics with no activation folded, and the
    output keeps its bits."""
    params, state, x = _setup(6)
    want = _port(generator_spec(M), params, state, x, BF16)
    calls = []

    def bn_act(x, scale, bias, *, running=None, act=None, **kw):
        calls.append((act, running is not None))
        a = N.normalize(x, running[0], running[1], scale, bias)
        return a, running[0], running[1]

    monkeypatch.setattr(BN, "takes", lambda *a, **k: True)
    monkeypatch.setattr(BN, "bn_act", bn_act)
    got = _port(generator_spec(M), params, state, x, BF16)
    assert torch.equal(got, want)
    assert calls == [(None, True)] * 33


def test_counters_and_spans():
    params, state, x = _setup(7)
    net = Network(generator_spec(M), params, state, device="cpu")
    run = make_full_sr_fn(net, lr_input=True, bn_eval=True)
    before = dict(prof.counters)
    run(x)
    ran = {k: prof.counters[k] - before[k] for k in before}
    # on the CPU the narrow conv's counters stay still (its rule reads CUDA)
    assert ran == {"residual": 17, "shuffle": 2, "prelu": 19,
                   "conv_narrow": 0, "conv_narrow_plain": 0}
    from torch.profiler import ProfilerActivity, profile
    prof.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        run(x)
    totals = prof.span_totals()
    prof.reset_spans()
    assert totals["residual"]["count"] == 17
    assert totals["shuffle"]["count"] == 2
    assert totals["act"]["count"] == 19
    assert totals["bn"]["count"] == 33 and totals["conv"]["count"] == 37


def test_npz_round_trip(tmp_path):
    params, state, x = _setup(8)
    net = Network(generator_spec(M), params, state, device="cpu")
    path = save_generator(str(tmp_path / "srgan_net_G.npz"), net)
    with np.load(path) as data:
        keys = set(data.files)
    for k in ("_params_/_0_/_w_", "_params_/_0_/_b_", "_params_/_0_/_prelu_",
              "_params_/_1_/_body_/_0_/_body_/_0_/_bn_scale_",
              "_params_/_1_/_body_/_15_/_body_/_1_/_bn_bias_",
              "_params_/_1_/_body_/_16_/_w_", "_params_/_3_/_prelu_",
              "_params_/_6_/_b_",
              "_state_/_1_/_body_/_0_/_body_/_1_/_bn_/_mean_",
              "_state_/_1_/_body_/_16_/_bn_/_var_", "__branches__"):
        assert k in keys, k
    # params: head 3, blocks 16 x (5 + 4), mid 4, up convs 2 x 2, shuffles
    # 2, tail 2; state: 33 BN layers x 2; and the branch list
    assert len(keys) == 159 + 66 + 1
    back, _ = load_generator(M, path, need_state=True, device="cpu")
    for (n1, a), (n2, b) in zip(net.state_dict().items(),
                                back.state_dict().items()):
        assert n1 == n2 and torch.equal(a, b), n1
    run = make_full_sr_fn(back, lr_input=True, bn_eval=True)
    assert torch.allclose(run(x), R.forward(params, state, x), rtol=0,
                          atol=FP32_ATOL)


def _cli(*args):
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_upscale_end_to_end(tmp_path):
    from PIL import Image
    params, state, _ = _setup(9)
    net = Network(generator_spec(M), params, state, device="cpu")
    ckpt = save_generator(str(tmp_path / "g.npz"), net)
    rgb = (np.random.default_rng(9).random((10, 12, 3)) * 255).astype(
        np.uint8)
    Image.fromarray(rgb).save(tmp_path / "lr.png")
    out = tmp_path / "sr.png"
    r = _cli("dcgan_sr_tpu_torch.upscale", "--cpu", "--config", "srgan-x4",
             "--ckpt", ckpt, "--input", str(tmp_path / "lr.png"),
             "--output", str(out))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "4x: 10x12 -> 40x48" in r.stdout
    got = np.asarray(Image.open(out), np.float32)
    x = torch.from_numpy(rgb.astype(np.float32).transpose(2, 0, 1) / 255)
    ref = (R.forward(params, state, x[None])[0].numpy() + 1) / 2
    ref = np.clip(np.round(ref.transpose(1, 2, 0) * 255), 0, 255)
    assert got.shape == (40, 48, 3)
    # a level either way where a value sits on a rounding edge
    assert np.abs(got - ref).max() <= 1
    # a directory runs the variants' batch path: mixed sizes edge-padded
    # into one batch and cropped back at 4x
    lr_dir = tmp_path / "lr"
    lr_dir.mkdir()
    Image.fromarray(rgb).save(lr_dir / "a.png")
    Image.fromarray(rgb[:7, :9]).save(lr_dir / "b.png")
    r = _cli("dcgan_sr_tpu_torch.upscale", "--cpu", "--config", "srgan-x4",
             "--ckpt", ckpt, "--input", str(lr_dir),
             "--output", str(tmp_path / "sr"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "b.png: 7x9 -> 28x36" in r.stdout
    a = np.asarray(Image.open(tmp_path / "sr" / "a_sr.png"), np.float32)
    assert np.abs(a - got).max() <= 1     # another batch, another sum order
    assert np.asarray(Image.open(tmp_path / "sr" / "b_sr.png")).shape == (
        28, 36, 3)
    r = _cli("dcgan_sr_tpu_torch.upscale", "--cpu", "--config", "srgan-x4",
             "--input", str(tmp_path / "lr.png"), "--output", str(out),
             "--true-2x")
    assert r.returncode == 1 and "not supported: --true-2x" in r.stderr


@pytest.mark.parametrize("tool,what", [("serve", "buckets assume 2x"),
                                       ("cli", "discriminator and loss")])
def test_serve_and_cli_refuse_it_in_one_line(tool, what):
    r = _cli(f"dcgan_sr_tpu_torch.{tool}", "--cpu", "--config", "srgan-x4")
    assert r.returncode == 1
    lines = r.stderr.strip().splitlines()
    assert len(lines) == 1 and what in lines[0] and "srgan-x4" in lines[0]


def test_the_reference_loads_nothing_of_the_port_and_no_jax():
    code = ("import sys, json\n"
            "import dcgan_sr_tpu_torch.reference.srgan\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    loaded = json.loads(r.stdout.strip().splitlines()[-1])
    port = [m for m in loaded if m.split(".")[0] == "dcgan_sr_tpu_torch"]
    assert sorted(port) == ["dcgan_sr_tpu_torch",
                            "dcgan_sr_tpu_torch.reference",
                            "dcgan_sr_tpu_torch.reference.srgan"]
    assert not {m.split(".")[0] for m in loaded} & {"jax", "jaxlib", "flax",
                                                    "dcgan_sr_tpu"}
