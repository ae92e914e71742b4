"""The plain reference against the program at small widths on the CPU, in
float32: the four entries the cells drive compute the same function."""

import numpy as np
import pytest
import torch

from benchmark import spec, weights
from benchmark.reference import sr as R
from benchmark.reference import train_step as T


def _conf(name, **kw):
    import json
    import os

    from benchmark import harness
    with open(os.path.join(harness.HERE, "configs", name + ".json")) as f:
        return {**json.load(f), **kw}


def _port_cfg(conf, **kw):
    from dcgan_sr_tpu_torch.core import get_config
    keys = {k: v for k, v in conf.items()
            if k not in ("name", "source", "reduced", "generator", "assumed",
                         "variant")}
    return get_config(conf["variant"], env_override=False, **{**keys, **kw})


def _net(conf, params, **kw):
    from dcgan_sr_tpu_torch.models import Network, generator_spec
    cfg = _port_cfg(conf)
    return cfg, Network(generator_spec(cfg), *weights.port_trees(params),
                        device="cpu", **kw)


def test_train_step_matches_the_programs_fp32_step():
    from dcgan_sr_tpu_torch.models import Network, discriminator_spec, \
        generator_spec
    from dcgan_sr_tpu_torch.ops.adam import adam_init
    from dcgan_sr_tpu_torch.train.step import TrainState, build_train_step, \
        params_of

    conf = _conf("gray-3", ngf=4, ndf=8)
    cfg = _port_cfg(conf, batchSize=4)
    g_spec, d_spec = spec.generator(conf), spec.discriminator(conf)
    gen = weights.generator_for(7, "cpu")
    g0, d0 = weights.draw(g_spec, gen, "cpu"), weights.draw(d_spec, gen, "cpu")
    g = Network(generator_spec(cfg), *weights.port_trees(g0), device="cpu",
                fuse=False, trainable=True)
    d = Network(discriminator_spec(cfg), *weights.port_trees(d0),
                device="cpu", fuse=False, trainable=True)
    state = TrainState(g=g, d=d, g_opt=adam_init(params_of(g)),
                       d_opt=adam_init(params_of(d)))
    step = build_train_step(cfg)
    ref = T.init_state(g0, d0)
    hr = torch.rand((2, 4, 1, 64, 64), generator=gen)
    for j in range(2):
        _, m = step(state, hr[j])
        r = T.step(ref, hr[j], g_spec, d_spec, conf)
        for k in ("errD_real", "errD_fake", "errG"):
            assert float(m[k]) == pytest.approx(r[k], rel=1e-5)
    # Adam's first steps are near sign steps of size lr: where a gradient
    # is near eps, rounding moves the step by up to 2 lr
    for a, b in zip(params_of(state.g) + params_of(state.d),
                    T.leaves(ref["g"]) + T.leaves(ref["d"])):
        assert torch.allclose(a, b, rtol=0, atol=2 * conf["lr"])
        assert float((a - b).detach().abs().mean()) < 1e-2 * conf["lr"]


def test_overlap_pipeline_matches_the_program():
    from dcgan_sr_tpu_torch.infer.tiled import make_overlap_sr_fn

    conf = _conf("gray-patch-batch-overlap", ngf=4)
    g_spec = spec.generator(conf)
    params = weights.draw(g_spec, weights.generator_for(3, "cpu"), "cpu")
    cfg, net = _net(conf, params)
    x = torch.rand((2, 64, 64), generator=torch.Generator().manual_seed(1))
    got = make_overlap_sr_fn(cfg, net)(x)
    ref = R.overlap_sr(g_spec, params, x, conf)
    assert torch.allclose(got["tiles"], ref["tiles"], atol=2e-6)
    naive, seam = R.stitches(got["tiles"], (64, 64), conf)
    assert torch.equal(got["naive"], naive)
    assert torch.equal(got["seam"], seam)
    assert torch.allclose(ref["naive"], naive, atol=2e-6)


def test_seam_matches_the_host_oracle_on_ties():
    from dcgan_sr_tpu_torch.infer.seam import seam_stitch

    rng = np.random.default_rng(5)
    # coarse levels make equal DP costs, so the tie-breaks are exercised
    tiles = rng.integers(0, 3, (225, 8, 8)).astype(np.float32) / 2
    ours = R.seam.seam_stitch(torch.from_numpy(tiles)[None], (64, 64), 8, 4)
    assert np.array_equal(ours[0].numpy(), seam_stitch(tiles, 64, 8, 4))


def test_full_image_sr_matches_the_program():
    from dcgan_sr_tpu_torch.infer.tiled import make_full_sr_fn

    conf = _conf("gray-3", ngf=4)
    g_spec = spec.generator(conf)
    params = weights.draw(g_spec, weights.generator_for(4, "cpu"), "cpu")
    _, net = _net(conf, params)
    x = torch.rand((3, 1, 16, 16), generator=torch.Generator().manual_seed(2))
    got = make_full_sr_fn(net, lr_input=True)(x)
    ref = R.full_sr(g_spec, params, x)
    assert got.shape == (3, 1, 32, 32)
    assert torch.allclose(got, ref, atol=2e-6)


def test_served_request_matches_the_program():
    from dcgan_sr_tpu_torch.serve import SRService

    conf = _conf("gray-patch-batch-overlap", ngf=4)
    g_spec = spec.generator(conf)
    gen = weights.generator_for(5, "cpu")
    params = weights.draw(g_spec, gen, "cpu")
    tiles = R.overlap_tiles(torch.rand((1, 32, 32), generator=gen), 4, 2)
    params = weights.calibrate_running(g_spec, params, tiles[0][:, None], gen)
    assert not torch.equal(params[1]["bn_var"], torch.ones(16))
    cfg, net = _net(conf, params)
    svc = SRService(cfg, net, max_size=64, max_batch=4, bn_eval=True,
                    u8_io=True)
    try:
        assert svc.buckets == R.ladder(conf, 64)
        rng = np.random.default_rng(9)
        imgs = [rng.integers(0, 256, (s, s)).astype(np.float32) / 255
                for s in (20, 33, 48)]
        outs = svc.submit_many(imgs)
        for img, out in zip(imgs, outs):
            ref = R.serve_request(g_spec, params, torch.from_numpy(img),
                                  conf, svc.buckets)
            gap = np.abs(np.round(out * 255) - ref.numpy().astype(float))
            assert out.shape == (2 * img.shape[0], 2 * img.shape[1])
            # a level either way where a value sits on a rounding edge
            assert gap.max() <= 1 and (gap > 0).mean() < 0.01
    finally:
        svc.close()
