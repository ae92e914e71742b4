"""CLI: `python -m dcgan_sr_tpu_torch.cli --config <variant>` — the trainer.

Port of dcgan_sr_tpu/cli.py: config with env-var overrides, data pipeline
selection, the training loop with the reference log line, per-epoch npz
checkpoints and resume, end-of-run eval (PSNR/SSIM against the bilinear
control) and sample dumps through the min-max display normalizer.  It runs
on the first CUDA device unless `--cpu` is given.

Data, found as the JAX CLI finds it: the folder route for rgb-full and gray
(`--data-root`, else $DATA_ROOT, else the reference's CelebA folder) through
FolderDataset + PrefetchLoader, then the indexed route (`--data-root`, else
the reference's CelebA `Img/` directory of `%06d.jpg` files) through
IndexedCelebA, or the committed native decoder with `--native-loader`.  A
route that does not exist prints the JAX CLI's "not found" line and falls
back to the procedural source (data/synthetic.py); `--synthetic` asks for it,
`--textured` for the texture-rich fixture set.  On the folder route
`--device-preprocess` feeds raw [0,1] RGB and the step gray-converts,
normalizes and degrades on the device (K1, ops/preprocess.py);
`--device-augment` also moves the trainHook's crop + hflip there.  The patch
variants' batches are the JAX CLI's grid of patchSize tiles of each image,
and their steps per epoch count images.

`--bf16` computes in bf16 (fp32 master parameters); `--feed-bf16` ships the
batches' float leaves to the device as bf16, which the step upcasts.  `--eval`
scores `--eval-sets` file_sets of the train and test slices in fp32 through
an inference copy of G (the fused pair, K2 on a card); `--samples-dir` dumps
one sample's PNGs with the reference's stats lines.

`--scan K` runs K steps a call; on a card each full chunk after the first
is ONE CUDA graph replay (train/multi_step.py), and `--stage-ahead` builds
and copies chunk c+1 while the card runs chunk c (train/loop.py).
`--profile-dir` writes a torch.profiler trace of the training run
(utils/profiling.py).  The last line counts the kernels' launches that
ran (training, eval and dumps; train/multi_step.py `launches_run`: a
launch captured into a graph runs at each replay, not at its capture);
with `--scan` the line before "Total time" says what the graphs captured
and replayed.  The JAX CLI's opt-in rewrites are here: `--fast-ops` runs
the k4s2p1 convs in their k3s1p1 forms (ops/fast.py), `--compact-params`
keeps the conv masters 2-D (ops/compact.py; its checkpoints hold that
layout and resume under the same flag, and the eval and sample dumps run
on the unpacked state).

`--dp` under a launcher (`python -m torch.distributed.run --nproc_per_node
N -m dcgan_sr_tpu_torch.cli --dp ...`, one rank per card; gloo ranks with
`--cpu`) trains data-parallel (parallel/): cfg.batchSize is the global
batch, every rank draws the same global batch from the same seed and keeps
its slice (parallel.shard_batch, the loop's prepare_batch), BN is
cross-replica and the gradients are pmean'd; rank 0 alone writes
checkpoints, sample dumps, the eval lines and the log.  A world of one is
still the data-parallel step.  Without a launcher `--dp` runs the
single-device step, as the JAX CLI does on one device.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

from .core import get_config
from .data import (FolderDataset, IndexedCelebA, PrefetchLoader,
                   SyntheticImages, TexturedImages)
from .data.indexed import DEFAULT_ROUTE
from .evaluation import (evaluate_overlap_slice, evaluate_slice,
                         inference_generator, polarity_rescue)
from .image.io import save_display
from .image.ops import box_downsample2, resize_bilinear, rgb2gray
from .infer.tiled import (make_generator_fn, make_overlap_sr_fn,
                          sr_full_image, sr_grid_patches, sr_overlap_image)
from .metrics import cal_psnr, cal_ssim
from .models import discriminator_spec, generator_spec
from .ops import bulge, preprocess
from .ops.compact import unpack_state
from .parallel import (build_dp_multi_step, build_dp_train_step,
                       initialize_from_env, launched, shard_batch)
from .train.checkpoint import latest_epoch, load_checkpoint
from .train.loop import train_epochs
from .train.multi_step import build_multi_step, launches_run
from .train.step import init_train_state
from .utils.device import pick_device
from .utils.logging import MetricsLogger
from .utils.profiling import profile_trace
from .utils.stats import print_tensor_stats

# the reference's folder route (DATA_ROOT, dcgan_sr_tpu/cli.py:56-57); the
# indexed route is data/indexed.py DEFAULT_ROUTE
FOLDER_ROUTE = "/CelebA/Img/img_align_celeba"


def patch_grid(hr, patch):
    """(B, 1, S, S) images -> (B * (S/patch)^2, 1, patch, patch) tiles, row-
    major within each image: the JAX CLI's pure-numpy grid extraction
    (dcgan_sr_tpu/cli.py:124-131)."""
    b = hr.shape[0]
    n = hr.shape[-1] // patch
    return (hr[:, 0].reshape(b, n, patch, n, patch)
            .transpose(0, 1, 3, 2, 4)
            .reshape(b * n * n, 1, patch, patch))


def build_data(cfg, args):
    """Returns (loader, batch_fn(epoch, step)): the batch in the variant's
    data range (the patch variants: their tiles), raw [0,1] RGB under
    device_preprocess, a (canvas, tops, lefts, flips) tuple under
    device_augment; numpy leaves."""
    data_root = getattr(args, "data_root", None)
    textured = getattr(args, "textured", False)
    if cfg.dataset == "folder" and not args.synthetic and not textured:
        root = data_root or os.environ.get("DATA_ROOT", FOLDER_ROUTE)
        if os.path.isdir(root):
            ds = FolderDataset(root, cfg.loadSize, cfg.fineSize, cfg.nc,
                               verbose=True)
            dev_pre, dev_aug = cfg.device_preprocess, cfg.device_augment
            if dev_aug:
                # raw loadSize canvases; crop/hflip happen in the train step
                sample = lambda rng: ds.sample_canvas(cfg.batchSize, rng)  # noqa: E731
            else:
                sample = lambda rng: ds.sample(cfg.batchSize, rng,  # noqa: E731
                                               normalize=not dev_pre)
            loader = PrefetchLoader(sample, n_threads=cfg.nThreads,
                                    manual_seed=cfg.manualSeed or 0)

            def batch_fn(epoch, i):
                batch = loader.get_batch()
                if dev_pre or dev_aug:
                    # raw [0,1] RGB (for device_augment a tuple): crop/hflip
                    # and gray-convert + normalize + degrade run in the step
                    return batch
                if cfg.nc == 1:
                    return np.ascontiguousarray(rgb2gray(batch)[:, None])
                return batch
            return loader, batch_fn
        print(f"DATA_ROOT {root} not found; falling back to synthetic data")
    if cfg.device_augment or cfg.device_preprocess:
        # these knobs expect the folder path's raw-RGB feed; the indexed/
        # synthetic sources pre-normalize on the host
        print("device_augment/device_preprocess need the folder data path; "
              "disabled for this run")
        cfg.device_augment = False
        cfg.device_preprocess = False

    # indexed / synthetic path (sequential file order like train-gray-3)
    if textured:
        src = TexturedImages(cfg.fineSize, nc=cfg.nc, seed=1234)  # a fixture set
    elif args.synthetic or cfg.dataset == "synthetic":
        src = SyntheticImages(cfg.fineSize, nc=cfg.nc,
                              seed=cfg.manualSeed or 1234)
    else:
        route = data_root or DEFAULT_ROUTE
        src = None
        if getattr(args, "native_loader", False):
            from .data import native
            if native.available():
                src = native.NativeIndexedLoader(
                    route, cfg.fineSize, nc=cfg.nc,
                    n_threads=max(cfg.nThreads, 1) * 2)
                print("using native C++ indexed loader")
            else:
                print("native loader requested but libdcgansr.so not built "
                      "(make -C native); falling back to Python loader")
        if src is None:
            src = IndexedCelebA(route, cfg.fineSize, nc=cfg.nc,
                                n_threads=cfg.nThreads)
        if not src.exists():
            print(f"indexed CelebA not found at {route}; using synthetic data")
            if hasattr(src, "close"):
                src.close()
            src = SyntheticImages(cfg.fineSize, nc=cfg.nc,
                                  seed=cfg.manualSeed or 1234)

    imgs_per_step = cfg.images_consumed_per_step

    def batch_fn(epoch, i):
        hr = src.load_batch(i, imgs_per_step)  # (imgs, nc, fine, fine) [0,1]
        if cfg.patch_based:
            hr = patch_grid(hr, cfg.patchSize)
        if cfg.data_range == "pm1":
            hr = hr * 2 - 1
        return np.ascontiguousarray(hr)

    return src, batch_fn


def dump_samples(cfg, state, out_dir, sample):
    """End-of-run PNG dumps through toDisplayTensor semantics (train.lua:306-326).

    `sample`: ONE image in the LOADER range [0,1] — (H, W), (1, H, W), or
    (C, H, W).  Range/channel conventions mirror the eval harness
    (evaluation/harness.py): a 3-channel sample is gray-converted when
    cfg.nc == 1 (the trainHook's rgb2gray) — the pre-conversion COLOR image
    is also saved, like testSample's real_none_color_sample.png
    (train-gray.lua:326) — the generator (the fp32 inference copy of G, on
    the state's device) is driven in its TRAINING range (pm1 variants get
    the trainHook's mul(2):add(-1), donkey_folder.lua:69), and outputs are
    mapped back to [0,1] so the printed PSNR/SSIM are comparable across
    variants.  Every saved PNG gets the reference's max/min/sum/std stats
    lines (train-gray.lua:334-380), computed on the [0,1]-mapped tensor that
    is saved.
    """
    os.makedirs(out_dir, exist_ok=True)

    def _dump(name, arr):
        # save + the reference's per-tensor stats lines, named by file stem
        arr = arr.detach().cpu().numpy()
        save_display(os.path.join(out_dir, name + ".png"), arr)
        print_tensor_stats(name, arr)

    net = inference_generator(cfg, state)
    gen = make_generator_fn(net)
    hr01 = torch.as_tensor(np.ascontiguousarray(sample, np.float32),
                           device=net.device)
    if hr01.dim() == 3 and cfg.nc == 1:
        if hr01.shape[0] == 3:
            # testSample saves the pre-rgb2gray color image first
            # (train-gray.lua:326)
            _dump("real_none_color_sample", hr01)
            hr01 = rgb2gray(hr01)          # (3, H, W) -> (H, W)
        else:
            hr01 = hr01[0]
    pm1 = cfg.data_range == "pm1"
    net_in = hr01 * 2.0 - 1.0 if pm1 else hr01
    _dump("real_none_sample", hr01)
    lr = box_downsample2(net_in)
    _dump("real_reduced_sample", (lr + 1.0) * 0.5 if pm1 else lr)
    bil = resize_bilinear(lr, cfg.fineSize, cfg.fineSize)
    if cfg.variant == "gray-patch-batch-overlap":
        res = sr_overlap_image(cfg, gen, net_in)
        naive, fake = res["naive"], res["seam"]
        if pm1:
            naive = (naive + 1.0) * 0.5
        _dump("fake_none_sample", naive)
        fake_name = "fake_none_overlap_sample"
    elif cfg.patch_based:
        fake = sr_grid_patches(cfg, gen, net_in)
        fake_name = "fake_none_sample"
    else:
        # multi-channel configs (rgb-full) feed (1, C, h, w); single-channel
        # ones (1, 1, h, w)
        fake, _ = sr_full_image(gen, net_in)
        fake_name = "fake_none_sample"
    if pm1:
        bil = (bil + 1.0) * 0.5
        fake = (fake + 1.0) * 0.5
    _dump("real_bilinear_sample", bil)
    _dump(fake_name, fake)

    def channel_mean(metric, a, b):
        if a.dim() == 2:
            return float(metric(a, b))
        return float(np.mean([float(metric(a[c], b[c]))
                              for c in range(a.shape[0])]))

    print("PSNR btwn real & bilinear: %.4f" % channel_mean(cal_psnr, hr01, bil))
    print("PSNR btwn real & fake: %.4f" % channel_mean(cal_psnr, hr01, fake))
    print("SSIM btwn real & bilinear: %.4f" % channel_mean(cal_ssim, hr01, bil))
    print("SSIM btwn real & fake: %.4f" % channel_mean(cal_ssim, hr01, fake))
    # polarity rescue check (train-gray-patch-batch.lua:673-680)
    if cfg.patch_based:
        img, psnr, inverted = polarity_rescue(hr01, fake)
        if inverted:
            _dump("fake_none_sample_reversed", img)
            print("PSNR btwn real & fake_reversed: %.4f" % psnr)


def run_eval(cfg, state, loader, args):
    """The `--eval` block of the JAX CLI: the train and test slices (and
    their EMA counterparts) in the reference's lines."""
    if not hasattr(loader, "load_batch"):
        print("eval requires an indexed/synthetic loader")
        return
    sets = args.eval_sets
    ts = cfg.test_file_set_start
    train_sets, test_sets = range(sets), range(ts, ts + sets)
    if cfg.variant == "gray-patch-batch-overlap":
        # the overlap variant's own eval scores bilinear vs naive-stitch vs
        # seam-stitch through the tiled pipeline
        # (train-gray-patch-batch-overlap.lua:423-424,453-454,703-704)
        def overlap(ema, sets, tag):
            net = inference_generator(cfg, state, ema=ema)
            sr = make_overlap_sr_fn(cfg, net, self_ensemble=args.self_ensemble,
                                    ensemble_batched=args.ensemble_batched)
            evaluate_overlap_slice(cfg, net, loader, sets, sr_fn=sr
                                   ).print_reference_style(tag)

        overlap(False, train_sets, "Train-set")
        overlap(False, test_sets, "Test-set")
        if state.g_ema is not None:
            overlap(True, test_sets, "Test-set-EMA")
        return

    def full(ema, sets, tag):
        net = inference_generator(cfg, state, ema=ema)
        gen = make_generator_fn(net, self_ensemble=args.self_ensemble,
                                ensemble_batched=args.ensemble_batched)
        evaluate_slice(cfg, gen, loader, sets, device=net.device
                       ).print_reference_style(tag)

    full(False, train_sets, "Train-set")
    full(False, test_sets, "Test-set")
    if state.g_ema is not None:
        full(True, train_sets, "Train-set-EMA")
        full(True, test_sets, "Test-set-EMA")


def dump_sample_of(cfg, loader, batch_fn):
    """ONE image in the LOADER range [0,1], all channels, for dump_samples:
    the loader's first file, or the first image of a fresh batch."""
    if hasattr(loader, "load_one"):
        return loader.load_one(1)
    batch = batch_fn(1, 0)
    if isinstance(batch, tuple):
        # device_augment (canvas, tops, lefts, flips): the first image's
        # drawn crop AND flip, so the sample is the trainHook crop for that
        # draw (raw [0,1]; gray/normalize happen inside dump_samples)
        canvas, tops, lefts, flips = batch
        t, le, fs = int(tops[0]), int(lefts[0]), cfg.fineSize
        sample = canvas[0, :, t:t + fs, le:le + fs]
        return sample[:, :, ::-1] if bool(flips[0]) else sample
    if cfg.device_preprocess:
        return batch[0]        # raw [0,1]; gray/normalize run in the step
    # host path: already gray-converted AND in the training range — map pm1
    # back to the loader range
    return (batch[0] + 1.0) * 0.5 if cfg.data_range == "pm1" else batch[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="gray-3",
                    help="one of the reference variants")
    ap.add_argument("--steps", type=int, default=None,
                    help="steps per epoch (default: ntrain/batchSize)")
    ap.add_argument("--scan", type=int, default=1,
                    help="K steps per call over one (K, B, ...) super-batch; "
                         "on a card one CUDA graph replay per chunk (epoch "
                         "math unchanged)")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--data-root", default=None,
                    help="the dataset's route: an image folder (rgb-full, "
                         "gray) or a directory of %%06d.jpg files (default: "
                         "the reference's CelebA paths)")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--textured", action="store_true",
                    help="texture-rich procedural fixture set (fixed seed "
                         "1234) where bilinear is beatable — the quality-"
                         "parity protocol data")
    ap.add_argument("--native-loader", action="store_true",
                    help="decode the indexed route with the committed C++ "
                         "loader (native/libdcgansr.so)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--eval", action="store_true", dest="do_eval")
    ap.add_argument("--eval-sets", type=int, default=2,
                    help="file_sets per eval slice")
    ap.add_argument("--samples-dir", default=None)
    ap.add_argument("--dp", action="store_true",
                    help="data-parallel over all local devices")
    ap.add_argument("--device-preprocess", action="store_true",
                    help="feed raw [0,1] images; grayscale-convert/normalize/"
                         "degrade run fused on the device (folder variants)")
    ap.add_argument("--device-augment", action="store_true",
                    help="feed raw loadSize canvases; the donkey hook's "
                         "random crop + hflip ALSO run on the device in the "
                         "train step (implies --device-preprocess; folder "
                         "variants)")
    ap.add_argument("--gan-weight", type=float, default=None, metavar="W",
                    help="scale on G's adversarial gradient (1.0 = parity; "
                         "0 = pure reconstruction CNN with --pixel-loss)")
    ap.add_argument("--pixel-loss", type=float, default=None, metavar="W",
                    help="add W * MSE(fake, real) to G's objective")
    ap.add_argument("--g-ema", type=float, default=None, metavar="D",
                    help="keep an EMA copy of G (decay D, e.g. 0.999)")
    ap.add_argument("--stage-ahead", action="store_true",
                    help="double-buffer the feed: build + copy chunk c+1 "
                         "while the device computes chunk c (pinned memory, "
                         "a copy stream). Hides host batch work and the "
                         "host-to-device copy behind compute; same batches "
                         "in the same order, so training math is unchanged")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute (fp32 master parameters)")
    ap.add_argument("--feed-bf16", action="store_true",
                    help="ship batches host->device as bfloat16; the step "
                         "upcasts them at entry, so only the input pixels "
                         "carry bf16 rounding")
    ap.add_argument("--compact-params", action="store_true",
                    help="2-D master-weight layout: Adam's foreach passes "
                         "run on 2-D conv masters and moments, which each "
                         "layer views as 4-D (ops/compact.py); checkpoints "
                         "hold that layout")
    ap.add_argument("--fast-ops", action="store_true",
                    help="sub-pixel/s2d conv rewrites: every k4s2p1 convT "
                         "becomes a k3s1p1 conv + pixel shuffle, every "
                         "k4s2p1 conv a space-to-depth + k3s1p1 conv "
                         "(exact; ops/fast.py)")
    ap.add_argument("--self-ensemble", type=int, default=1, metavar="N",
                    choices=(1, 2, 4, 8),
                    help="eval-time geometric self-ensemble: average G over "
                         "N dihedral transforms of the input "
                         "(infer/ensemble.py)")
    ap.add_argument("--ensemble-batched", action="store_true",
                    help="run the N ensemble members as ONE (N*B)-batch "
                         "generator call instead of N sequential ones")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the first CUDA device)")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="also write per-step metrics to this JSONL file")
    ap.add_argument("--log-every", type=int, default=1,
                    help="metric fetch/log cadence; >1 lets the host queue "
                         "steps ahead (a fetch waits for the device)")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace of the run")
    args = ap.parse_args(argv)
    from .core import MODELS
    if args.config in MODELS:
        sys.exit(f"cli --config {args.config}: training is not supported: "
                 "its discriminator and loss are not ported (upscale runs "
                 "its generator)")
    # a rank takes its own card (LOCAL_RANK) before pick_device reads it
    mesh = initialize_from_env(args.cpu) if args.dp and launched() else None
    lead = mesh is None or mesh.rank == 0
    device = pick_device(args.cpu)

    overrides = {}
    if args.bf16:
        overrides["compute_dtype"] = "bfloat16"
    if args.fast_ops:
        overrides["fast_ops"] = True
    if args.pixel_loss is not None:
        overrides["pixel_loss_weight"] = args.pixel_loss
    if args.gan_weight is not None:
        overrides["gan_weight"] = args.gan_weight
    if args.g_ema is not None:
        overrides["g_ema"] = args.g_ema
    if args.device_preprocess:
        overrides["device_preprocess"] = True
    if args.device_augment:
        overrides["device_augment"] = True
        overrides["device_preprocess"] = True
    if args.compact_params:
        overrides["compact_params"] = True
    cfg = get_config(args.config, **overrides)
    if args.seed is not None:
        cfg.manualSeed = args.seed
    if cfg.manualSeed is None:
        cfg.manualSeed = int(np.random.randint(1, 10001))  # train.lua:30
    print(f"config: {cfg}")
    print(f"Random Seed: {cfg.manualSeed}")

    loader, batch_fn = build_data(cfg, args)
    state = init_train_state(
        cfg, torch.Generator().manual_seed(cfg.manualSeed), device=device)

    start_epoch = 0
    if args.resume and args.checkpoint_dir:
        ep = latest_epoch(args.checkpoint_dir, cfg.name)
        if ep is not None:
            state = load_checkpoint(args.checkpoint_dir, cfg.name, ep, state,
                                    seed_missing_ema=True)
            start_epoch = ep
            print(f"resumed from epoch {ep}")

    epochs = args.epochs if args.epochs is not None else cfg.niter
    if args.steps is not None:
        steps = args.steps
    else:
        imgs = cfg.images_consumed_per_step
        ntrain = cfg.ntrain if math.isfinite(cfg.ntrain) else 1000
        steps = max(int(ntrain) // imgs, 1)

    logger = (MetricsLogger(jsonl_path=args.metrics_jsonl) if lead
              else MetricsLogger(stdout=False))
    step_fn = prepare = None
    if mesh is not None:
        step_fn = build_dp_train_step(cfg, mesh)
        multi_step_fn = (build_dp_multi_step(cfg, mesh) if args.scan > 1
                         else None)

        def prepare(b):
            # batch_dim 1 shards the B axis of a (K, B, ...) super-batch;
            # the canvas leaf (max ndim) decides, and a device_augment
            # tuple's (K, B) offset leaves shard on the same dimension
            leaves = b if isinstance(b, tuple) else (b,)
            return shard_batch(b, mesh,
                               batch_dim=max(x.dim() for x in leaves) - 4)

        print(f"data-parallel over {mesh.size} ranks")
    else:
        multi_step_fn = build_multi_step(cfg) if args.scan > 1 else None
    t0 = time.perf_counter()
    try:
        with profile_trace(args.profile_dir,
                           enabled=args.profile_dir is not None):
            state, _ = train_epochs(
                cfg, state, batch_fn, step_fn=step_fn, niter=epochs,
                steps_per_epoch=steps, prepare_batch=prepare,
                checkpoint_dir=args.checkpoint_dir if lead else None,
                logger=logger, log_every=args.log_every,
                scan_steps=args.scan, multi_step_fn=multi_step_fn,
                start_epoch=start_epoch,
                feed_dtype=torch.bfloat16 if args.feed_bf16 else None,
                stage_ahead=args.stage_ahead)
        if cfg.compact_params:
            # eval and the sample dumps take 4-D conv weights
            state = unpack_state(state, generator_spec(cfg),
                                 discriminator_spec(cfg))
        if args.do_eval and lead:
            run_eval(cfg, state, loader, args)
        if args.samples_dir and lead:
            # dump_samples takes ONE image in the LOADER range [0,1], all
            # channels; it applies the gray/pm1 conventions itself
            dump_samples(cfg, state, args.samples_dir,
                         dump_sample_of(cfg, loader, batch_fn))
    finally:
        logger.close()
        if hasattr(loader, "close"):
            loader.close()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if multi_step_fn is not None:
        print("graph launches: " + json.dumps(multi_step_fn.stats()))
    print("Total time: %.3f" % (time.perf_counter() - t0))
    print("kernel launches: " + json.dumps(launches_run(
        {**bulge.launches, **preprocess.launches}, multi_step_fn)))
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return state


if __name__ == "__main__":
    main()
