"""Dataset-wide evaluation harness — the reference's parity yardstick (port
of dcgan_sr_tpu/evaluation/harness.py).

Reproduces train-gray-3.lua:354-535 (SURVEY.md §3.5): over fixed dataset
slices, per batch:
  load+scale -> 2x box downsample -> bilinear upscale control -> G forward ->
  per-image PSNR and SSIM for BOTH generator and bilinear vs ground truth,
  accumulated into slice means.

Slices: train = file_sets [0, ntrain/100); test = file_sets from
cfg.test_file_set_start (2000, or 10000 for the patch-batch protocols).  The
patch-batch protocol evaluates with patch reassembly
(train-gray-patch-batch.lua:365-367,487-489) and adds the polarity rescue:
PSNR < 13 dB -> score 1-x instead (:673-680).

Each batch's pipeline (degrade, bilinear control, generator with per-batch
BN statistics, PSNR and SSIM sums) runs on the device without a host sync;
the host reads back the four (overlap: six) sums once per batch, as the JAX
package's one jitted program per batch does.

The generator that eval runs is an inference copy of the trained one
(`inference_generator`): fp32 (JAX's eval passes no compute dtype, even
after bf16 training), pooled statistics of each eval batch (JAX's train-mode
BN), and the fused pair (ops/bulge.py), so gray-3's layers 3-4 run through
the bulge kernel on a card.  The overlap eval goes through
infer/tiled.py make_overlap_sr_fn, each image's tiles one BN batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..image.ops import box_downsample2, resize_bilinear
from ..image.patches import extract_grid_patches, reassemble_grid_patches
from ..metrics import cal_psnr, cal_psnr_batch, cal_ssim_batch


@dataclasses.dataclass
class EvalResult:
    psnr_bilinear: float
    psnr_generator: float
    ssim_bilinear: float
    ssim_generator: float
    n_images: int

    def print_reference_style(self, tag="Train-set", log_fn=print):
        n = self.n_images
        log_fn(f"[{tag}] PSNR btwn real_none & real_bilinear: "
               f"{self.psnr_bilinear:.8f}, train-Size: {n}")
        log_fn(f"[{tag}] PSNR btwn real_none & fake_none: "
               f"{self.psnr_generator:.8f}, train-Size: {n}")
        log_fn(f"[{tag}] SSIM btwn real_none & real_bilinear: "
               f"{self.ssim_bilinear:.8f}, train-Size: {n}")
        log_fn(f"[{tag}] SSIM btwn real_none & fake_none: "
               f"{self.ssim_generator:.8f}, train-Size: {n}")


@dataclasses.dataclass
class OverlapEvalResult:
    """Bilinear control vs naive last-writer-wins stitch vs seam-cut stitch —
    the overlap variant's defining comparison
    (train-gray-patch-batch-overlap.lua:423-424,453-454,703-704)."""
    psnr_bilinear: float
    psnr_naive: float
    psnr_seam: float
    ssim_bilinear: float
    ssim_naive: float
    ssim_seam: float
    n_images: int

    def print_reference_style(self, tag="Test-set", log_fn=print):
        n = self.n_images
        log_fn(f"[{tag}] PSNR btwn real_none & real_bilinear: "
               f"{self.psnr_bilinear:.8f}, train-Size: {n}")
        log_fn(f"[{tag}] PSNR btwn real_none & fake_none: "
               f"{self.psnr_naive:.8f}, train-Size: {n}")
        log_fn(f"[{tag}] PSNR btwn real_none & fake_none_overlap: "
               f"{self.psnr_seam:.8f}, train-Size: {n}")
        log_fn(f"[{tag}] SSIM btwn real_none & real_bilinear: "
               f"{self.ssim_bilinear:.8f}, train-Size: {n}")
        log_fn(f"[{tag}] SSIM btwn real_none & fake_none: "
               f"{self.ssim_naive:.8f}, train-Size: {n}")
        log_fn(f"[{tag}] SSIM btwn real_none & fake_none_overlap: "
               f"{self.ssim_seam:.8f}, train-Size: {n}")


def inference_generator(cfg, state, *, ema=False):
    """The eval copy of a TrainState's G (train/step.py): a fused, frozen
    fp32 models.Network on the state's device, from G's parameters (or, with
    `ema`, its EMA copy) and BN running statistics."""
    from ..models import Network, generator_spec
    from ..train.step import _tree_like

    params, bn_state = state.g.trees()
    if ema:
        params = _tree_like(state.g, state.g_ema)
    return Network(generator_spec(cfg), params, bn_state,
                   device=state.g.device)


def _load(loader, file_set, batch_size, device):
    return torch.from_numpy(np.ascontiguousarray(
        loader.load_batch(file_set, batch_size), np.float32)).to(device)


def evaluate_overlap_slice(cfg, net, loader, file_sets, *, batch_size=None,
                           bn_eval=False, sr_fn=None, device=None):
    """Mean PSNR/SSIM of bilinear / naive-stitch / seam-stitch over the given
    file_set indices, through the on-device overlap pipeline (extract
    overlapping tiles -> batched G -> naive + seam-DP stitch,
    infer/tiled.make_overlap_sr_fn(cfg, net, bn_eval=)).  Grayscale protocol
    (nc=1), like the reference.

    `sr_fn(hr (B, H, W)) -> {"naive", "seam"}` overrides the pipeline (reuse
    across slices); `device` defaults to the net's.

    `batch_size` defaults to cfg.batchSize: the reference addresses files as
    file_num = file_set * batchSize + k (overlap:247), so the file_set
    indices only name the protocol's slices when the batch matches."""
    from ..infer.tiled import make_overlap_sr_fn

    batch_size = batch_size or cfg.batchSize
    device = torch.device(device if device is not None else net.device)
    sr = sr_fn if sr_fn is not None else make_overlap_sr_fn(
        cfg, net, bn_eval=bn_eval)
    fine = cfg.fineSize
    tot = np.zeros(6)
    n = 0
    with torch.inference_mode():
        for fs in file_sets:
            hr = _load(loader, fs, batch_size, device)[:, 0]   # (B, H, W)
            out = sr(hr)
            bil = resize_bilinear(box_downsample2(hr), fine, fine)
            imgs = (bil, out["naive"], out["seam"])
            sums = torch.stack(
                [cal_psnr_batch(hr, img).sum() for img in imgs]
                + [cal_ssim_batch(hr, img).sum() for img in imgs])
            tot += sums.double().cpu().numpy()
            n += int(hr.shape[0])
    return OverlapEvalResult(
        psnr_bilinear=tot[0] / n, psnr_naive=tot[1] / n, psnr_seam=tot[2] / n,
        ssim_bilinear=tot[3] / n, ssim_naive=tot[4] / n, ssim_seam=tot[5] / n,
        n_images=n)


def _score(metric, nc, ref, img):
    # (B, H, W) single-channel protocol (the reference's, gray variants);
    # multi-channel (B, C, H, W): per-channel metric averaged over C (the
    # reference defines no RGB protocol — train.lua prints none)
    if nc == 1:
        return metric(ref, img).sum()
    b, c = ref.shape[0], ref.shape[1]
    flat = metric(ref.reshape((b * c,) + tuple(ref.shape[2:])),
                  img.reshape((b * c,) + tuple(img.shape[2:])))
    return flat.reshape(b, c).mean(dim=1).sum()


def _eval_batch(cfg, gen, hr, with_ssim):
    """The four sums of one batch hr (B, nc, H, W) in [0,1], on its device."""
    fine, patch = cfg.fineSize, cfg.patchSize
    nc = cfg.nc
    pm1 = cfg.data_range == "pm1"
    hr2d = hr[:, 0] if nc == 1 else hr          # (B,H,W) or (B,C,H,W)
    # pm1 variants (rgb-full, gray): the generator trains on [-1,1] data
    # (trainHook mul(2):add(-1), donkey_folder.lua:69) and the reference's
    # eval feeds it the SAME normalized stream (train-gray.lua:325-385). G
    # is driven in its training range, then everything maps back to [0,1]
    # for scoring so the bilinear control and the cross-variant table stay
    # comparable.
    net_in = hr2d * 2.0 - 1.0 if pm1 else hr2d
    lr = box_downsample2(net_in)
    bil = resize_bilinear(lr, fine, fine)
    if cfg.patch_based:
        tiles = extract_grid_patches(net_in, patch)
        b, p2, p, _ = tiles.shape
        lr_tiles = box_downsample2(tiles).reshape(b * p2, 1, p // 2, p // 2)
        fk = gen(lr_tiles)
        fake = reassemble_grid_patches(fk[:, 0].reshape(b, p2, p, p),
                                       fine, fine)
    else:
        fk = gen(lr[:, None] if nc == 1 else lr)
        fake = fk[:, 0] if nc == 1 else fk
    if pm1:
        bil = (bil + 1.0) * 0.5
        fake = (fake + 1.0) * 0.5
    out = [_score(cal_psnr_batch, nc, hr2d, bil),
           _score(cal_psnr_batch, nc, hr2d, fake)]
    if with_ssim:
        out += [_score(cal_ssim_batch, nc, hr2d, bil),
                _score(cal_ssim_batch, nc, hr2d, fake)]
    else:
        out += [hr.new_zeros(()), hr.new_zeros(())]
    return torch.stack(out)


def evaluate_slice(cfg, gen, loader, file_sets, *, batch_size=None,
                   with_ssim=True, device=None):
    """Mean PSNR/SSIM over the given file_set indices.

    loader.load_batch(file_set, batch_size) -> (B, nc, H, W) in [0,1].  For
    patch variants the generator runs per patchSize tile and the image is
    reassembled before scoring (train-gray-patch-batch.lua:417-442).
    `gen` is a models.Network (run with pooled statistics of each batch,
    as infer/tiled.make_generator_fn does) or any gen(lr_batch) -> hr_batch
    (infer/tiled.make_generator_fn with a self-ensemble, a stand-in in a
    test); `device` defaults to the Network's and is required otherwise.
    `n_images` counts the rows actually read: a short final batch does not
    skew the means.
    """
    from ..infer.tiled import make_generator_fn

    if isinstance(gen, torch.nn.Module):
        device = gen.device if device is None else device
        gen = make_generator_fn(gen)
    if device is None:
        raise ValueError("device= is required with a generator function")
    device = torch.device(device)
    batch_size = batch_size or cfg.batchSize
    tot = np.zeros(4)
    n = 0
    with torch.inference_mode():
        for fs in file_sets:
            hr = _load(loader, fs, batch_size, device)   # (B, nc, H, W)
            tot += _eval_batch(cfg, gen, hr, with_ssim).double().cpu().numpy()
            n += int(hr.shape[0])
    return EvalResult(psnr_bilinear=tot[0] / n, psnr_generator=tot[1] / n,
                      ssim_bilinear=tot[2] / n, ssim_generator=tot[3] / n,
                      n_images=n)


def polarity_rescue(real_hw, fake_hw, threshold=13.0):
    """train-gray-patch-batch.lua:673-680: if PSNR < 13 dB, try 1-x.

    Returns (image, psnr, inverted?)."""
    real, fake = torch.as_tensor(real_hw), torch.as_tensor(fake_hw)
    p = float(cal_psnr(real, fake))
    if p < threshold:
        inv = 1.0 - fake
        return inv, float(cal_psnr(real, inv)), True
    return fake, p, False
