"""Inference paths: full-image SR, grid-patch SR, and overlap+stitch SR.

Port of dcgan_sr_tpu/infer/tiled.py.  Mirrors the reference's three
sample-making pipelines:
  full image:   netG:forward on the whole downsampled image (train-gray-3.lua:564-580)
  grid patches: extract -> batched G -> reassemble (train-gray-patch.lua:551-604)
  overlap:      225-tile extraction -> batched G -> naive + seam-cut stitches
                (train-gray-patch-batch-overlap.lua:377-704)

Everything runs eagerly on the generator's device — patch extraction,
per-patch box downsample, the batched generator, the naive stitch and the
batched seam DP (infer/seam_device.py); there is no jit and so nothing to
compile per shape.  The host replay of the seam DP (infer/seam.py) is kept
as its oracle.  `compute_dtype=torch.bfloat16` runs the generator in bf16
(models/network.py: fp32 in and out, the fused pair through the bf16 kernel);
the stitches see its fp32 output, as in the JAX package.

`mesh=` (a parallel.Mesh) on make_full_sr_fn and make_overlap_sr_fn shards
the images over the data-parallel ranks, as the JAX package's image
sharding does: every rank is handed the whole batch, runs the pipeline on
its contiguous slice (the image count must divide by the ranks), and the
outputs are all_gathered, so every rank returns the whole batch (the JAX
global output array).  BN statistics there are per image, per group or
running, so the generator needs no collective.

Spans (utils/profiling.py, on while a profiler runs): the batched
pipelines' stages `sr.extract` (tiles and their degrade), `sr.degrade`,
`sr.generator` (every generator call of the pipeline call), `sr.stitch` and
`sr.seam`, siblings with no span around the call.
"""

from __future__ import annotations

import torch

from ..image.ops import box_downsample2
from ..parallel.collectives import all_gather
from ..parallel.mesh import local_batch_slice
from ..image.patches import (
    extract_grid_patches,
    extract_overlap_patches,
    reassemble_grid_patches,
    stitch_overlap_naive,
)
from .seam import seam_stitch
from ..utils.profiling import span
from .seam_device import seam_stitch_device

# Tiles per generator call in the flat and grouped overlap pipelines.  One
# 64-image batch of 64x64 images (14,400 tiles) goes in one call; a served
# LR 256x256 image alone is 16,129 tiles whose widest activation is 2.1 GB,
# so eight of them go two at a time rather than as one 17 GB layer.
TILE_BUDGET = 32768


def _sharded(run, mesh):
    """`run` over this rank's contiguous slice of the images, the ranks'
    outputs (a tensor, or a dict of them) gathered in rank order."""
    if mesh is None:
        return run

    @torch.inference_mode()
    def sharded_run(images):
        n = images.shape[0]
        if n % mesh.size:
            raise ValueError(f"{n} images do not shard over {mesh.size} "
                             "ranks (pad the batch to a multiple)")
        out = run(images[local_batch_slice(n, mesh.size, mesh.rank)])
        if isinstance(out, dict):
            return {k: all_gather(v, mesh) for k, v in out.items()}
        return all_gather(out, mesh)

    return sharded_run


def overlap_pad_dim(d, patch, overlap):
    """Smallest overlap-legal even extent >= d: (d' - overlap) must divide by
    (patch - overlap) for the stride-overlap tiling
    (train-gray-patch-batch-overlap.lua:387-399) and d' must be even for the
    2x2 degrade. With q = patch - overlap even and overlap odd no even d'
    exists (d' = overlap mod q fixes its parity) — raise rather than loop."""
    q = patch - overlap
    d2 = max(d, patch)
    d2 += (q - (d2 - overlap) % q) % q
    if d2 % 2:
        if q % 2 == 0:
            raise ValueError(
                f"overlap geometry unsatisfiable: patchSize-overlap={q} is "
                f"even while overlap={overlap} is odd, so every legal tiling "
                "extent is odd and the 2x2 degrade cannot apply; adjust "
                "patchSize/overlap")
        d2 += q  # q odd: one step flips parity
    return d2


def lr_pad_dim(d, patch, overlap):
    """Smallest extent >= d a LOW-RES input can be padded to so that its 2x
    output extent is overlap-legal (the lr_input mode of make_overlap_sr_fn);
    returns the LR extent — the output extent is twice it."""
    return overlap_pad_dim(2 * d, patch, overlap) // 2


def _wrap_ensemble(gen, self_ensemble, ensemble_batched):
    if self_ensemble == 1:
        return gen
    from .ensemble import self_ensemble as wrap
    return wrap(gen, self_ensemble, batched=ensemble_batched)


def make_generator_fn(net, bn_eval=False, self_ensemble=1,
                      ensemble_batched=False, compute_dtype=None):
    """Returns gen(lr_batch) -> hr_batch, (B, nc, h, w) in/out.

    Default runs in train mode (batch statistics of the batch given) — the
    reference never switches its nets to evaluate mode.  `bn_eval=True`
    normalizes with the checkpoint's running statistics, the intent mode
    for single-image inference (PARITY.md).

    `self_ensemble=N` (2/4/8) averages the forward over N dihedral
    transforms of the input (infer/ensemble.py).  `ensemble_batched=True`
    runs the N members as ONE (N*B)-batch generator call instead of N calls
    (exact under bn_eval: see ensemble.py; square inputs only).
    `compute_dtype=torch.bfloat16` runs the generator in bf16 (fp32 out)."""
    stats = "running" if bn_eval else "pooled"

    def gen(lr):
        return net(lr, bn_stats=stats, compute_dtype=compute_dtype)

    return torch.inference_mode()(
        _wrap_ensemble(gen, self_ensemble, ensemble_batched))


def sr_full_image(gen_fn, img_hw):
    """Full-image 2x SR of one (H, W) or (C, H, W) image tensor; returns
    (hr_fake, lr) with the input's channel layout."""
    lr = box_downsample2(img_hw)
    if lr.dim() == 2:                      # (H, W) -> (1, 1, H, W)
        return gen_fn(lr[None, None])[0, 0], lr
    return gen_fn(lr[None])[0], lr


def sr_grid_patches(cfg, gen_fn, img_hw):
    """Non-overlapping patch SR with reassembly (train-gray-patch.lua:551-604).

    Works at the image's native (H, W) — H and W must be multiples of
    patchSize (the upscale tool pads-and-crops to guarantee this)."""
    h, w = img_hw.shape[-2], img_hw.shape[-1]
    hr_patches = extract_grid_patches(img_hw, cfg.patchSize)
    lr_patches = box_downsample2(hr_patches)
    fake = gen_fn(lr_patches[:, None])[:, 0]
    return reassemble_grid_patches(fake, h, w)


def sr_overlap_image(cfg, gen_fn, img_hw, *, both_seams=False,
                     device_seam=True):
    """Overlap-tile SR: returns dict with naive and seam-stitched outputs.

    device_seam=True runs the batched seam DP on the image's device
    (infer/seam_device.py, bit-identical in both modes); False uses the host
    NumPy replay.  Runs at the image's native (H, W): each dim must satisfy
    (dim - overlap) % (patch - overlap) == 0 (the upscale tool pads-and-crops
    to guarantee this).
    """
    patch, ov = cfg.patchSize, cfg.overlap
    fine = (img_hw.shape[-2], img_hw.shape[-1])
    hr_tiles = extract_overlap_patches(img_hw, patch, ov)
    lr_tiles = box_downsample2(hr_tiles)
    fake_tiles = gen_fn(lr_tiles[:, None])[:, 0]
    naive = stitch_overlap_naive(fake_tiles, fine, patch, ov)
    if device_seam:
        seam = seam_stitch_device(fake_tiles, fine, patch, ov,
                                  both_seams=both_seams)
    else:
        seam = torch.from_numpy(seam_stitch(
            fake_tiles.cpu().numpy(), fine, patch, ov,
            both_seams=both_seams)).to(img_hw.device)
    return {"tiles": fake_tiles, "naive": naive, "seam": seam}


def make_full_sr_fn(net, *, compute_dtype=None, mesh=None, bn_eval=False,
                    self_ensemble=1, ensemble_batched=False, lr_input=False):
    """Batched FULL-IMAGE SR of (N, nc, H, W) images on the net's device.

      lr_input=False (default) runs the reference's eval protocol
        (train-gray-3.lua:564-580): degrade 2x2-box internally, restore at
        the input's own (even) size — output matches the input shape.
      lr_input=True is TRUE upscaling at the generator's own scale: the
        batch is LOW-RES input fed straight to the generator, (N, nc, H, W)
        -> (N, nc, sH, sW), s = 2 for the seven variants' generators and 4
        for SRGAN's (core/config.py MODELS), whose output is in [-1, 1].

    Inputs and outputs are in the generator's own data range
    (cfg.data_range); callers own the conversion.

    BN statistics under train mode (`bn_eval=False`) are PER IMAGE: each
    image is normalized with its own statistics, as if it ran alone — the
    JAX package's vmap over batch-of-one calls, written out as a batch
    dimension.  A result is then independent of what it was batched with.
    `bn_eval=True` (running stats) is batch-independent by construction.

    `self_ensemble` / `ensemble_batched` as in make_generator_fn.  Under
    per-image statistics the batched form pools each image's N members: the
    members of image i are rows i, B+i, 2B+i, ... of the joint batch, so the
    images are moved next to their members and grouped.

    `compute_dtype=torch.bfloat16` runs the generator in bf16 (fp32 out).
    `mesh` shards the images over data-parallel ranks (module docstring).
    """
    cdt = compute_dtype              # the generator's compute dtype
    if bn_eval:
        gen = lambda lr: net(lr, bn_stats="running",      # noqa: E731
                             compute_dtype=cdt)
        gen = _wrap_ensemble(gen, self_ensemble, ensemble_batched)
    elif self_ensemble != 1 and ensemble_batched:
        def members_pooled(big, n_img):
            # (members*B, ...) member-major -> image-major, one group an image
            m = big.shape[0] // n_img
            by_img = big.reshape((m, n_img) + tuple(big.shape[1:])
                                 ).transpose(0, 1).reshape(big.shape)
            y = net(by_img, bn_stats="pooled", groups=n_img,
                    compute_dtype=cdt)
            return y.reshape((n_img, m) + tuple(y.shape[1:])
                             ).transpose(0, 1).reshape(y.shape)

        def gen(lr):
            n_img = lr.shape[0]
            return _wrap_ensemble(lambda big: members_pooled(big, n_img),
                                  self_ensemble, True)(lr)
    else:
        gen = lambda lr: net(lr, bn_stats="per_image",   # noqa: E731
                             compute_dtype=cdt)
        gen = _wrap_ensemble(gen, self_ensemble, False)

    @torch.inference_mode()
    def run(images):
        lr = images
        if not lr_input:
            with span("sr.degrade"):
                lr = box_downsample2(images)
        with span("sr.generator"):
            return gen(lr)

    return _sharded(run, mesh)


def make_overlap_sr_fn(cfg, net, *, compute_dtype=None, mesh=None, fine=None,
                       bn_eval=False, both_seams=False, self_ensemble=1,
                       ensemble_batched=False, flat_tiles=None,
                       lr_input=False):
    """Batched overlap SR of (N, H, W) images on the net's device -> dict of
    stacked naive and seam-stitched outputs (and the generator's tiles,
    (N, T, patch, patch)).  The whole pipeline — tile extraction, per-tile
    box downsample, the batched generator over N*L*L tiles, the naive stitch
    and the batched seam DP — runs on the device; nothing round-trips to the
    host (the reference crosses the device boundary once per image and
    stitches on the host, SURVEY.md §3.4).

    `fine` overrides the image size as (H, W) — both dims must satisfy
    (dim - overlap) % (patch - overlap) == 0; default cfg.fineSize square.
    `bn_eval` normalizes BN with running stats instead of per-image tile
    batch stats (see make_generator_fn).  `self_ensemble=N` averages each
    tile's SR over N dihedral transforms (infer/ensemble.py) before
    stitching — per-image BN batch stats are invariant under the group.
    `ensemble_batched=True` runs the N members as ONE (N*T)-tile generator
    call instead of N sequential ones (ensemble.py: exact under
    bn_eval/no-BN; the pooled-joint-batch variant under train-mode BN).

    `flat_tiles` flattens the generator call to ONE (N*T)-tile batch instead
    of the per-image pipeline.  Under `bn_eval` (running stats — no
    cross-tile coupling) this is EXACT, so it defaults on there; under
    train-mode BN it would pool statistics across images (different math
    from the reference's per-image 225-tile batches, overlap:427-431), so
    requesting it raises.  Default None = bn_eval.  Without it, each image's
    tiles are one pooled BN batch: the JAX package vmaps the per-image
    pipeline, here the generator takes the N*T tiles with `groups=N`
    (models/network.py), the fused pair included.  Either way the tiles go
    through the generator at most TILE_BUDGET at a time, whole images only.

    `lr_input=True` is TRUE 2x upscaling: images are (N, H/2, W/2) LOW-RES
    inputs and the output is (N, H, W) with `fine` = (H, W) the OUTPUT size.
    Instead of degrading internally (the reference's eval protocol,
    overlap:402-407, which every other mode mirrors), tiles are extracted
    from the LR image at HALF geometry (patch/2 at stride overlap/2).
    Because the 2x2 box degrade and the tile gather commute on the
    even-aligned tile grid, those LR tiles are BIT-IDENTICAL to the
    protocol's degraded HR tiles — the generator sees exactly its training
    regime.  Requires even patchSize and overlap.

    `compute_dtype=torch.bfloat16` runs the generator in bf16; its tiles come
    back in fp32 and are stitched in fp32.  `mesh` shards the images over
    data-parallel ranks (module docstring); every output is gathered.
    """
    patch, ov = cfg.patchSize, cfg.overlap
    fine = (cfg.fineSize, cfg.fineSize) if fine is None else tuple(fine)
    if flat_tiles is None:
        flat_tiles = bn_eval
    if flat_tiles and not bn_eval:
        raise ValueError(
            "flat_tiles requires bn_eval=True: a flat (N*T)-tile batch pools "
            "train-mode BN statistics across images, which is not the "
            "reference's per-image math")
    if lr_input and (patch % 2 or ov % 2):
        raise ValueError(
            "lr_input requires even patchSize and overlap (tiles are "
            f"extracted at half geometry); got {patch}/{ov}")
    # tile size / stride AS EXTRACTED from the input image: half geometry on
    # an LR input (no internal degrade), full geometry + degrade otherwise
    ep, eov = (patch // 2, ov // 2) if lr_input else (patch, ov)

    def gen_images(lr, **kw):
        """(n*T, 1, p/2, p/2) tiles of n whole images -> (n*T, 1, p, p)."""
        if bn_eval:
            return net(lr, bn_stats="running", compute_dtype=compute_dtype)
        return net(lr, bn_stats="pooled", compute_dtype=compute_dtype, **kw)

    def gen_tiles(lr, n):
        if self_ensemble == 1:
            return gen_images(lr, groups=n)
        if ensemble_batched and not bn_eval:
            # the members of one image pool with each other: group g of the
            # (members*n*T)-tile batch is (member g // n, image g % n), so
            # move each image's members together and group by image
            t = lr.shape[0] // n

            def joint(big):
                m = big.shape[0] // (n * t)
                by_img = big.reshape((m, n, t) + tuple(big.shape[1:])
                                     ).transpose(0, 1).reshape(big.shape)
                y = gen_images(by_img, groups=n)
                return y.reshape((n, m, t) + tuple(y.shape[1:])
                                 ).transpose(0, 1).reshape(y.shape)

            return _wrap_ensemble(joint, self_ensemble, True)(lr)
        return _wrap_ensemble(lambda x: gen_images(x, groups=n),
                              self_ensemble, ensemble_batched)(lr)

    @torch.inference_mode()
    def run(images):
        with span("sr.extract"):
            tiles = extract_overlap_patches(images, ep, eov)  # (N, T, ·, ·)
            if not lr_input:
                tiles = box_downsample2(tiles)
        n, t = tiles.shape[0], tiles.shape[1]
        members = self_ensemble if ensemble_batched else 1
        step = max(1, TILE_BUDGET // (t * members))
        with span("sr.generator"):
            fake = torch.cat([
                gen_tiles(tiles[i:i + step].reshape(
                    (-1, 1) + tuple(tiles.shape[2:])), min(step, n - i))[:, 0]
                for i in range(0, n, step)]).reshape(n, t, patch, patch)
        with span("sr.stitch"):
            naive = stitch_overlap_naive(fake, fine, patch, ov)
        with span("sr.seam"):
            seam = seam_stitch_device(fake, fine, patch, ov,
                                      both_seams=both_seams)
        return {"tiles": fake, "naive": naive, "seam": seam}

    return _sharded(run, mesh)
