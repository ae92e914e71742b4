"""The SR entries in plain float32: the overlap pipeline, full-image SR
and one request to the server.

Overlap (train-gray-patch-batch-overlap.lua:377-704): tiles of patchSize
at stride overlap from each image, each tile's 2x2 box mean, the generator
over all of an image's tiles with that image's batch statistics (or the
running statistics), then the naive and the seam stitch (seam.py).
Full image (train-gray-3.lua:564-580, true 2x): the generator on each LR
image with its own statistics.  A served request: the LR image's sides
edge-padded to the server's bucket, tiles at half geometry (the LR image
is the degraded HR image, so its tiles are the degraded HR tiles), the
running statistics, the seam stitch, the crop, and uint8 levels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import nets, seam
from .precision import exact_fp32, rounding


def overlap_tiles(images, patch, overlap):
    """(N, H, W) -> (N, T, patch, patch), row-major, stride overlap."""
    u = images.unfold(1, patch, overlap).unfold(2, patch, overlap)
    n, lh, lw = u.shape[:3]
    return u.reshape(n, lh * lw, patch, patch)


def generate_tiles(g_spec, g_params, lr_tiles, bn, precision, chunk=None):
    """(N, T, p, p) LR tiles -> (N, T, 2p, 2p) through G: each image's
    tiles one batch ("pooled"), or the running statistics ("running");
    `chunk` images at a time."""
    n, t = lr_tiles.shape[:2]
    chunk = chunk or n
    out = []
    with torch.no_grad(), exact_fp32():
        for i in range(0, n, chunk):
            x = lr_tiles[i:i + chunk].float()
            m = x.shape[0]
            y = nets.forward(g_spec, g_params, x.reshape(m * t, 1, *x.shape[2:]),
                             bn, groups=m if bn == "pooled" else None,
                             rnd=rounding(precision))
            out.append(y.reshape(m, t, *y.shape[2:]))
    return torch.cat(out)


def overlap_sr(g_spec, g_params, images, cfg, precision="fp32", chunk=8):
    """{"tiles", "naive", "seam"} of (N, H, W) images, the parity mode."""
    p, ov = cfg["patchSize"], cfg["overlap"]
    fine = tuple(images.shape[-2:])
    tiles = overlap_tiles(images.float(), p, ov)
    n, t = tiles.shape[:2]
    lr = F.avg_pool2d(tiles.reshape(n * t, 1, p, p), 2).reshape(
        n, t, p // 2, p // 2)
    fake = generate_tiles(g_spec, g_params, lr, "pooled", precision, chunk)
    return {"tiles": fake, "naive": seam.gather(fake, fine, p, ov),
            "seam": seam.seam_stitch(fake, fine, p, ov)}


def stitches(tiles, fine, cfg):
    """Both stitches of given tiles: (naive, seam)."""
    p, ov = cfg["patchSize"], cfg["overlap"]
    with torch.no_grad():
        return (seam.gather(tiles, fine, p, ov),
                seam.seam_stitch(tiles, fine, p, ov))


def full_sr(g_spec, g_params, lr_images, precision="fp32"):
    """(N, C, h, w) LR images -> (N, C, 2h, 2w), each with its own
    statistics, one image at a time."""
    out = []
    with torch.no_grad(), exact_fp32():
        for x in lr_images:
            out.append(nets.forward(g_spec, g_params, x[None].float(),
                                    "per_image", rnd=rounding(precision)))
    return torch.cat(out)


def ladder(cfg, max_size):
    """The server's LR bucket extents: from fineSize/2 in steps of about
    1.5x, each snapped up to the least extent whose 2x output the overlap
    tiling takes (an even extent e with (e - overlap) a multiple of
    patchSize - overlap), ending with max_size snapped."""
    p, ov = cfg["patchSize"], cfg["overlap"]
    q = p - ov

    def snap(d):
        e = max(2 * d, p)
        e += (q - (e - ov) % q) % q
        if e % 2:
            e += q
        return e // 2

    out, d = [], cfg["fineSize"] // 2
    while d < max_size:
        b = snap(d)
        if not out or b > out[-1]:
            out.append(b)
        d = int(d * 1.5)
    return out + [snap(max_size)]


def bucket(extent, buckets):
    for b in buckets:
        if b >= extent:
            return b
    raise ValueError(f"{extent} exceeds the largest bucket {buckets[-1]}")


def serve_request(g_spec, g_params, img, cfg, buckets, precision="fp32"):
    """One (h, w) [0,1] request as the server answers it in true-2x mode
    with running statistics and uint8 I/O: (2h, 2w) uint8 levels."""
    h, w = img.shape
    bh, bw = bucket(h, buckets), bucket(w, buckets)
    x = torch.round(img.float().clamp(0, 1) * 255.0) / 255.0
    x = F.pad(x[None, None], (0, bw - w, 0, bh - h), mode="replicate")[0, 0]
    p, ov = cfg["patchSize"], cfg["overlap"]
    tiles = overlap_tiles(x[None], p // 2, ov // 2)
    fake = generate_tiles(g_spec, g_params, tiles, "running", precision)
    out = seam.seam_stitch(fake, (2 * bh, 2 * bw), p, ov)[0, :2 * h, :2 * w]
    return torch.clamp(torch.round(out * 255.0), 0, 255).to(torch.uint8)
