"""Minimum-error-boundary-cut seam stitching (image-quilting style DP).

The port's own copy of dcgan_sr_tpu/infer/seam.py (host numpy; the port
imports nothing of the JAX package).  Replicates the committed behavior of
train-gray-patch-batch-overlap.lua:457-694 bit-for-bit, including its
tie-breaking:

  * the seam start (last DP row/col) takes the LAST argmin in scan order
    (the Lua loop at overlap:516-520 overwrites on equality);
  * backtracking prefers staying at b, then b+1, then b-1 (overlap:536-544);
  * for interior patches (row>0 AND col>0) the reference computes and
    composites the TOP seam first, then computes the LEFT seam and composites
    it over the ENTIRE patch footprint (overlap:684-691) — fully overwriting
    the top-seam composite.  The committed result is therefore: first row ->
    left seams, first column -> top seams, interior -> left seams only.  We
    reproduce that exactly (it is what produced the reference's PSNR/SSIM
    numbers); the `both_seams` flag exposes the presumably-intended
    top+left behavior as an extension.

This is the sequential replay, the oracle for infer/seam_device.py (the
batched DP the pipelines run on the device); sr_overlap_image takes it with
device_seam=False.
"""

from __future__ import annotations

import numpy as np


def _vertical_seam(delta):
    """DP seam through a (patch, overlap) |delta| band, top row -> bottom row.

    Returns idx (patch,) of 1-based column choices per row, reference
    tie-breaking included.
    """
    P, V = delta.shape
    path = np.zeros_like(delta)
    path[0] = delta[0]
    for a in range(1, P):
        for b in range(V):
            lo, hi = max(b - 1, 0), min(b + 1, V - 1)
            path[a, b] = delta[a, b] + path[a - 1, lo:hi + 1].min()
    idx = np.zeros(P, np.int64)
    # last row: LAST argmin in b order (overlap:516-520)
    mn = path[P - 1].min()
    for b in range(V):
        if path[P - 1, b] == mn:
            idx[P - 1] = b + 1
    # backtrack with stay > +1 > -1 preference (overlap:522-545)
    for a in range(P - 2, -1, -1):
        nb = idx[a + 1]
        if nb == 1:
            idx[a] = 1 if path[a, 0] == min(path[a, 0], path[a, 1]) else 2
        elif nb == V:
            idx[a] = V if path[a, V - 1] == min(path[a, V - 1], path[a, V - 2]) else V - 1
        else:
            trio = min(path[a, nb - 1], path[a, nb - 2], path[a, nb])
            if path[a, nb - 1] == trio:
                idx[a] = nb
            elif path[a, nb] == trio:
                idx[a] = nb + 1
            else:
                idx[a] = nb - 1
    return idx


def _left_seam_composite(out, cur, prev, x, y, patch, overlap):
    """Composite patch (x,y) against its LEFT neighbor along a vertical seam."""
    delta = np.abs(prev[:, patch - overlap:patch] - cur[:, :overlap])
    idx = _vertical_seam(delta)
    r0, c0 = x * overlap, y * overlap
    for a in range(patch):
        k = idx[a]
        out[r0 + a, c0:c0 + k] = prev[a, patch - overlap:patch - overlap + k]
        out[r0 + a, c0 + k:c0 + patch] = cur[a, k:patch]


def _top_seam_composite(out, cur, prev, x, y, patch, overlap):
    """Composite patch (x,y) against its TOP neighbor along a horizontal seam."""
    delta = np.abs(prev[patch - overlap:patch, :] - cur[:overlap, :])
    idx = _vertical_seam(delta.T)  # transpose: same DP over columns
    r0, c0 = x * overlap, y * overlap
    for b in range(patch):
        k = idx[b]
        out[r0:r0 + k, c0 + b] = prev[patch - overlap:patch - overlap + k, b]
        out[r0 + k:r0 + patch, c0 + b] = cur[k:patch, b]


def seam_stitch(patches, fine, patch, overlap, *, both_seams=False):
    """Stitch (Lh*Lw, patch, patch) overlapping tiles into a `fine` image.

    `fine` is an int (square, the reference case) or (H, W) — rectangular
    canvases tile with independent line counts per axis, same seam rules.
    `both_seams=False` reproduces the reference as committed; True applies the
    top seam AND then the left seam restricted to the left overlap band (the
    evident intent of overlap:625-692).
    """
    patches = np.asarray(patches, np.float32)
    fh, fw = (fine, fine) if isinstance(fine, (int, np.integer)) else fine
    lh = (fh - overlap) // (patch - overlap)
    lw = (fw - overlap) // (patch - overlap)
    line = lw  # columns of patches per row (stride to the top neighbor)
    out = np.zeros((fh, fw), np.float32)
    for i in range(lh * lw):
        x, y = i // line, i % line
        cur = patches[i]
        r0, c0 = x * overlap, y * overlap
        if x == 0 and y == 0:
            out[r0:r0 + patch, c0:c0 + patch] = cur
        elif x == 0:
            _left_seam_composite(out, cur, patches[i - 1], x, y, patch, overlap)
        else:
            _top_seam_composite(out, cur, patches[i - line], x, y, patch, overlap)
            if y != 0:
                if both_seams:
                    # intent-mode: keep the top-seam composite outside the
                    # left overlap band
                    merged = out[r0:r0 + patch, c0:c0 + patch].copy()
                    _left_seam_composite(out, cur, patches[i - 1], x, y,
                                         patch, overlap)
                    out[r0:r0 + patch, c0 + overlap:c0 + patch] = \
                        merged[:, overlap:]
                else:
                    # committed behavior: left seam overwrites the whole patch
                    _left_seam_composite(out, cur, patches[i - 1], x, y,
                                         patch, overlap)
    return out
