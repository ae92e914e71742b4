"""Patch decomposition: grid (non-overlapping) and overlapping extraction.

Port of dcgan_sr_tpu/image/patches.py.  The reference turns one 64x64 image
into 64 8x8 patches with triple host loops (train-gray-patch.lua:267-274) and
reassembles the same way (:588-596); the overlap variant extracts 225 patches
at stride=overlap (train-gray-patch-batch-overlap.lua:387-399) and
naive-stitches last-writer-wins (:434-447).  Here both are reshapes and
gathers on the tensor's device: the index tables are numpy, made once per
geometry, and moved to the device once.

Patch index convention (row-major, reference `i` 1-based):
  grid:    block_row = (i-1) // P, block_col = (i-1) %  P, P = fine/patch
  overlap: x_index   = (i-1) // L, y_index   = (i-1) %  L, L = (fine-ov)/(patch-ov)
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def extract_grid_patches(x, patch):
    """(..., H, W) -> (..., P*P, patch, patch), row-major blocks."""
    h, w = x.shape[-2], x.shape[-1]
    ph, pw = h // patch, w // patch
    lead = tuple(x.shape[:-2])
    y = x.reshape(lead + (ph, patch, pw, patch))
    y = y.movedim(-2, -3)  # (..., ph, pw, patch, patch)
    return y.reshape(lead + (ph * pw, patch, patch))


def reassemble_grid_patches(p, h, w):
    """Inverse of extract_grid_patches: (..., P*P, patch, patch) -> (..., H, W)."""
    patch = p.shape[-1]
    ph, pw = h // patch, w // patch
    lead = tuple(p.shape[:-3])
    y = p.reshape(lead + (ph, pw, patch, patch))
    y = y.movedim(-2, -3)  # (..., ph, patch, pw, patch)
    return y.reshape(lead + (h, w))


def _hw(fine):
    """Normalize a size argument: int -> square, (H, W) tuple -> itself."""
    if isinstance(fine, (int, np.integer)):
        return (int(fine), int(fine))
    return tuple(int(d) for d in fine)


def overlap_grid(fine, patch, overlap):
    """(lines_per_row_of_patches..., total).  `fine` may be an int (square,
    the reference case: 15 lines, 225 patches for 64/8/4) or (H, W)."""
    lh, lw = _overlap_lines(fine, patch, overlap)
    if isinstance(fine, (int, np.integer)):
        return lh, lh * lw
    return (lh, lw), lh * lw


def _overlap_lines(fine, patch, overlap):
    fh, fw = _hw(fine)
    return ((fh - overlap) // (patch - overlap),
            (fw - overlap) // (patch - overlap))


@functools.lru_cache(maxsize=256)
def _tables(kind, fine, patch, overlap, device):
    """Index tables of one geometry as int64 tensors on `device`."""
    if kind == "extract":
        lh, lw = _overlap_lines(fine, patch, overlap)
        arrs = (np.arange(lh)[:, None] * overlap + np.arange(patch)[None, :],
                np.arange(lw)[:, None] * overlap + np.arange(patch)[None, :])
    else:
        pi, off_r, off_c = _ownership(fine, patch, overlap)
        arrs = (pi, off_r[:, None], off_c[None, :])
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)
                 for a in arrs)


def extract_overlap_patches(x, patch, overlap):
    """(..., H, W) -> (..., Lh*Lw, patch, patch) at stride=overlap
    (overlap:387-399).

    NOTE the reference's stride is `overlap` itself (4), giving
    L = (fine-overlap)/(patch-overlap) = 15 rows of patches for 64/8/4.
    Rectangular inputs tile with independent line counts per axis.
    """
    fine = (x.shape[-2], x.shape[-1])
    idx_r, idx_c = _tables("extract", fine, patch, overlap, x.device)
    lh, lw = idx_r.shape[0], idx_c.shape[0]
    rows = x[..., idx_r, :]                 # (..., lh, patch, W)
    tiles = rows[..., idx_c]                # (..., lh, patch, lw, patch)
    tiles = tiles.movedim(-2, -3)           # (..., lh, lw, patch, patch)
    return tiles.reshape(tuple(x.shape[:-2]) + (lh * lw, patch, patch))


def _ownership(fine, patch, overlap):
    """Last-writer ownership map: per output pixel, (patch index, in-patch
    row offset, col offset) of the row-major last patch covering it."""
    fh, fw = _hw(fine)
    lh, lw = _overlap_lines(fine, patch, overlap)
    r = np.arange(fh)
    c = np.arange(fw)
    br = np.minimum(r // overlap, lh - 1)
    bc = np.minimum(c // overlap, lw - 1)
    off_r = r - br * overlap
    off_c = c - bc * overlap
    pi = br[:, None] * lw + bc[None, :]     # (fh, fw) patch index
    return pi, off_r, off_c


def gather_owned(patches, fine, patch, overlap):
    """patches[..., pi, off_r, off_c] with the ownership map of the geometry:
    the one gather behind both stitches."""
    pi, off_r, off_c = _tables("own", _hw(fine), patch, overlap,
                               patches.device)
    return patches[..., pi, off_r, off_c]


def stitch_overlap_naive(patches, fine, patch, overlap):
    """Last-writer-wins placement in patch order (overlap:434-447).

    Later patches (larger i, i.e. larger row then larger col) overwrite the
    overlap bands of earlier ones.  Because writes happen in row-major patch
    order, each output pixel is owned by the patch with the largest (x_index,
    y_index) covering it — which is the patch whose window starts closest to
    the pixel.  We replay the writes as one gather from the last writer.
    `fine` may be an int (square) or (H, W).
    """
    return gather_owned(patches, fine, patch, overlap)
