"""Device-resident seam-cut stitching: every tile's DP seam at once.

Port of dcgan_sr_tpu/infer/seam_device.py.  The reference runs the
minimum-error-boundary DP sequentially per patch on the host
(overlap:457-694).  What makes it parallel: each patch's composite depends
only on the GENERATOR TILES of itself and its left/top neighbor — never on
the evolving canvas — and the canvas's last-writer-wins ordering reduces to
the same ownership gather as the naive stitch.  So:

  1. batched DP over all tiles at once (a Python loop over the `patch` rows,
     vectorized across every seam of every image), with the reference's exact
     tie-breaking (last-argmin seam start, stay/+1/-1 backtrack preference);
  2. per-patch composites via per-row masks;
  3. one ownership gather assembles the canvas.

Tiles may carry leading batch dimensions, (..., T, patch, patch): the JAX
package vmaps the per-image function, here the images ride along.  The DP is
comparisons, minima and one addition per cell in the JAX function's order, so
the result is bit-identical to it and to infer.seam.seam_stitch on the same
tiles, in both modes.
"""

from __future__ import annotations

import torch

from ..image.patches import _overlap_lines, gather_owned


def _dp_paths(delta):
    """delta: (N, P, V) -> cumulative min-path table (N, P, V)."""
    big = torch.full_like(delta[:, 0, :1], float("inf"))
    rows = [delta[:, 0]]
    for a in range(1, delta.shape[1]):
        prev = rows[-1]
        left = torch.cat([big, prev[:, :-1]], dim=-1)
        right = torch.cat([prev[:, 1:], big], dim=-1)
        rows.append(delta[:, a]
                    + torch.minimum(torch.minimum(left, prev), right))
    return torch.stack(rows, dim=1)


def _backtrack(path):
    """path: (N, P, V) -> 1-based seam indices (N, P), reference tie-breaks."""
    n, p, v = path.shape
    last = path[:, -1, :]
    eq = last == last.min(dim=-1, keepdim=True).values
    # LAST argmin in b order (overlap:516-520 overwrites on equality)
    pos = torch.arange(1, v + 1, device=path.device)
    nb = (eq * pos).max(dim=-1).values                    # 1-based
    out = [nb]
    for a in range(p - 2, -1, -1):
        row = path[:, a, :]

        def gather(idx):  # 1-based, clamped
            return row.gather(1, (idx - 1).clamp(0, v - 1)[:, None])[:, 0]

        at, below, above = gather(nb), gather(nb - 1), gather(nb + 1)
        # interior: prefer stay, then +1, then -1 (overlap:536-544)
        tri = torch.minimum(torch.minimum(at, below), above)
        interior = torch.where(at == tri, nb,
                               torch.where(above == tri, nb + 1, nb - 1))
        # nb == 1: stay if path[1] <= path[2] else 2 (overlap:523-528)
        lo = torch.where(row[:, 0] <= row[:, min(1, v - 1)], 1, 2)
        # nb == V: stay if path[V] <= path[V-1] else V-1 (overlap:529-534)
        hi = torch.where(row[:, v - 1] <= row[:, max(v - 2, 0)], v, v - 1)
        nb = torch.where(nb == 1, lo, torch.where(nb == v, hi, interior))
        out.append(nb)
    return torch.stack(out[::-1], dim=1)


def _left_composites(tiles, prev, patch, overlap):
    """Composite every tile against `prev`, its left neighbor: (N, P, P)."""
    delta = (prev[:, :, patch - overlap:] - tiles[:, :, :overlap]).abs()
    idx = _backtrack(_dp_paths(delta))      # (N, P) 1-based column counts
    cols = torch.arange(patch, device=tiles.device)[None, None, :]
    take_prev = cols < idx[:, :, None]      # first idx cols from prev
    prev_full = torch.nn.functional.pad(prev[:, :, patch - overlap:],
                                        (0, patch - overlap))
    return torch.where(take_prev, prev_full, tiles)


def _top_composites(tiles, prev, patch, overlap):
    """Composite every tile against `prev`, its top neighbor: the left
    composite of the transposed tiles, transposed back."""
    return _left_composites(tiles.transpose(1, 2), prev.transpose(1, 2),
                            patch, overlap).transpose(1, 2)


def seam_stitch_device(tiles, fine, patch, overlap, *, both_seams=False):
    """Seam stitch of (..., Lh*Lw, patch, patch) tiles -> (..., *fine) canvas.

    `fine` is an int (square, the reference case) or (H, W).  Matches
    infer.seam.seam_stitch exactly in BOTH modes: committed behavior
    (both_seams=False — interior patches take the left composite over their
    whole footprint) and intent mode (both_seams=True — interior patches
    take the left composite in the left overlap band, the top composite
    elsewhere; the evident intent of overlap:625-692).
    """
    lh, lw = _overlap_lines(fine, patch, overlap)
    n = lh * lw
    lead = tuple(tiles.shape[:-3])
    dev = tiles.device
    ar = torch.arange(n, device=dev)
    # neighbors within each image; the top one sits a patch-row earlier
    left_of = tiles[..., (ar - 1).clamp(min=0), :, :].reshape(-1, patch, patch)
    top_of = tiles[..., (ar - lw).clamp(min=0), :, :].reshape(-1, patch, patch)
    flat = tiles.reshape(-1, patch, patch)
    left = _left_composites(flat, left_of, patch, overlap)
    top = _top_composites(flat, top_of, patch, overlap)
    shape = lead + (n, patch, patch)
    left, top = left.reshape(shape), top.reshape(shape)

    xi = (ar // lw)[:, None, None]
    yi = (ar % lw)[:, None, None]
    if both_seams:
        # interior: left seam owns columns [0, overlap), top seam the rest
        band = (torch.arange(patch, device=dev) < overlap)[None, None, :]
        interior = torch.where(band, left, top)
        comp = torch.where((xi > 0) & (yi > 0), interior,
                           torch.where(yi > 0, left,
                                       torch.where(xi > 0, top, tiles)))
    else:
        # committed selection: (0,0) raw; row 0 -> left; col 0 -> top;
        # interior -> left (the left composite overwrites the top one)
        comp = torch.where(yi > 0, left, torch.where(xi > 0, top, tiles))

    # ownership gather (same last-writer map as the naive stitch)
    return gather_owned(comp, fine, patch, overlap)
