"""The overlap pipeline's stitches, plain PyTorch, vectorized over tiles.

train-gray-patch-batch-overlap.lua:377-704 as committed: tiles of `patch`
pixels at stride `overlap` in row-major order; the naive stitch is last
writer wins; the seam stitch composites each tile against its left
neighbour (first row and interior tiles) or its top neighbour (first
column) along a minimum-error-boundary seam, and the canvas again takes
every pixel from the last tile that covers it.  The DP's ties break as the
script breaks them: the seam starts at the LAST minimum of the last row,
and the backtrack prefers staying, then +1, then -1.  Every operation is a
comparison, a minimum or one float32 addition, so the result is exact.
"""

from __future__ import annotations

import torch


def lines(extent, patch, overlap):
    return (extent - overlap) // (patch - overlap)


def owner(fine, patch, overlap, device):
    """(tile index, row in tile, column in tile) of each output pixel's
    last writer, each an (H, W) or broadcastable long tensor."""
    fh, fw = fine
    lh, lw = lines(fh, patch, overlap), lines(fw, patch, overlap)
    r = torch.arange(fh, device=device)
    c = torch.arange(fw, device=device)
    br = torch.clamp(r // overlap, max=lh - 1)
    bc = torch.clamp(c // overlap, max=lw - 1)
    return (br[:, None] * lw + bc[None, :], (r - br * overlap)[:, None],
            (c - bc * overlap)[None, :])


def gather(tiles, fine, patch, overlap):
    """(..., T, patch, patch) -> (..., H, W): every pixel from its owner."""
    ti, ro, co = owner(fine, patch, overlap, tiles.device)
    return tiles[..., ti, ro, co]


def vertical_seams(delta):
    """delta (N, P, V) -> 1-based seam columns (N, P) of each band."""
    n, p, v = delta.shape
    inf = torch.full((n, 1), float("inf"), device=delta.device,
                     dtype=delta.dtype)
    path = [delta[:, 0]]
    for a in range(1, p):
        prev = path[-1]
        lo = torch.cat([inf, prev[:, :-1]], 1)
        hi = torch.cat([prev[:, 1:], inf], 1)
        path.append(delta[:, a] + torch.minimum(torch.minimum(lo, prev), hi))
    last = path[-1]
    hit = last == last.min(1, keepdim=True).values
    idx = torch.arange(1, v + 1, device=delta.device)
    nb = torch.where(hit, idx, torch.zeros_like(idx)).max(1).values
    seam = [nb]
    for a in range(p - 2, -1, -1):
        row = path[a]

        def at(j):
            return row.gather(1, (j - 1).clamp(0, v - 1)[:, None])[:, 0]

        stay, down, up = at(nb), at(nb - 1), at(nb + 1)
        trio = torch.minimum(torch.minimum(stay, down), up)
        mid = torch.where(stay == trio, nb,
                          torch.where(up == trio, nb + 1, nb - 1))
        first = torch.where(row[:, 0] <= row[:, min(1, v - 1)], 1, 2)
        end = torch.where(row[:, v - 1] <= row[:, max(v - 2, 0)], v, v - 1)
        nb = torch.where(nb == 1, first, torch.where(nb == v, end, mid))
        seam.append(nb)
    return torch.stack(seam[::-1], 1)


def left_composite(cur, prev, patch, overlap):
    """cur, prev (N, P, P): cur composited against its left neighbour."""
    band = prev[:, :, patch - overlap:]
    k = vertical_seams((band - cur[:, :, :overlap]).abs())    # (N, P)
    col = torch.arange(patch, device=cur.device)[None, None, :]
    from_prev = torch.cat([band, torch.zeros_like(cur[:, :, overlap:])], 2)
    return torch.where(col < k[:, :, None], from_prev, cur)


def top_composite(cur, prev, patch, overlap):
    return left_composite(cur.transpose(1, 2), prev.transpose(1, 2), patch,
                          overlap).transpose(1, 2)


def seam_stitch(tiles, fine, patch, overlap):
    """(..., T, patch, patch) tiles -> (..., H, W), the committed stitch."""
    lw = lines(fine[1], patch, overlap)
    t = tiles.shape[-3]
    lead = tiles.shape[:-3]
    i = torch.arange(t, device=tiles.device)
    flat = tiles.reshape(-1, t, patch, patch)
    left_nb = flat[:, (i - 1).clamp(min=0)].reshape(-1, patch, patch)
    top_nb = flat[:, (i - lw).clamp(min=0)].reshape(-1, patch, patch)
    cur = flat.reshape(-1, patch, patch)
    left = left_composite(cur, left_nb, patch, overlap).reshape(flat.shape)
    top = top_composite(cur, top_nb, patch, overlap).reshape(flat.shape)
    row, col = (i // lw)[:, None, None], (i % lw)[:, None, None]
    comp = torch.where(col > 0, left, torch.where(row > 0, top, flat))
    return gather(comp.reshape(lead + (t, patch, patch)), fine, patch, overlap)
