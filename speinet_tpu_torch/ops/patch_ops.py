"""Patch extraction and the combined texture-transfer gather-fold
(port of `speinet_tpu/ops/patch_ops.py`: `unfold`, `_tiles_rows`,
`_shift9_flat`, `gather_fold3_nhwc`).

The transfer chain of the reference (SearchTransfer.py:36-46)
    T = fold(gather(unfold(ref, k=3s, stride=s, pad=s), idx), k=3s, s, pad=s)
is computed without the unfold: the 3x3 sub-tiles of every gathered patch
are s x s tiles of `ref` on a one-tile-padded grid, the overlap-add's nine
shifts are moved into the (small) index map, and the three pyramid scales
share one row gather because they use the same tile-grid indices. That row
gather is K10 (`kernels/gather.py::row_gather`), the port of the TPU kernel
written to replace it (`speinet_tpu/ops/pallas_gather.py::row_gather`); it
copies rows exactly, so the fold's sums are those of the indexing it took.
Every step is differentiable (K10's backward is a scatter-add), so the
texture transfer trains through it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from speinet_tpu_torch.kernels import row_gather

# transient bytes allowed for the gathered [chunk, 9L, W] rows; larger
# batches are gathered a few samples at a time
_GATHER_BUDGET = 2 << 30


def unfold(x: torch.Tensor, kernel_size: int, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """im2col [B, C, H, W] -> [B, C*k*k, L] (channel, kernel row, kernel col)."""
    return F.unfold(x, kernel_size, padding=padding, stride=stride)


def _tiles_rows(ref: torch.Tensor, s: int, nh: int, nw: int) -> torch.Tensor:
    """One-tile-padded s x s tile rows: [B, (nh+2)*(nw+2), s*s*C]."""
    b, _, _, c = ref.shape
    refp = F.pad(ref, (0, 0, s, s, s, s))
    t = refp.reshape(b, nh + 2, s, nw + 2, s, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, (nh + 2) * (nw + 2), s * s * c)


def _shift9_flat(index: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """Pre-shifted flat tile indices [B, L*9] (offset-minor). Shifts that
    leave the grid point at padded tile (0, 0), which is all zeros."""
    b = index.shape[0]
    ih = torch.div(index, nw, rounding_mode="floor").reshape(b, nh, nw)
    iw = (index % nw).reshape(b, nh, nw)
    tt = torch.arange(nh, device=index.device)[:, None]
    tw = torch.arange(nw, device=index.device)[None, :]
    flats = []
    for di in range(3):
        for dj in range(3):
            dh, dw = di - 1, dj - 1
            ihs = torch.roll(ih, (dh, dw), dims=(1, 2))
            iws = torch.roll(iw, (dh, dw), dims=(1, 2))
            f = (ihs + di) * (nw + 2) + (iws + dj)
            valid = ((tt - dh >= 0) & (tt - dh < nh)
                     & (tw - dw >= 0) & (tw - dw < nw))
            flats.append(torch.where(valid[None], f, torch.zeros_like(f)))
    return torch.stack(flats, dim=3).reshape(b, nh * nw * 9)


def gather_fold3_nhwc(ref1: torch.Tensor, ref2: torch.Tensor,
                      ref3: torch.Tensor, index: torch.Tensor):
    """The three texture-transfer gather-folds in one row gather.

    ref1/ref2/ref3: the sharp pyramid at strides 4/2/1 ([B, 4H, 4W, C1],
    [B, 2H, 2W, C2], [B, H, W, C3]); index: [B, H*W] argmax positions on the
    lv3 grid. Returns (T3, T2, T1); the caller divides by 9."""
    b, nh, nw, c3 = ref3.shape
    l = nh * nw
    if index.shape[-1] != l:
        raise ValueError(f"index holds {index.shape[-1]} positions, "
                         f"the lv3 grid {l}")
    c2, c1 = ref2.shape[-1], ref1.shape[-1]
    w3, w2 = c3, 4 * c2
    rows = torch.cat([_tiles_rows(ref3, 1, nh, nw),
                      _tiles_rows(ref2, 2, nh, nw),
                      _tiles_rows(ref1, 4, nh, nw)], dim=-1)
    flat = _shift9_flat(index.long(), nh, nw)
    per_sample = 9 * l * rows.shape[-1] * rows.element_size()
    cb = max(1, min(b, _GATHER_BUDGET // max(per_sample, 1)))

    def fold(cols: torch.Tensor, s: int, c: int) -> torch.Tensor:
        n = cols.shape[0]
        t = cols.sum(dim=3).reshape(n, nh, nw, s, s, c)
        return t.permute(0, 1, 3, 2, 4, 5).reshape(n, nh * s, nw * s, c)

    outs = []
    for i in range(0, b, cb):
        n = min(cb, b - i)
        g = row_gather(rows[i:i + cb], flat[i:i + cb]).reshape(n, nh, nw, 9, -1)
        # one split (its backward is one concatenation of the three scales'
        # gradients, not three full-width zero-padded copies)
        g3, g2, g1 = g.split((w3, w2, g.shape[-1] - w3 - w2), dim=-1)
        outs.append((fold(g3, 1, c3), fold(g2, 2, c2), fold(g1, 4, c1)))
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat([o[k] for o in outs]) for k in range(3))
