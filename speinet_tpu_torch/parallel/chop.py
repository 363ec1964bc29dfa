"""Spatial 4-tile chopped forward (port of `speinet_tpu/parallel/chop.py`;
parity: inference_SPEINet.py:545-607).

The frame is cut into 4 overlapping quadrants that run as extra batch
entries of one forward; above `6 * min_size` pixels each quadrant recurses.
Under a process group the 4B tiles of a forward are spread over the ranks
when 4B divides by the group's size, as the JAX package's `tile_sharding`
spreads them over the dp mesh (chop.py:54; the reference dispatches the
quadrants over <= 4 GPUs, inference_SPEINet.py:569), and gathered before
they are merged; otherwise every rank runs all of them. H and W must be
even (size_must_mode 4 guarantees it, as in the reference).
"""

from __future__ import annotations

import torch

from speinet_tpu_torch.parallel.mesh import batch_slice, gather_batch, world


def chop_batch(x: torch.Tensor, shave: int = 20) -> torch.Tensor:
    """[B, ..., H, W] -> 4 overlapping tiles stacked on the batch axis,
    [4B, ..., H//2+shave, W//2+shave], in the order top-left, top-right,
    bottom-left, bottom-right (inference_SPEINet.py:557-562)."""
    h, w = x.shape[-2:]
    hs, ws = h // 2 + shave, w // 2 + shave
    return torch.cat([x[..., :hs, :ws], x[..., :hs, w - ws:],
                      x[..., h - hs:, :ws], x[..., h - hs:, w - ws:]], dim=0)


def chop_forward(forward_fn, x: torch.Tensor, shave: int = 20,
                 min_size: int = 160000) -> torch.Tensor:
    """x [B, T, C, H, W] -> [B, C, H, W] through forward_fn
    ([4B, T, C, hs, ws] -> [4B, C, hs, ws]): one batched forward of the four
    tiles below 6 * min_size pixels, else each tile recursed on. The
    forward of the four tiles is spread over the process group where one is
    open and the tile count divides by its size."""
    h, w = x.shape[-2:]
    tiles = chop_batch(x, shave=shave)
    # leaf when small enough, or when tiles would stop shrinking (their size
    # floors near 2 * shave), which would otherwise recurse forever
    shrinking = (h // 2 + shave < h) and (w // 2 + shave < w)
    if h * w < 6 * min_size or not shrinking:
        if tiles.shape[0] % world():
            y = forward_fn(tiles)
        else:
            y = gather_batch(forward_fn(tiles[batch_slice(tiles.shape[0])]))
    else:
        b = x.shape[0]
        y = torch.cat([chop_forward(forward_fn, tiles[i * b:(i + 1) * b], shave,
                                    min_size) for i in range(4)], dim=0)
    return chop_merge(y, h, w)


def chop_merge(y: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[4B, C, hs, ws] tiles of chop_batch -> [B, C, h, w]; each output
    quadrant comes from its own tile, the overlap discarded
    (inference_SPEINet.py:586-602)."""
    b = y.shape[0] // 4
    tl, tr, bl, br = y[:b], y[b:2 * b], y[2 * b:3 * b], y[3 * b:]
    top = torch.cat([tl[..., :h // 2, :w // 2],
                     tr[..., :h // 2, -(w - w // 2):]], dim=-1)
    bottom = torch.cat([bl[..., -(h - h // 2):, :w // 2],
                        br[..., -(h - h // 2):, -(w - w // 2):]], dim=-1)
    return torch.cat([top, bottom], dim=-2)
