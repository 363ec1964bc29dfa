"""Inputs made from the seed: a pool of synthetic frames drawn on the card,
held in host memory, and the sharp labels of a video.

The frames follow the pattern the repository's chip smoke test uses
(smooth moving sinusoids plus per-pixel noise), each with its own phases;
the blurred frame is the mean of seven horizontal shifts of the sharp
one."""

from __future__ import annotations

import numpy as np
import torch


def frame_pool(n: int, h: int, w: int, seed: int, device, chunk: int = 8):
    """(sharp, blurred): two lists of n uint8 [h, w, 3] numpy frames."""
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    sharp, blurred = [], []
    for i0 in range(0, n, chunk):
        k = min(chunk, n - i0)
        ph = torch.rand((k, 3), generator=g, device=device) * 6.2832
        base = (127 + 70 * torch.sin(xx / 37.0 + ph[:, 0, None, None])
                * torch.cos(yy / 29.0 + ph[:, 1, None, None])
                + 30 * torch.sin((xx + yy) / 11.0 - ph[:, 2, None, None]))
        img = torch.stack([base, 0.9 * base + 10, 0.8 * base + 20], dim=-1)
        img = img + 6 * torch.randn((k, h, w, 1), generator=g, device=device)
        gt = img.clamp(0, 255).to(torch.uint8)
        blur = torch.stack([torch.roll(gt, s, dims=2).float() for s in range(-3, 4)]
                           ).mean(dim=0).to(torch.uint8)
        sharp += list(gt.cpu().numpy())
        blurred += list(blur.cpu().numpy())
    return sharp, blurred


def sharp_labels(n: int, ratio: float, rng: np.random.Generator) -> np.ndarray:
    """GoProRS's labels with a fixed count: the last frame sharp (its
    generator forces the video's end sharp) and round(ratio n) - 1 others
    at random places, so every seed restores the same mix of sharp and
    blurred frames in another order."""
    labels = np.zeros(n, np.int64)
    labels[n - 1] = 1
    k = max(int(round(ratio * n)) - 1, 0)
    labels[rng.choice(n - 1, size=k, replace=False)] = 1
    return labels
