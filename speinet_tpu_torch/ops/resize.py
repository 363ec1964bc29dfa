"""Integer-scale bicubic upsampling with PyTorch's semantics, NHWC
(port of `speinet_tpu/ops/resize.py`).

Keys kernel with A = -0.75, half-pixel source coordinates, border indices
clamped; the four taps accumulate in float32 and the result is rounded to
the input dtype after each axis, exactly as the JAX function does, so a
bf16 model rounds at the same two places on both sides.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_A = -0.75  # PyTorch / OpenCV bicubic coefficient


def _cubic_kernel(d: np.ndarray) -> np.ndarray:
    d = np.abs(d)
    return np.where(
        d <= 1.0,
        (_A + 2.0) * d**3 - (_A + 3.0) * d**2 + 1.0,
        np.where(d < 2.0, _A * d**3 - 5.0 * _A * d**2 + 8.0 * _A * d - 4.0 * _A,
                 0.0))


@functools.lru_cache(maxsize=None)
def _phase_taps(scale: int):
    """For each output phase r in [0, scale): (base offset, 4 weights).
    Output index scale*k + r samples source x = k + (2r + 1 - scale)/(2 scale)."""
    taps = []
    for r in range(scale):
        off = (2 * r + 1 - scale) / (2.0 * scale)
        base = int(np.floor(off))
        t = off - base
        w = _cubic_kernel(np.array([1.0 + t, t, 1.0 - t, 2.0 - t]))
        taps.append((base, tuple(float(v) for v in w)))
    return taps


def _upsample_axis(x: torch.Tensor, scale: int, axis: int) -> torch.Tensor:
    if scale == 1:
        return x
    n = x.shape[axis]
    first = x.narrow(axis, 0, 1)
    last = x.narrow(axis, n - 1, 1)
    xp = torch.cat([first, first, x, last, last], dim=axis).float()
    phases = []
    for base, w in _phase_taps(scale):
        s0 = base + 1      # xp index i holds source index i - 2
        acc = w[0] * xp.narrow(axis, s0, n)
        for j in range(1, 4):
            acc = acc + w[j] * xp.narrow(axis, s0 + j, n)
        phases.append(acc)
    out = torch.stack(phases, dim=axis + 1)
    shape = list(x.shape)
    shape[axis] = n * scale
    return out.reshape(shape).to(x.dtype)


def bicubic_upsample_nhwc(x: torch.Tensor, scale: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, H*scale, W*scale, C], matching
    `F.interpolate(mode='bicubic', align_corners=False)` on NCHW."""
    return _upsample_axis(_upsample_axis(x, scale, 1), scale, 2)
