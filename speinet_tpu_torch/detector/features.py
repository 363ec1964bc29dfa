"""Sharpness-prior focus measures of a batch of frames (port of
`speinet_tpu/detector/features.py`; parity: the six per-frame measures of
LD_detector/LD_detector_gopros_train.py:118-194, duplicated at
inference_SPEINet.py:54-189):

  LAP1: 8-neighbour Laplacian, squared L2 pool
  MIS3: 9-kernel centre-minus-neighbour |sum|, L1 pool
  WAV1: db6 level-1 detail-coefficient |sum|
  GRA7: Sobel magnitude minus its local mean, squared L2 pool
  STA3: frame minus its k x k mean, squared L2 pool
  DCT3: 4x4 +- block kernel, squared L1 pool

Pooling: torch `lp_pool2d(x, p, k)` is (sum over the k x k window of x^p)
^ (1/p) with stride k and no absolute value. The reference squares every L2
pool (removing the root) and L1-pools only non-negative inputs, so window
sums reproduce it exactly.

The small convolutions run as shifted slices multiplied and summed in
float32, so the card computes what the CPU does (a cuDNN convolution would
take TF32 by default).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from speinet_tpu_torch.ops.wavelet import dwt2_db6_detail

FOCUS_FEATURE_NAMES = ("lap1", "mis3", "wav1", "gra7", "sta3", "dct3")

_GRAY = (0.2989, 0.587, 0.114)   # torchvision Grayscale

_SOBEL = np.stack([
    np.array([[1, 0, -1], [2, 0, -2], [1, 0, -1]], np.float32),
    np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], np.float32),
])
_LAP8 = np.array([[1, 1, 1], [1, -8, 1], [1, 1, 1]], np.float32)
_DCT = np.array([[1, 1, -1, -1], [1, 1, -1, -1],
                 [-1, -1, 1, 1], [-1, -1, 1, 1]], np.float32)


def _mis3_bank() -> np.ndarray:
    """9 kernels: centre 1, one neighbour -1 each (the centre kernel zero)."""
    bank = np.zeros((9, 3, 3), np.float32)
    for i in range(9):
        bank[i, 1, 1] = 1.0
        bank[i, i // 3, i % 3] -= 1.0
    bank[4] = 0.0
    return bank


def _conv1(x: torch.Tensor, k: np.ndarray, padding: int) -> torch.Tensor:
    """Cross-correlation of x [B, 1, H, W] with k [kh, kw] or [O, kh, kw],
    zero padding -> [B, O, H', W'] float32."""
    kk = np.asarray(k, np.float32)
    if kk.ndim == 2:
        kk = kk[None]
    _, kh, kw = kk.shape
    xp = F.pad(x, (padding,) * 4)
    ho, wo = xp.shape[2] - kh + 1, xp.shape[3] - kw + 1
    outs = []
    for ko in kk:
        acc = torch.zeros((x.shape[0], 1, ho, wo), dtype=x.dtype, device=x.device)
        for di in range(kh):
            for dj in range(kw):
                if ko[di, dj] != 0.0:
                    acc = acc + xp[:, :, di:di + ho, dj:dj + wo] * float(ko[di, dj])
        outs.append(acc)
    return torch.cat(outs, dim=1)


def _avg_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """torch avg_pool2d(kernel=k, padding=k//2, stride=1): zero padding,
    divisor k*k everywhere; the box sum taken separably."""
    p = k // 2
    xp = F.pad(x, (p, p, p, p))
    h, w = x.shape[-2:]
    rows = sum(xp[..., di:di + h, :] for di in range(k))
    return sum(rows[..., dj:dj + w] for dj in range(k)) / float(k * k)


def _sum_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping k x k window sums (the lp_pool building block)."""
    b, c, h, w = x.shape
    hh, ww = h // k, w // k
    x = x[:, :, :hh * k, :ww * k].reshape(b, c, hh, k, ww, k)
    return x.sum(dim=(3, 5))


def _lp2_sq_mean(x: torch.Tensor, k: int) -> torch.Tensor:
    """mean(lp_pool2d(x, 2, k) ** 2) == mean of the window sums of x^2."""
    return _sum_pool(x * x, k).mean(dim=(1, 2, 3))


def focus_features(frames: torch.Tensor, kernel_size: int = 11) -> torch.Tensor:
    """frames [B, 3, H, W], RGB in 0..255 -> [B, 6] float32 features in
    FOCUS_FEATURE_NAMES order (generate_vars, LD_detector_gopros_train.py:
    177-194)."""
    k = kernel_size
    x = frames.float()
    gray = (x[:, 0] * _GRAY[0] + x[:, 1] * _GRAY[1] + x[:, 2] * _GRAY[2]) / 255.0
    g = gray[:, None]

    lap1 = _lp2_sq_mean(_conv1(g, _LAP8, 1), k)
    mis = _conv1(g, _mis3_bank(), 1).abs().sum(dim=1, keepdim=True)
    mis3 = _sum_pool(mis, k).mean(dim=(1, 2, 3))
    lh, hl, hh = dwt2_db6_detail(gray)
    wav1 = (lh.abs() + hl.abs() + hh.abs()).sum(dim=(1, 2))
    sob = _conv1(g, _SOBEL, 1)
    sob = torch.sqrt(sob[:, :1] ** 2 + sob[:, 1:] ** 2)
    gra7 = _lp2_sq_mean(sob - _avg_pool_same(sob, k), k)
    sta3 = _lp2_sq_mean(g - _avg_pool_same(g, k), k)
    dct3 = (_sum_pool(_conv1(g, _DCT, 0), k) ** 2).mean(dim=(1, 2, 3))
    return torch.stack([lap1, mis3, wav1, gra7, sta3, dct3], dim=1)
