"""Metrics (port of `speinet_tpu/ops/metrics.py`).

- `psnr_shave`: train / eval PSNR on [0, rgb_range] float tensors with a
  4-pixel shave (util/utils.py:81-92); `postprocess_uint8` turns a CHW
  float image into HWC uint8 (util/utils.py:68-78).
- `psnr_uint8`: PSNR on [0, 255] images after a 4-pixel border crop
  (inference_SPEINet.py:484-500), in float64 on the tensors' device;
  `psnr_uint8_host` the same in numpy, as the inference logs take it;
  `psnr_from_sse` the expression both host paths end in.
- `chunk_scores`: the inference engine's scores of a restored chunk on its
  device, an exact integer sum of squared errors and the SSIM per frame,
  for one readback a chunk.
- `ssim_matlab`: MATLAB-equivalent SSIM, 11x11 Gaussian (sigma 1.5), valid
  region, C1/C2 at the 255 range, the map of all channels averaged
  (inference_SPEINet.py:502-543). Runs on the tensors' device.
"""

from __future__ import annotations

import numpy as np
import torch


def psnr_shave(img1: torch.Tensor, img2: torch.Tensor, rgb_range: float = 1.0,
               shave: int = 4) -> torch.Tensor:
    """Training-loop PSNR, [..., C, H, W] (a 0-d tensor on the device)."""
    a = img1[..., shave:-shave, shave:-shave] / rgb_range
    b = img2[..., shave:-shave, shave:-shave] / rgb_range
    mse = ((a - b) ** 2).mean()
    return torch.where(mse == 0, torch.full_like(mse, 100.0),
                       20.0 * torch.log10(1.0 / torch.sqrt(mse)))


def postprocess_uint8(img: torch.Tensor, rgb_range: float = 1.0) -> np.ndarray:
    """[C, H, W] float in [0, rgb_range] -> HWC uint8 numpy."""
    out = torch.clamp(torch.round(img.float() * (255.0 / rgb_range)), 0, 255)
    return out.to(torch.uint8).permute(1, 2, 0).cpu().numpy()


def psnr_uint8(img1: torch.Tensor, img2: torch.Tensor,
               crop_border: int = 4) -> torch.Tensor:
    """Inference PSNR of two [0, 255] images (HWC, the border cropped from
    the two leading axes): a 0-d float64 tensor on their device, inf where
    they are equal."""
    a = img1[crop_border:-crop_border, crop_border:-crop_border].double()
    b = img2[crop_border:-crop_border, crop_border:-crop_border].double()
    mse = ((a - b) ** 2).mean()
    return torch.where(mse == 0, torch.full_like(mse, float("inf")),
                       20.0 * torch.log10(255.0 / torch.sqrt(mse)))


def psnr_from_sse(sse: float, count: int) -> float:
    """PSNR of [0, 255] images from their sum of squared errors over
    `count` values: the mean in float64 on the host (divided by the count,
    as numpy's mean does), inf where it is 0."""
    mse = np.float64(sse) / count
    if mse == 0:
        return float("inf")
    return float(20.0 * np.log10(255.0 / np.sqrt(mse)))


def psnr_uint8_host(img1: np.ndarray, img2: np.ndarray,
                    crop_border: int = 4) -> float:
    """Bit-exact float64 host PSNR for the inference logs."""
    a = img1[crop_border:-crop_border, crop_border:-crop_border].astype(np.float64)
    b = img2[crop_border:-crop_border, crop_border:-crop_border].astype(np.float64)
    return psnr_from_sse(np.sum((a - b) ** 2), a.size)


def chunk_scores(imgs: torch.Tensor, gts: torch.Tensor,
                 crop_border: int = 4) -> torch.Tensor:
    """Scores of n [H, W, 3] uint8 frames against their uint8 ground truths,
    both [n, H, W, 3] on one device: [n, 2] float64 on that device. Column
    0 is each frame's sum of squared errors over the border-cropped frame,
    int32 differences summed in int64; below 2**53 (a 720p frame reaches
    1.8e11) it is exact in float64, where numpy's float64 sum of the same
    squares is exact too, so `psnr_from_sse` of it is `psnr_uint8_host`'s
    PSNR bit for bit. Column 1 is `ssim_matlab(gt, img)`, one frame at a
    time: a batched call would reorder its float32 sums."""
    c = crop_border
    d = imgs[:, c:-c, c:-c].int() - gts[:, c:-c, c:-c].int()
    sse = d.square_().sum(dim=(1, 2, 3), dtype=torch.int64)
    ssim = torch.stack([ssim_matlab(g, i, crop_border) for g, i in zip(gts, imgs)])
    return torch.stack([sse.double(), ssim.double()], dim=1)


def _gaussian_window(ksize: int = 11, sigma: float = 1.5) -> np.ndarray:
    """cv2.getGaussianKernel-equivalent 1-D kernel."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _filter_valid(img: torch.Tensor, win1d) -> torch.Tensor:
    """Separable 2-D correlation, valid region only. img: [H, W, C].
    Written as shifted float32 adds, so no convolution library (and on the
    card no TF32) touches the metric."""
    k = len(win1d)
    h, w = img.shape[0] - k + 1, img.shape[1] - k + 1
    x = sum(float(win1d[i]) * img[i:i + h] for i in range(k))
    return sum(float(win1d[j]) * x[:, j:j + w] for j in range(k))


def ssim_matlab(img1: torch.Tensor, img2: torch.Tensor,
                crop_border: int = 4) -> torch.Tensor:
    """MATLAB-style SSIM on [0, 255] HWC images (uint8 or float)."""
    if crop_border:
        img1 = img1[crop_border:-crop_border, crop_border:-crop_border]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border]
    if img1.ndim == 2:
        img1 = img1[..., None]
        img2 = img2[..., None]
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    a = img1.float()
    b = img2.float()
    win = _gaussian_window().astype(np.float32)
    mu1 = _filter_valid(a, win)
    mu2 = _filter_valid(b, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _filter_valid(a * a, win) - mu1_sq
    sigma2_sq = _filter_valid(b * b, win) - mu2_sq
    sigma12 = _filter_valid(a * b, win) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()
