"""Image and metric helpers the reference ships beside the model (port of
`speinet_tpu/utils/image_utils.py`; parity: util/network_utils.py), which
the SPEINet path does not call:

- `rgb2ycbcr` / `bgr2ycbcr`: MATLAB's conversion, host numpy
  (network_utils.py:165-215);
- `adaptive_instance_normalization` (AdaIN, network_utils.py:217-234), on
  tensors on their device;
- `AverageMeter` (network_utils.py:92-110);
- `crop_border` / `crop_like` (network_utils.py:115-135).
"""

from __future__ import annotations

import numpy as np
import torch

_RGB_Y = np.array([65.481, 128.553, 24.966], np.float32)
_RGB_YCBCR = np.array([[65.481, -37.797, 112.0],
                       [128.553, -74.203, -93.786],
                       [24.966, 112.0, -18.214]], np.float32)
_OFFSET = np.array([16, 128, 128], np.float32)


def _ycbcr(img: np.ndarray, only_y: bool, bgr: bool) -> np.ndarray:
    in_type = img.dtype
    x = img.astype(np.float32)
    if in_type != np.uint8:
        x = x * 255.0
    m = _RGB_Y if only_y else _RGB_YCBCR
    if bgr:
        m = np.ascontiguousarray(m[::-1])   # a strided operand rounds otherwise
    out = x @ m / 255.0 + (16.0 if only_y else _OFFSET)
    out = out.round() if in_type == np.uint8 else out / 255.0
    return out.astype(in_type)


def rgb2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """MATLAB rgb2ycbcr of HWC uint8 in [0, 255] or float in [0, 1]; the
    result in the input's dtype (network_utils.py:165-188)."""
    return _ycbcr(img, only_y, bgr=False)


def bgr2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """MATLAB rgb2ycbcr of BGR-ordered input (network_utils.py:190-215)."""
    return _ycbcr(img, only_y, bgr=True)


def adaptive_instance_normalization(center_feat: torch.Tensor, knn_feat: torch.Tensor,
                                    eps: float = 1e-5) -> torch.Tensor:
    """AdaIN: `knn_feat` [B, M, C, SP, K] renormalised to the per-(B, M, C)
    mean and standard deviation of `center_feat` [B, M, C, P], variances
    unbiased (torch.var's default) plus `eps`."""
    c_std = torch.sqrt(center_feat.var(dim=3) + eps)[..., None, None]
    c_mean = center_feat.mean(dim=3)[..., None, None]
    k_std = torch.sqrt(knn_feat.var(dim=3) + eps)[..., None, :]      # [B, M, C, 1, K]
    k_mean = knn_feat.mean(dim=3)[..., None, :]
    return (knn_feat - k_mean) / k_std * c_std + c_mean


class AverageMeter:
    """Running mean tracker (network_utils.py:92-110)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count

    def __repr__(self):
        return f"{self.val:.5f} ({self.avg:.5f})"


def crop_border(img_list, border: int):
    """`border` pixels cropped from each spatial end of an HWC image or a
    list of them (network_utils.py:122-135)."""
    if border == 0:
        return img_list
    if isinstance(img_list, list):
        return [v[border:-border, border:-border] for v in img_list]
    return img_list[border:-border, border:-border]


def crop_like(x, target):
    """NCHW x cropped to the spatial size of `target` (network_utils.py:115-120)."""
    if x.shape[2:] == target.shape[2:]:
        return x
    return x[:, :, :target.shape[2], :target.shape[3]]
