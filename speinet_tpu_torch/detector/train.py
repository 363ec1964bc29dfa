"""Feature extraction of whole videos for the detector (port of
`speinet_tpu/detector/train.py::video_features`; the fitting drivers come
with the detector-training slice)."""

from __future__ import annotations

import numpy as np
import torch

from speinet_tpu_torch.detector.features import focus_features
from speinet_tpu_torch.utils.device import resolve_device


def video_features(frames: np.ndarray, kernel_size: int, batch: int = 16,
                   device="cuda") -> np.ndarray:
    """frames [N, H, W, 3] in 0..255 -> [N, 6] float32 focus features,
    computed `batch` frames at a time on `device` (the card unless the
    caller asks for the CPU)."""
    device = resolve_device(device)
    x = np.asarray(frames, np.float32).transpose(0, 3, 1, 2)
    feats = []
    for i in range(0, len(x), batch):
        t = torch.from_numpy(np.ascontiguousarray(x[i:i + batch])).to(device)
        feats.append(focus_features(t, kernel_size).cpu().numpy())
    return np.concatenate(feats, axis=0)
