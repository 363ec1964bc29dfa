"""Single-level 2-D db6 wavelet detail bands (port of
`speinet_tpu/ops/wavelet.py`).

The reference's WAV1 focus measure sums |LH| + |HL| + |HH| of
`ptwt.wavedec2(frames, 'db6', mode='zero', level=1)`
(LD_detector_gopros_train.py:152-159). Along each axis that is the full
convolution with a db6 decomposition filter over zero extension, keeping
odd indices (pywt's 'zero' mode); here it runs as twelve strided slices
multiplied and summed in float32, so the card and the CPU do the same
arithmetic (no TF32 convolution).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# pywt db6 dec_lo (low-pass decomposition filter), length 12
DB6_DEC_LO = np.array([
    -0.00107730108499558, 0.004777257511010651, 0.0005538422009938016,
    -0.031582039318031156, 0.02752286553001629, 0.09750160558707936,
    -0.12976686756709563, -0.22626469396516913, 0.3152503517092432,
    0.7511339080215775, 0.4946238903983854, 0.11154074335008017,
], dtype=np.float64)

# quadrature-mirror high-pass: dec_hi[k] = (-1)^k * dec_lo[L-1-k]
DB6_DEC_HI = np.array(
    [(-1.0) ** k * DB6_DEC_LO[len(DB6_DEC_LO) - 1 - k]
     for k in range(len(DB6_DEC_LO))], dtype=np.float64)


def _dwt_axis(x: torch.Tensor, filt: np.ndarray, axis: int) -> torch.Tensor:
    """out[k] = full_conv(x, filt)[2k + 1] along `axis`, zero extension;
    output length floor((n + L - 1) / 2)."""
    taps = len(filt)
    x = x.movedim(axis, -1)
    n = x.shape[-1]
    out_len = (n + taps - 1) // 2
    xp = F.pad(x, (taps - 2, taps - 1))
    kern = [float(v) for v in filt[::-1].astype(np.float32)]
    y = None
    for j, kj in enumerate(kern):
        term = xp[..., j:j + 2 * out_len - 1:2] * kj
        y = term if y is None else y + term
    return y.movedim(-1, axis)


def dwt2_db6_detail(x: torch.Tensor):
    """Level-1 db6 detail bands (LH, HL, HH) of [..., H, W], zero extension
    (the band order of the JAX package; the focus measure only sums their
    magnitudes)."""
    lo_r = _dwt_axis(x, DB6_DEC_LO, -1)
    hi_r = _dwt_axis(x, DB6_DEC_HI, -1)
    return (_dwt_axis(lo_r, DB6_DEC_HI, -2), _dwt_axis(hi_r, DB6_DEC_LO, -2),
            _dwt_axis(hi_r, DB6_DEC_HI, -2))
