"""K3 wrapper: cyclic 2-D roll of NHWC tensors (`csrc/roll.cu`).

Replaces `speinet_tpu/ops/pallas_roll.py::roll2d`. A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from speinet_tpu_torch.kernels import _lib


def roll2d_plain(x: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """out[b, i, j] = x[b, (i + sh) % H, (j + sw) % W]."""
    return torch.roll(x, (-sh, -sw), dims=(1, 2))


def roll2d(x: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """Roll [B, H, W, C] by (-sh, -sw) over (H, W); sh/sw of any sign."""
    if x.ndim != 4:
        raise ValueError(f"roll2d takes [B, H, W, C], got {tuple(x.shape)}")
    b, h, w, c = x.shape
    sh %= h
    sw %= w
    if sh == 0 and sw == 0:
        return x
    if _lib.dispatch_device(x, "roll2d") == "cpu":
        return roll2d_plain(x, sh, sw)
    _lib.require_cuda_tensor(x, "x", x.dtype, x.device)
    out = torch.empty_like(x)
    lib = _lib.library()
    _lib.check(lib.speinet_roll2d(x.data_ptr(), out.data_ptr(), b, h, w,
                                  c * x.element_size(), sh, sw,
                                  _lib.stream_ptr(x)), "roll2d")
    _lib.LAUNCHES["roll2d"] += 1
    return out
