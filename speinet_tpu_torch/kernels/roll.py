"""K3 wrapper: cyclic 2-D roll of NHWC tensors (`csrc/roll.cu`).

Replaces `speinet_tpu/ops/pallas_roll.py::roll2d`. A CPU tensor takes the
plain version (`torch.roll`, whose autograd gives the gradient); a CUDA
tensor launches the kernel or raises. On the card the roll is an autograd
function whose backward launches K3 again with the shifts negated, as the
TPU kernel's VJP does (`_roll2d_bwd`, pallas_roll.py:135-136).
"""

from __future__ import annotations

import torch

from speinet_tpu_torch.kernels import _lib


def roll2d_plain(x: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """out[b, i, j] = x[b, (i + sh) % H, (j + sw) % W]."""
    return torch.roll(x, (-sh, -sw), dims=(1, 2))


def _launch(x: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """One K3 launch on a contiguous CUDA tensor; sh, sw of any sign."""
    _lib.require_cuda_tensor(x, "x", x.dtype, x.device)
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    lib = _lib.library()
    _lib.check(lib.speinet_roll2d(x.data_ptr(), out.data_ptr(), b, h, w,
                                  c * x.element_size(), sh % h, sw % w,
                                  _lib.stream_ptr(x)), "roll2d")
    _lib.LAUNCHES["roll2d"] += 1
    return out


class Roll2d(torch.autograd.Function):
    """K3 under autograd: the VJP of a roll is the inverse roll."""

    @staticmethod
    def forward(ctx, x, sh, sw):
        ctx.shifts = (sh, sw)
        return _launch(x, sh, sw)

    @staticmethod
    def backward(ctx, g):
        sh, sw = ctx.shifts
        _lib.BACKWARD_LAUNCHES["roll2d"] += 1
        return _launch(g.contiguous(), -sh, -sw), None, None


def roll2d(x: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """Roll [B, H, W, C] by (-sh, -sw) over (H, W); sh/sw of any sign."""
    if x.ndim != 4:
        raise ValueError(f"roll2d takes [B, H, W, C], got {tuple(x.shape)}")
    _, h, w, _ = x.shape
    sh %= h
    sw %= w
    if sh == 0 and sw == 0:
        return x
    if _lib.dispatch_device(x, "roll2d") == "cpu":
        return roll2d_plain(x, sh, sw)
    return Roll2d.apply(x, sh, sw)
