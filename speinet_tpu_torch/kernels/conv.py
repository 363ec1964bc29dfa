"""K1 wrapper: NHWC convolution with fused bias + ReLU (`csrc/conv.cu`).

Replaces `speinet_tpu/ops/pallas_conv.py::conv2d_mxu`, and takes stride 2
as well, so the encoder's stride-2 convs need no space-to-depth rewrite.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(bf16 operands, f32 accumulation) or raises. It has no backward (training
runs its convs through `F.conv2d`, as the JAX package runs them in XLA),
so it refuses inputs that need a gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from speinet_tpu_torch.kernels import _lib


def _check_args(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                stride: int) -> None:
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"conv2d takes x [B, H, W, C] and w [k, k, C, Co], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    k = w.shape[0]
    if k % 2 == 0 or w.shape[1] != k or w.shape[2] != x.shape[3]:
        raise ValueError(f"odd square kernel over {x.shape[3]} channels "
                         f"expected, got {tuple(w.shape)}")
    if bias.shape != (w.shape[3],):
        raise ValueError(f"bias {tuple(bias.shape)} for {w.shape[3]} outputs")
    if stride not in (1, 2):
        raise ValueError(f"stride {stride}: the kernel takes 1 or 2")
    if not x.is_contiguous():
        raise ValueError("conv2d: x must be contiguous NHWC")


def conv2d_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 relu: bool = False, stride: int = 1) -> torch.Tensor:
    """The kernel's arithmetic in float32: the operands as given (bf16 values
    are exact in f32), f32 sums, f32 bias, ReLU, one rounding to x.dtype."""
    k = w.shape[0]
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w.permute(3, 2, 0, 1).float(),
                 bias.float(), stride=stride, padding=k // 2)
    if relu:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def slab_weights(w: torch.Tensor) -> torch.Tensor:
    """The kernel's weight operand: w [k, k, Cin, Co] in the order its weight
    slabs stream through shared memory, so each slab is one contiguous bulk
    copy (mirrors the tiling of `csrc/conv.cu`): [Co / N, slabs, N / 8,
    slab rows, 8] over the flattened (tap, input channel) axis, input
    channels zero-padded to cinp and the axis to whole slabs."""
    k, _, cin, co = w.shape
    n = next(t for t in (128, 64, 32, 16) if co % t == 0)
    rows = 64 if n >= 64 else 128
    cinp = 16 if cin <= 16 else 32 if cin <= 32 else -(-cin // 64) * 64
    slabs = -(-(k * k * cinp) // rows)
    flat = w.new_zeros((slabs * rows, co))
    flat[:k * k * cinp].view(k * k, cinp, co)[:, :cin] = w.reshape(k * k, cin, co)
    return flat.view(slabs, rows, co // n, n // 8, 8).permute(2, 0, 3, 1, 4).contiguous()


def conv2d(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
           relu: bool = False, stride: int = 1) -> torch.Tensor:
    """SAME (pad k//2) conv: x [B, H, W, C], w [k, k, C, Co] (HWIO),
    bias [Co] float32 -> [B, ceil(H/stride), ceil(W/stride), Co] in x.dtype."""
    _check_args(x, w, bias, stride)
    _lib.refuse_grad("conv2d", x, w, bias)
    if _lib.dispatch_device(x, "conv2d") == "cpu":
        return conv2d_plain(x, w, bias, relu, stride)
    dev = x.device
    _lib.require_cuda_tensor(x, "x", torch.bfloat16, dev)
    _lib.require_cuda_tensor(w, "w", torch.bfloat16, dev)
    _lib.require_cuda_tensor(bias, "bias", torch.float32, dev)
    b, h, wd, c = x.shape
    k, co = w.shape[0], w.shape[3]
    if co % 16:
        raise ValueError(f"conv2d kernel takes a multiple of 16 output "
                         f"channels, got {co}")
    lib = _lib.library()
    if not lib.speinet_conv2d_fits(c, co, k, stride):
        raise ValueError(f"conv2d kernel has no shared-memory plan for a {k}x{k} "
                         f"stride-{stride} conv of {c} -> {co} channels")
    pad = k // 2
    ho = (h + 2 * pad - k) // stride + 1
    wo = (wd + 2 * pad - k) // stride + 1
    out = torch.empty((b, ho, wo, co), dtype=torch.bfloat16, device=dev)
    ws = slab_weights(w)
    _lib.check(lib.speinet_conv2d(x.data_ptr(), ws.data_ptr(), bias.data_ptr(),
                                  out.data_ptr(), b, h, wd, c, co, k, stride,
                                  int(relu), _lib.stream_ptr(x)), "conv2d")
    _lib.LAUNCHES["conv2d"] += 1
    return out
