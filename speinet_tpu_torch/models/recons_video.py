"""SRN-style hourglass encoder / decoder, NHWC (port of
`speinet_tpu/models/recons_video.py`; parity: model/recons_video_ori.py).

Stage and parameter names follow the original PyTorch model:
    inBlock.0.0 (5x5 conv) + ReLU, inBlock.{1..n} ResBlocks
    encoder_first / encoder_second: the same with a stride-2 conv
    decoder_second / decoder_first: ResBlocks, then {n}.0 ConvTranspose2d
        (k3, s2, p1, op1) + ReLU
    outBlock: ResBlocks, then {n} 5x5 conv
The encoder's convs, including the two stride-2 ones, and every ResBlock
conv run through the K1 kernel; the transposed convs and the out conv
were XLA convs on the TPU and are PyTorch calls here. Every stage takes
`train`: then no conv goes through K1, as the JAX package runs no fast conv
in training (recons_video.py:35-40), and the gates use batch statistics.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from speinet_tpu_torch.models.blocks import ResBlock, conv_k1, conv_nhwc


def _conv_stage(cin: int, cout: int, k: int, stride: int, n_res: int) -> nn.Sequential:
    return nn.Sequential(
        nn.Sequential(nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2),
                      nn.ReLU()),
        *[ResBlock(cout, k) for _ in range(n_res)])


def _up_stage(cin: int, cout: int, k: int, n_res: int) -> nn.Sequential:
    return nn.Sequential(
        *[ResBlock(cin, k) for _ in range(n_res)],
        nn.Sequential(nn.ConvTranspose2d(cin, cout, 3, 2, 1, 1), nn.ReLU()))


class ReconsVideo(nn.Module):
    """The six hourglass stages (parity: recons_video_ori.py:14-84)."""

    def __init__(self, n_feat: int = 32, n_resblock: int = 3,
                 out_channels: int = 3, kernel_size: int = 5,
                 in_channels: int = 3):
        super().__init__()
        f, k = n_feat, kernel_size
        self.n_resblock = n_resblock
        self.inBlock = _conv_stage(in_channels, f, k, 1, n_resblock)
        self.encoder_first = _conv_stage(f, 2 * f, k, 2, n_resblock)
        self.encoder_second = _conv_stage(2 * f, 4 * f, k, 2, n_resblock)
        self.decoder_second = _up_stage(4 * f, 2 * f, k, n_resblock)
        self.decoder_first = _up_stage(2 * f, f, k, n_resblock)
        self.outBlock = nn.Sequential(
            *[ResBlock(f, k) for _ in range(n_resblock)],
            nn.Conv2d(f, out_channels, k, padding=k // 2))

    @staticmethod
    def _encode(stage: nn.Sequential, x: torch.Tensor, stride: int,
                dtype: torch.dtype, train: bool) -> torch.Tensor:
        x = conv_k1(x, stage[0][0], True, dtype, stride=stride, train=train)
        for blk in stage[1:]:
            x = blk(x, dtype, train)
        return x

    def _decode(self, stage: nn.Sequential, x: torch.Tensor,
                dtype: torch.dtype, train: bool) -> torch.Tensor:
        x = x.to(dtype)
        for blk in stage[:self.n_resblock]:
            x = blk(x, dtype, train)
        up = stage[self.n_resblock][0]
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), up.weight.to(dtype),
                               up.bias.to(dtype), stride=2, padding=1,
                               output_padding=1)
        return torch.relu(y).permute(0, 2, 3, 1).contiguous()

    def encode_pyramid(self, x: torch.Tensor, dtype: torch.dtype,
                       train: bool = False):
        """inBlock -> encoder_first -> encoder_second: (lv1, lv2, lv3)."""
        lv1 = self._encode(self.inBlock, x, 1, dtype, train)
        lv2 = self._encode(self.encoder_first, lv1, 2, dtype, train)
        return lv1, lv2, self._encode(self.encoder_second, lv2, 2, dtype, train)

    def decode_second(self, x, dtype, train: bool = False):
        return self._decode(self.decoder_second, x, dtype, train)

    def decode_first(self, x, dtype, train: bool = False):
        return self._decode(self.decoder_first, x, dtype, train)

    def out_block(self, x: torch.Tensor, dtype: torch.dtype,
                  train: bool = False) -> torch.Tensor:
        x = x.to(dtype)
        for blk in self.outBlock[:self.n_resblock]:
            x = blk(x, dtype, train)
        return conv_nhwc(x, self.outBlock[self.n_resblock], dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """The whole hourglass in float32, NHWC [B, H, W, in] -> [B, H, W,
        out] (the standalone model, recons_video.py:189-196); without
        autograd unless `train`."""
        dt = torch.float32
        with contextlib.nullcontext() if train else torch.no_grad():
            lv3 = self.encode_pyramid(x, dt, train)[2]
            d1 = self.decode_first(self.decode_second(lv3, dt, train), dt, train)
            return self.out_block(d1, dt, train)
