"""CNN building blocks, NHWC (port of `speinet_tpu/models/blocks.py`).

Module and parameter names follow the original PyTorch SPEINet
(`model/block.py`), so a port `state_dict()` is a reference state_dict:
    ResBlock:  main.{0,1}.main.0.{weight,bias}, se.fc.{0,2}.*,
               te.{cw,hc}.conv.conv.weight, te.{cw,hc}.conv.bn.*
Tensors are NHWC throughout; torch-layout weights are cast to the compute
dtype at use. At inference every 5x5 / 3x3 feature conv goes through the
K1 kernel (`kernels/conv.py`); the gate convs, the transposed convs and the
1x1 convs were XLA convs on the TPU and stay PyTorch calls here. With
`train=True` every conv is a PyTorch conv (the JAX package gates its Pallas
conv on `not train`, blocks.py:287), and the TripletAttention gates
normalise with the batch statistics and update their running statistics
the flax way (momentum 0.99, biased batch variance, blocks.py:357).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from speinet_tpu_torch.kernels import conv2d


def hwio(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """torch conv weight [O, I, kh, kw] -> contiguous [kh, kw, I, O]."""
    return weight.to(dtype).permute(2, 3, 1, 0).contiguous()


def conv_k1(x: torch.Tensor, conv: nn.Conv2d, relu: bool, dtype: torch.dtype,
            stride: int = 1, round_bias: bool = False,
            train: bool = False) -> torch.Tensor:
    """A Conv2d's parameters through the K1 kernel. The bias is added in
    f32; `round_bias` first rounds it to the compute dtype (FastConv). With
    `train` a PyTorch conv instead, the bias added in the compute dtype."""
    if train:
        y = conv_nhwc(x, conv, dtype, stride)
        return torch.relu(y) if relu else y
    bias = conv.bias.to(dtype) if round_bias else conv.bias
    return conv2d(x.to(dtype).contiguous(), hwio(conv.weight, dtype),
                  bias.float().contiguous(), relu=relu, stride=stride)


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype,
              stride: int = 1) -> torch.Tensor:
    """A plain PyTorch conv (odd k, SAME) in the compute dtype, NHWC."""
    k = conv.kernel_size[0]
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), conv.weight.to(dtype),
                 conv.bias.to(dtype), stride=stride, padding=k // 2)
    return y.permute(0, 2, 3, 1).contiguous()


def conv1x1(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """A 1x1 Conv2d as a matmul over the channel axis, in the compute dtype."""
    w = conv.weight[:, :, 0, 0].to(dtype)
    return F.linear(x.to(dtype), w, conv.bias.to(dtype))


class BasicConv(nn.Module):
    """Conv2d (+ ReLU) of a ResBlock (parity: block.py:26-47)."""

    def __init__(self, cin: int, cout: int, k: int, relu: bool):
        super().__init__()
        layers = [nn.Conv2d(cin, cout, k, padding=k // 2)]
        if relu:
            layers.append(nn.ReLU())
        self.main = nn.Sequential(*layers)
        self.relu = relu

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                train: bool = False) -> torch.Tensor:
        return conv_k1(x, self.main[0], self.relu, dtype, train=train)


class SEBlock(nn.Module):
    """Channel squeeze-excite, reduction 4 (parity: block.py:8-24)."""

    def __init__(self, c: int, reduction: int = 4):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(c, c // reduction), nn.ReLU(),
                                nn.Linear(c // reduction, c), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        fc1, fc2 = self.fc[0], self.fc[2]
        y = x.mean(dim=(1, 2))
        y = torch.relu(F.linear(y, fc1.weight.to(dt), fc1.bias.to(dt)))
        y = torch.sigmoid(F.linear(y, fc2.weight.to(dt), fc2.bias.to(dt)))
        return x * y[:, None, None, :]


class GateConv(nn.Module):
    """conv(2 -> 1, k, no bias) + BatchNorm (reference BasicConv1)."""

    def __init__(self, k: int):
        super().__init__()
        self.conv = nn.Conv2d(2, 1, k, padding=(k - 1) // 2, bias=False)
        self.bn = nn.BatchNorm2d(1, eps=1e-5, momentum=0.01)


BN_MOMENTUM = 0.99   # flax's convention: new = 0.99 old + 0.01 batch


class AttentionGate(nn.Module):
    """Gate on an already-pooled plane [B, A1, A2, 2] -> [B, A1, A2]: the raw
    batch-normed conv output, no ReLU, no sigmoid (parity: block.py:75-96).
    BatchNorm uses its running statistics, or with `train` the batch's
    (mean, one-pass biased variance clamped at 0, as flax computes them)
    and folds them into the running ones. nn.BatchNorm2d's own update would
    take the unbiased variance, so the update is written out here."""

    def __init__(self, k: int):
        super().__init__()
        self.conv = GateConv(k)

    def forward(self, pooled: torch.Tensor, dtype: torch.dtype,
                train: bool = False) -> torch.Tensor:
        conv, bn = self.conv.conv, self.conv.bn
        z = F.conv2d(pooled.to(dtype).permute(0, 3, 1, 2), conv.weight.to(dtype),
                     padding=conv.padding)[:, 0].float()
        if train:
            mean = z.mean()
            var = torch.clamp((z * z).mean() - mean * mean, min=0.0)
            with torch.no_grad():
                for run, batch in ((bn.running_mean, mean), (bn.running_var, var)):
                    run.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * batch)
                bn.num_batches_tracked.add_(1)
        else:
            mean, var = bn.running_mean.float(), bn.running_var.float()
        inv = torch.rsqrt(var + bn.eps) * bn.weight.float()
        return (z - mean) * inv + bn.bias.float()


class TripletAttention(nn.Module):
    """The two cross-dimension gates summed (parity: block.py:108-124),
    pooling first so only the [B, A1, A2, 2] planes are convolved."""

    def __init__(self):
        super().__init__()
        self.cw = AttentionGate(7)
        self.hc = AttentionGate(5)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = x.dtype
        xf = x.float()
        pool_cw = torch.stack([xf.amax(dim=2), xf.mean(dim=2)], dim=-1)   # [B, H, C, 2]
        gate_cw = self.cw(pool_cw, dt, train)                              # [B, H, C]
        pool_hc = torch.stack([xf.amax(dim=1), xf.mean(dim=1)], dim=-1)   # [B, W, C, 2]
        gate_hc = self.hc(pool_hc.transpose(1, 2), dt, train)             # [B, C, W]
        g = gate_cw[:, :, None, :] + gate_hc.transpose(1, 2)[:, None, :, :]
        return x * g.to(dt)


class ResBlock(nn.Module):
    """Two 5x5 convs -> SE + Triplet -> + identity (parity: block.py:127-141)."""

    def __init__(self, c: int, k: int = 5):
        super().__init__()
        self.main = nn.Sequential(BasicConv(c, c, k, True),
                                  BasicConv(c, c, k, False))
        self.se = SEBlock(c)
        self.te = TripletAttention()

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                train: bool = False) -> torch.Tensor:
        x1 = self.main[1](self.main[0](x, dtype, train), dtype, train)
        return self.se(x1) + self.te(x1, train) + x
