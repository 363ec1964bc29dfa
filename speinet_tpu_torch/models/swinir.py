"""Cross-frame SwinIR fusion, NHWC (port of `speinet_tpu/models/swinir.py`;
parity: model/swinir.py as configured by model/speinet.py:40-49).

Queries come from the neighbour stream y, keys and values from the mid
stream x; both share norm1. Parameter names follow the original model:
    conv_first, patch_embed.norm, layers.{L}.residual_group.blocks.{i}.
    {norm1, attn.{qkv_x, qkv_y, proj, relative_position_bias_table}, norm2,
    mlp.{fc1, fc2}}, layers.{L}.conv, norm, conv_after_body, conv_last.
Every block runs through the K2 kernel (`kernels/swin.py`) with its rolls
through K3 (`kernels/roll.py`). With `swin_fuse_block=False` (the JAX
package's SPEINET_SWIN_FUSEBLOCK=0) a block is split instead: K8 computes
the attention branch, the residual add runs in the compute dtype, and K9
adds the MLP, as the TPU ran blocks before K2. The 3x3 convs were XLA convs
on the TPU and are PyTorch calls here.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from speinet_tpu_torch.kernels import (SwinBlockWeights, ln_mlp, roll2d,
                                       swin_block, window_cross_attention)
from speinet_tpu_torch.kernels.swin import layer_norm
from speinet_tpu_torch.models.blocks import conv_nhwc


@functools.lru_cache(maxsize=None)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """Pairwise relative-position index table (parity: swinir.py:91-102)."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


class WindowCrossAttention(nn.Module):
    """Windowed MHA parameters; Q from y, K/V from x (parity: swinir.py:64-149)."""

    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.window_size = window_size
        self.num_heads = num_heads
        self.qkv_x = nn.Linear(dim, 2 * dim)
        self.qkv_y = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))

    def rel_pos_bias(self, ws: int) -> torch.Tensor:
        """[heads, N, N] float32 bias for a ws x ws window."""
        table = self.relative_position_bias_table
        if table.shape[0] != (2 * ws - 1) ** 2:
            raise ValueError(
                f"the window shrinks to {ws} on this input but the model was "
                f"built for window {self.window_size}; build it with "
                f"window_size={ws} for inputs this small")
        idx = torch.from_numpy(relative_position_index(ws, ws).reshape(-1))
        n = ws * ws
        bias = table[idx.to(table.device)].reshape(n, n, self.num_heads)
        return bias.permute(2, 0, 1).float().contiguous()


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class SwinBlock(nn.Module):
    """One (shifted-)window cross-attention block (parity: swinir.py:163-281);
    `fuse_block` picks K2 (True) or K8 + K9 (swinir.py:353-387)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 5,
                 shift_size: int = 0, mlp_ratio: float = 2.0, *,
                 fuse_block: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift_size = shift_size
        self.fuse_block = fuse_block
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowCrossAttention(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def weights(self, dtype: torch.dtype, ws: int) -> SwinBlockWeights:
        f32 = lambda t: t.float().contiguous()
        mat = lambda lin: lin.weight.to(dtype).contiguous()
        a = self.attn
        return SwinBlockWeights(
            f32(self.norm1.weight), f32(self.norm1.bias), mat(a.qkv_x),
            f32(a.qkv_x.bias), mat(a.qkv_y), f32(a.qkv_y.bias), mat(a.proj),
            f32(a.proj.bias), a.rel_pos_bias(ws), f32(self.norm2.weight),
            f32(self.norm2.bias), mat(self.mlp.fc1), f32(self.mlp.fc1.bias),
            mat(self.mlp.fc2), f32(self.mlp.fc2.bias))

    def forward(self, x: torch.Tensor, y, x_size, dtype: torch.dtype) -> torch.Tensor:
        """x [B, L, C]; y [B, L, C] or (y, y pre-rolled by the shift)."""
        hh, ww = x_size
        b, l, c = x.shape
        y_rolled = None
        if isinstance(y, (tuple, list)):
            y, y_rolled = y
        ws, ss = self.window_size, self.shift_size
        if min(hh, ww) <= ws:       # parity: swinir.py:192-195
            ss = 0
            ws = min(hh, ww)
        ph = (-hh) % ws
        pw = (-ww) % ws
        xi = x.reshape(b, hh, ww, c).to(dtype)
        if ss > 0 and y_rolled is not None and not (ph or pw):
            yi = y_rolled.reshape(b, hh, ww, c).to(dtype)
            xi = roll2d(xi, ss, ss)
        else:
            yi = y.reshape(b, hh, ww, c).to(dtype)
            if ph or pw:
                xi = nn.functional.pad(xi, (0, 0, 0, pw, 0, ph))
                yi = nn.functional.pad(yi, (0, 0, 0, pw, 0, ph))
            if ss > 0:
                xi = roll2d(xi, ss, ss)
                yi = roll2d(yi, ss, ss)
        wts = self.weights(dtype, ws)
        block = swin_block if self.fuse_block else window_cross_attention
        out = block(xi.contiguous(), yi.contiguous(), wts, ws, ss, ph, pw,
                    self.num_heads)
        if ss > 0:
            out = roll2d(out, -ss, -ss)
        if ph or pw:
            out = out[:, :hh, :ww]
        out = out.reshape(b, l, c)
        if self.fuse_block:
            return out
        return ln_mlp((x.to(dtype) + out).contiguous(), wts)


class BasicLayer(nn.Module):
    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio,
                 fuse_block=True):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size,
                      0 if i % 2 == 0 else window_size // 2, mlp_ratio,
                      fuse_block=fuse_block)
            for i in range(depth))


class RSTB(nn.Module):
    """depth blocks + 3x3 conv + residual (parity: swinir.py:421-494)."""

    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio,
                 fuse_block=True):
        super().__init__()
        self.residual_group = BasicLayer(dim, depth, num_heads, window_size,
                                         mlp_ratio, fuse_block)
        self.conv = nn.Conv2d(dim, dim, 3, 1, 1)

    def forward(self, x, y, x_size, dtype):
        res = x
        for blk in self.residual_group.blocks:
            res = blk(res, y, x_size, dtype)
        hh, ww = x_size
        b, l, c = res.shape
        img = conv_nhwc(res.reshape(b, hh, ww, c), self.conv, dtype)
        return img.reshape(b, l, c) + x


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)


class SwinIRCross(nn.Module):
    """Feature-space cross-frame SwinIR, upsampler '' branch
    (parity: swinir.py:620-810). forward(x, y): NHWC [B, H, W, C_in] each ->
    x + conv_last(...), a C_in-channel residual restoration."""

    def __init__(self, in_chans: int, embed_dim: int = 256,
                 depths: Sequence[int] = (6, 6, 6, 6, 6, 6),
                 num_heads: Sequence[int] = (8, 8, 8, 8, 8, 8),
                 window_size: int = 5, mlp_ratio: float = 2.0, *,
                 fuse_block: bool = True):
        super().__init__()
        self.embed_dim = embed_dim
        self.window_size = window_size
        self.conv_first = nn.Conv2d(in_chans, embed_dim, 3, 1, 1)
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList(
            RSTB(embed_dim, d, h, window_size, mlp_ratio, fuse_block)
            for d, h in zip(depths, num_heads))
        # the two SwinIR-level norms are flax nn.LayerNorm: eps 1e-6
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, 1, 1)
        self.conv_last = nn.Conv2d(embed_dim, in_chans, 3, 1, 1)

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        b, hh, ww, _ = x.shape
        e = self.embed_dim
        x_first = conv_nhwc(x, self.conv_first, dtype)
        y_first = conv_nhwc(y, self.conv_first, dtype)
        pn = self.patch_embed.norm
        xe = layer_norm(x_first.reshape(b, hh * ww, e), pn.weight, pn.bias,
                        pn.eps).to(dtype)
        ye = layer_norm(y_first.reshape(b, hh * ww, e), pn.weight, pn.bias,
                        pn.eps).to(dtype)
        # the Q stream is constant over all blocks: roll it once for the
        # shifted ones (only where no pad / window shrink changes the roll)
        ws = self.window_size
        if min(hh, ww) > ws and hh % ws == 0 and ww % ws == 0:
            ss = ws // 2
            ye_sw = roll2d(ye.reshape(b, hh, ww, e), ss, ss).reshape(b, hh * ww, e)
            y_in = (ye, ye_sw)
        else:
            y_in = ye
        feat = xe
        for layer in self.layers:
            feat = layer(feat, y_in, (hh, ww), dtype)
        feat = layer_norm(feat, self.norm.weight, self.norm.bias,
                          self.norm.eps).to(dtype).reshape(b, hh, ww, e)
        res = conv_nhwc(feat, self.conv_after_body, dtype) + x_first
        return x.to(dtype) + conv_nhwc(res, self.conv_last, dtype)
