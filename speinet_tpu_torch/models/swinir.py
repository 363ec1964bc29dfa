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

With `train=True` a block runs the JAX package's XLA branch instead
(`WindowCrossAttention.__call__`'s non-fused path and the LN/MLP,
swinir.py:236-265, 372-387) in plain PyTorch ops, with stochastic depth
(per-sample DropPath on both residual branches, rates linspace(0,
drop_path_rate, blocks), swinir.py:95-109, 691) and its rolls through the
K3 autograd function. Each W/SW block pair is recomputed in the backward
pass (`torch.utils.checkpoint`, as `nn.remat` at swinir.py:437-441); the
DropPath masks are drawn before any pair runs, so the recomputation uses
the same ones.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from speinet_tpu_torch.kernels import (SwinBlockWeights, ln_mlp, roll2d,
                                       swin_block, window_cross_attention)
from speinet_tpu_torch.kernels.swin import (layer_norm, window_mask,
                                            window_partition, window_reverse)
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


@functools.lru_cache(maxsize=None)
def _index_on(ws: int, device: torch.device) -> torch.Tensor:
    """The flat ws x ws relative-position index, kept on `device`: a fresh
    host-to-device copy in every block would synchronise the stream."""
    return torch.from_numpy(relative_position_index(ws, ws).reshape(-1)).to(device)


@functools.lru_cache(maxsize=None)
def _mask_on(hp: int, wp: int, ws: int, shift: int, pad_h: int, pad_w: int,
             device: torch.device, dtype: torch.dtype) -> torch.Tensor | None:
    """`window_mask` kept on `device` in `dtype`, for the same reason."""
    mask = window_mask(hp, wp, ws, shift, pad_h, pad_w)
    return None if mask is None else torch.from_numpy(mask).to(device, dtype)


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
        n = ws * ws
        bias = table[_index_on(ws, table.device)].reshape(n, n, self.num_heads)
        return bias.permute(2, 0, 1).float().contiguous()

    def train_forward(self, x_img: torch.Tensor, y_img: torch.Tensor,
                      norm1: nn.LayerNorm, ws: int, shift: int, pad_h: int,
                      pad_w: int, dtype: torch.dtype) -> torch.Tensor:
        """The XLA branch (swinir.py:236-265): norm1 on both raw streams,
        windowed attention with the relative-position bias and the shift /
        pad mask, softmax in float32, projection; [B, Hp, Wp, C] rolled and
        padded in, the same out, in the compute dtype."""
        b, hp, wp, c = x_img.shape
        h = self.num_heads
        hd = c // h
        n = ws * ws
        lin = lambda t, m: F.linear(t, m.weight.to(dtype), m.bias.to(dtype))
        xw = window_partition(layer_norm(x_img, norm1.weight, norm1.bias).to(dtype), ws)
        yw = window_partition(layer_norm(y_img, norm1.weight, norm1.bias).to(dtype), ws)
        bw = xw.shape[0]
        k, v = lin(xw, self.qkv_x).split(c, dim=-1)
        q = lin(yw, self.qkv_y).reshape(bw, n, h, hd).transpose(1, 2) * hd ** -0.5
        k = k.reshape(bw, n, h, hd).transpose(1, 2)
        v = v.reshape(bw, n, h, hd).transpose(1, 2)
        attn = q @ k.transpose(-1, -2) + self.rel_pos_bias(ws).to(dtype)[None]
        mask = _mask_on(hp, wp, ws, shift, pad_h, pad_w, attn.device, dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bw // nw, nw, h, n, n)
                    + mask[None, :, None]).reshape(bw, h, n, n)
        attn = torch.softmax(attn.float(), dim=-1).to(dtype)
        out = (attn @ v).transpose(1, 2).reshape(bw, n, c)
        return window_reverse(lin(out, self.proj), ws, hp, wp)


def drop_path(x: torch.Tensor, keep: torch.Tensor | None, rate: float) -> torch.Tensor:
    """Per-sample stochastic depth (timm's DropPath, swinir.py:95-109):
    samples whose `keep` [B] is False are zeroed, the rest scaled by
    1 / (1 - rate); `keep` None is the identity."""
    if keep is None:
        return x
    shape = (-1,) + (1,) * (x.ndim - 1)
    return torch.where(keep.reshape(shape), x / (1.0 - rate), torch.zeros_like(x))


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

    def forward(self, x: torch.Tensor, y, x_size, dtype: torch.dtype,
                train: bool = False, drop=None) -> torch.Tensor:
        """x [B, L, C]; y [B, L, C] or (y, y pre-rolled by the shift). With
        `train`, the XLA branch; `drop` is None or (rate, keep [2, B] bool):
        the DropPath masks of the attention and the MLP branch."""
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
        if train:
            return self._train_forward(x, xi, yi, x_size, ws, ss, ph, pw, dtype,
                                       drop)
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

    def _train_forward(self, x, xi, yi, x_size, ws, ss, ph, pw, dtype, drop):
        """Attention branch, residual, LN2 / MLP, residual, each branch
        through DropPath (swinir.py:366-387); the stream stays in `dtype`."""
        hh, ww = x_size
        b, l, c = x.shape
        rate, keep = drop if drop is not None else (0.0, (None, None))
        out = self.attn.train_forward(xi, yi, self.norm1, ws, ss, ph, pw, dtype)
        if ss > 0:
            out = roll2d(out.contiguous(), -ss, -ss)
        if ph or pw:
            out = out[:, :hh, :ww]
        x = x.to(dtype) + drop_path(out.reshape(b, l, c), keep[0], rate)
        m = self.mlp
        xm = layer_norm(x, self.norm2.weight, self.norm2.bias).to(dtype)
        xm = F.gelu(F.linear(xm, m.fc1.weight.to(dtype), m.fc1.bias.to(dtype)))
        xm = F.linear(xm, m.fc2.weight.to(dtype), m.fc2.bias.to(dtype))
        return x + drop_path(xm, keep[1], rate)


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

    def forward(self, x, y, x_size, dtype, train: bool = False, drops=None):
        """`drops`: per block, None or (rate, keep masks), in training."""
        blocks = self.residual_group.blocks
        res = x
        if train and len(blocks) % 2 == 0:
            # W/SW pairs recomputed in the backward pass (swinir.py:437-441)
            for i in range(0, len(blocks), 2):
                res = checkpoint(self._pair, res, y, x_size, dtype, i,
                                 drops[i], drops[i + 1], use_reentrant=False)
        else:
            for i, blk in enumerate(blocks):
                res = blk(res, y, x_size, dtype, train,
                          drops[i] if train else None)
        hh, ww = x_size
        b, l, c = res.shape
        img = conv_nhwc(res.reshape(b, hh, ww, c), self.conv, dtype)
        return img.reshape(b, l, c) + x

    def _pair(self, x, y, x_size, dtype, i, drop_w, drop_sw):
        blocks = self.residual_group.blocks
        x = blocks[i](x, y, x_size, dtype, True, drop_w)
        return blocks[i + 1](x, y, x_size, dtype, True, drop_sw)


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
                 window_size: int = 5, mlp_ratio: float = 2.0,
                 drop_path_rate: float = 0.1, *, fuse_block: bool = True):
        super().__init__()
        self.embed_dim = embed_dim
        self.window_size = window_size
        self.depths = tuple(depths)
        # the stochastic-depth rate of every block, in order (swinir.py:691)
        self.drop_rates = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.conv_first = nn.Conv2d(in_chans, embed_dim, 3, 1, 1)
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList(
            RSTB(embed_dim, d, h, window_size, mlp_ratio, fuse_block)
            for d, h in zip(depths, num_heads))
        # the two SwinIR-level norms are flax nn.LayerNorm: eps 1e-6
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, 1, 1)
        self.conv_last = nn.Conv2d(embed_dim, in_chans, 3, 1, 1)

    def draw_drops(self, batch: int, device: torch.device,
                   generator: torch.Generator | None):
        """Per layer, per block: None where the rate is 0, else (rate, keep
        [2, batch] bool), drawn on the generator's device and moved to
        `device`, one row per residual branch."""
        gen_dev = generator.device if generator is not None else device
        drops, off = [], 0
        for depth in self.depths:
            layer = []
            for rate in self.drop_rates[off:off + depth]:
                if rate == 0.0:
                    layer.append(None)
                    continue
                u = torch.rand((2, batch), generator=generator, device=gen_dev)
                layer.append((rate, (u < 1.0 - rate).to(device)))
            drops.append(layer)
            off += depth
        return drops

    def forward(self, x: torch.Tensor, y: torch.Tensor, dtype: torch.dtype,
                train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """With `train`, the XLA branch of every block and DropPath masks
        drawn from `generator` (the default generator if None)."""
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
        drops = self.draw_drops(b, x.device, generator) if train else \
            [None] * len(self.layers)
        feat = xe
        for layer, layer_drops in zip(self.layers, drops):
            feat = layer(feat, y_in, (hh, ww), dtype, train, layer_drops)
        feat = layer_norm(feat, self.norm.weight, self.norm.bias,
                          self.norm.eps).to(dtype).reshape(b, hh, ww, e)
        res = conv_nhwc(feat, self.conv_after_body, dtype) + x_first
        return x.to(dtype) + conv_nhwc(res, self.conv_last, dtype)


def swin_fuse(swin: SwinIRCross, f_mid: torch.Tensor, neighbor_feats,
              dtype: torch.dtype, train: bool = False,
              generator: torch.Generator | None = None) -> torch.Tensor:
    """The centre's features [B, h, w, C] fused with each neighbour's: every
    neighbour through one batched Swin call (the centre, repeated once per
    neighbour, as the stream the blocks update; the neighbours as the
    constant query stream), concatenated after the centre -> [B, h, w,
    C n_sequence]; with none (n_sequence 1) the centre's own Swin pass added
    to it (speinet.py:87-89, swint.py:70-79)."""
    if not neighbor_feats:
        return f_mid.to(dtype) + swin(f_mid, f_mid, dtype, train, generator)
    b = f_mid.shape[0]
    x_in = torch.cat([f_mid] * len(neighbor_feats), dim=0)
    y_in = torch.cat(list(neighbor_feats), dim=0)
    f_trans = swin(x_in, y_in, dtype, train, generator)
    parts = [f_mid.to(dtype)] + [f_trans[k * b:(k + 1) * b]
                                 for k in range(len(neighbor_feats))]
    return torch.cat(parts, dim=-1)
