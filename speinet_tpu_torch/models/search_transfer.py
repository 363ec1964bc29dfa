"""Patch-correlation search and texture transfer, NHWC (port of
`speinet_tpu/models/search_transfer.py`; parity: model/SearchTransfer.py).

For host-known routing only ('sharp': the sharp anchor is the reference;
'self': the reference is the query map transposed and flipped,
SearchTransfer.py:60). The correlation is the K4 kernel on the raw maps
(`kernels/corr.py`): the cosine normalization folds around it — the
reference side's inverse patch norms scale the scores inside, the query
side's scale S afterwards (the argmax does not depend on them). Mixed
routing needs the unfold-form correlation kernel (K5), a later slice.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from speinet_tpu_torch.kernels import banded_corr_argmax
from speinet_tpu_torch.models.blocks import conv1x1
from speinet_tpu_torch.ops.patch_ops import gather_fold3_nhwc
from speinet_tpu_torch.ops.resize import bicubic_upsample_nhwc


def patch_inv_norms(x_nhwc: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """1 / max(||3x3 patch||, eps) per position, [B, H, W, C] -> [B, H*W]
    f32: the column norms of unfold(x, 3, 1, 1), as a 3x3 box sum of the
    per-pixel squared channel norms."""
    b, h, w, _ = x_nhwc.shape
    sq = x_nhwc.float().square().sum(dim=-1)
    p = F.pad(sq, (1, 1, 1, 1))
    acc = None
    for di in range(3):
        for dj in range(3):
            sl = p[:, di:di + h, dj:dj + w]
            acc = sl if acc is None else acc + sl
    return (1.0 / torch.clamp(torch.sqrt(acc), min=eps)).reshape(b, h * w)


class SelfTransfer(nn.Module):
    """The SelfTransfer 1x1 convs (SearchTransfer.py:56-57)."""

    def __init__(self, n_feat: int):
        super().__init__()
        self.search1 = nn.Conv2d(n_feat * 4, n_feat * 2, 1)
        self.search2 = nn.Conv2d(n_feat * 2, n_feat, 1)


def transfer(self_transfer: SelfTransfer, f_fusion: torch.Tensor,
             sharp_lv1: torch.Tensor, sharp_lv2: torch.Tensor,
             sharp_lv3: torch.Tensor, routing: str, dtype: torch.dtype):
    """f_fusion [B, H, W, 4f]; sharp pyramid [B, 4H, 4W, f], [B, 2H, 2W, 2f],
    [B, H, W, 4f]. Returns (S [B, H, W, 1] f32, T_lv3, T_lv2, T_lv1)."""
    if routing not in ("sharp", "self"):
        raise NotImplementedError(
            f"routing {routing!r}: per-sample mixed routing needs the unfold "
            f"correlation kernel K5, queued in ROADMAP.md; split the batch "
            f"into its 'sharp' and 'self' parts")
    b, hh, ww, _ = f_fusion.shape
    l = hh * ww
    inv_lr = patch_inv_norms(f_fusion)
    if routing == "sharp":
        ref_map = sharp_lv3
        inv_ref = patch_inv_norms(sharp_lv3)
    else:
        # x.transpose(2,3).flip(2) in map space; the patch norms follow
        ref_map = torch.flip(f_fusion.transpose(1, 2), dims=(1,))
        inv_ref = torch.flip(inv_lr.reshape(b, hh, ww).transpose(1, 2),
                             dims=(1,)).reshape(b, l)
    s, idx = banded_corr_argmax(f_fusion.to(dtype).contiguous(),
                                ref_map.to(dtype).contiguous(),
                                inv_ref.contiguous())
    weight_s = (s * inv_lr).reshape(b, hh, ww, 1)
    return (weight_s,) + transfer_tail(self_transfer, f_fusion, sharp_lv1,
                                       sharp_lv2, sharp_lv3, routing, idx, dtype)


def transfer_tail(self_transfer: SelfTransfer, f_fusion, sharp_lv1, sharp_lv2,
                  sharp_lv3, routing: str, idx: torch.Tensor, dtype):
    """(T_lv3, T_lv2, T_lv1) for one routing (parity: search_transfer.py:268)."""
    if routing == "sharp":
        t3, t2, t1 = (t / 9.0 for t in gather_fold3_nhwc(
            sharp_lv1, sharp_lv2, sharp_lv3, idx))
    else:
        t3 = f_fusion
        up2 = bicubic_upsample_nhwc(f_fusion, 2)
        t2 = torch.relu(conv1x1(up2, self_transfer.search1, dtype))
        up4 = bicubic_upsample_nhwc(t2, 2)
        t1 = torch.relu(conv1x1(up4, self_transfer.search2, dtype))
    return t3.to(dtype), t2.to(dtype), t1.to(dtype)
