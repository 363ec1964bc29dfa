"""Patch-correlation search and texture transfer, NHWC (port of
`speinet_tpu/models/search_transfer.py`; parity: model/SearchTransfer.py).

Host-known routing ('sharp': the sharp anchor is the reference; 'self': the
reference is the query map transposed and flipped, SearchTransfer.py:60)
correlates the raw maps through K4 (`kernels/corr.py::banded_corr_argmax`).
Per-sample 'mixed' routing correlates explicit 3x3 unfolds through K5
(`correlation_argmax_lds`): each sample's reference unfold is selected
before the search, the sharp anchor's or the self reference's, which is a
pure permutation of the query unfold; then both texture paths are computed
and selected per sample. Either way the cosine normalization folds around
the kernel: the reference side's inverse patch norms scale it inside, the
query side's scale S afterwards (the argmax does not depend on them).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from speinet_tpu_torch.kernels import banded_corr_argmax, correlation_argmax_lds
from speinet_tpu_torch.models.blocks import conv1x1
from speinet_tpu_torch.ops.patch_ops import gather_fold3_nhwc, unfold
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


def mixed_reference(f_fusion: torch.Tensor, sharp_lv3: torch.Tensor,
                    has_sharp: torch.Tensor, inv_lr: torch.Tensor):
    """(lr_u [B, D, L], ref_u [B, D, Lr], inv_ref [B, Lr]) of a mixed batch
    (parity: search_transfer.py:189-211): the raw query unfold, and per
    sample the sharp anchor's unfold or the self reference. The latter is
    the query unfold with its kernel axes swapped and one flipped and its
    position grid transposed and one axis flipped; its patch norms follow
    the same permutation."""
    b, hh, ww, c4 = f_fusion.shape
    l = hh * ww
    lr_u = unfold(f_fusion.permute(0, 3, 1, 2), 3, 1, 1)
    lr6 = lr_u.reshape(b, c4, 3, 3, hh, ww)
    ref_self = torch.flip(lr6.permute(0, 1, 3, 2, 5, 4),
                          dims=(2, 4)).reshape(b, c4 * 9, l)
    inv_self = torch.flip(inv_lr.reshape(b, hh, ww).transpose(1, 2),
                          dims=(1,)).reshape(b, l)
    ref_search = unfold(sharp_lv3.permute(0, 3, 1, 2), 3, 1, 1)
    inv_search = patch_inv_norms(sharp_lv3)
    ref_u = torch.where(has_sharp[:, None, None], ref_search, ref_self)
    inv_ref = torch.where(has_sharp[:, None], inv_search, inv_self)
    return lr_u, ref_u, inv_ref


def transfer(self_transfer: SelfTransfer, f_fusion: torch.Tensor,
             sharp_lv1: torch.Tensor, sharp_lv2: torch.Tensor,
             sharp_lv3: torch.Tensor, routing: str, dtype: torch.dtype,
             has_sharp: torch.Tensor | None = None):
    """f_fusion [B, H, W, 4f]; sharp pyramid [B, 4H, 4W, f], [B, 2H, 2W, 2f],
    [B, H, W, 4f]; `has_sharp` [B] bool, needed by routing 'mixed'.
    Returns (S [B, H, W, 1] f32, T_lv3, T_lv2, T_lv1)."""
    if routing not in ("sharp", "self", "mixed"):
        raise ValueError(f"routing {routing!r}")
    b, hh, ww, _ = f_fusion.shape
    l = hh * ww
    inv_lr = patch_inv_norms(f_fusion)
    if routing == "mixed":
        if has_sharp is None or has_sharp.shape != (b,):
            raise ValueError("routing 'mixed' takes has_sharp, a [B] bool tensor")
        has_sharp = has_sharp.to(device=f_fusion.device, dtype=torch.bool)
        lr_u, ref_u, inv_ref = mixed_reference(f_fusion, sharp_lv3, has_sharp,
                                               inv_lr)
        s, idx = correlation_argmax_lds(lr_u.to(dtype).contiguous(),
                                        ref_u.to(dtype).contiguous(),
                                        inv_ref.contiguous())
        weight_s = (s * inv_lr).reshape(b, hh, ww, 1)
        search = transfer_tail(self_transfer, f_fusion, sharp_lv1, sharp_lv2,
                               sharp_lv3, "sharp", idx, dtype)
        own = transfer_tail(self_transfer, f_fusion, sharp_lv1, sharp_lv2,
                            sharp_lv3, "self", idx, dtype)
        sel = has_sharp[:, None, None, None]
        return (weight_s,) + tuple(torch.where(sel, t_s, t_o)
                                   for t_s, t_o in zip(search, own))
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
    """(T_lv3, T_lv2, T_lv1) for 'sharp' or 'self' (parity:
    search_transfer.py:268)."""
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
