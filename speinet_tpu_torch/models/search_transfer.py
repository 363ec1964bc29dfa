"""Patch-correlation search and texture transfer, NHWC (port of
`speinet_tpu/models/search_transfer.py`; parity: model/SearchTransfer.py).

The reference is the sharp anchor ('sharp') or the query map transposed and
flipped ('self', SearchTransfer.py:60), chosen by the host for the whole
batch or per sample ('mixed'); 'mixed' computes both texture paths and
selects per sample. Three switches choose the correlation, as the JAX
package's environment switches do (`search_transfer.py:148-262`):
- `corr_raw` (default): the cosine normalization folds around the kernel.
  The reference side's inverse patch norms scale it, the query side's
  scale S afterwards (the argmax does not depend on them). Then:
  - 'sharp' / 'self' correlate the raw maps through K4
    (`kernels/corr.py::banded_corr_argmax`) unless `corr_banded` is off;
  - otherwise explicit 3x3 unfolds go through K5 (`correlation_argmax_lds`,
    the scale applied inside), or with `corr_scaled` off through K6
    (`correlation_argmax_ld`) on the reference scaled on the host. The self
    reference's unfold is a pure permutation of the query's.
- `corr_raw` off: f32 L2-normalized unfolds, cast to the compute dtype, go
  through K7 (`correlation_argmax`) with the reference as [B, Lr, D] rows,
  in every routing; S needs no rescale.
The texture gather of 'sharp' runs K10 (`ops/patch_ops.py`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from speinet_tpu_torch.kernels import (banded_corr_argmax, correlation_argmax,
                                       correlation_argmax_ld,
                                       correlation_argmax_lds)
from speinet_tpu_torch.kernels.corr import scaled_reference
from speinet_tpu_torch.models.blocks import conv1x1
from speinet_tpu_torch.ops.patch_ops import gather_fold3_nhwc, unfold
from speinet_tpu_torch.ops.resize import bicubic_upsample_nhwc
from speinet_tpu_torch.utils.spans import span


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


def self_reference(u: torch.Tensor, hh: int, ww: int) -> torch.Tensor:
    """The self reference's 3x3 unfold from the query's [B, 9C, H*W]: its
    kernel axes swapped and one flipped, its position grid transposed and
    one axis flipped (the unfold of x.transpose(2, 3).flip(2))."""
    b, d, l = u.shape
    u6 = u.reshape(b, d // 9, 3, 3, hh, ww)
    return torch.flip(u6.permute(0, 1, 3, 2, 5, 4), dims=(2, 4)).reshape(b, d, l)


def self_inv_norms(inv_lr: torch.Tensor, hh: int, ww: int) -> torch.Tensor:
    """The self reference's patch norms: the query's, permuted alike."""
    b = inv_lr.shape[0]
    return torch.flip(inv_lr.reshape(b, hh, ww).transpose(1, 2),
                      dims=(1,)).reshape(b, hh * ww)


def unfold_reference(f_fusion: torch.Tensor, sharp_lv3: torch.Tensor,
                     routing: str, has_sharp: torch.Tensor | None,
                     inv_lr: torch.Tensor):
    """(lr_u [B, D, L], ref_u [B, D, Lr], inv_ref [B, Lr]) of the unfold
    path (parity: search_transfer.py:189-211): the raw query unfold and the
    routing's reference, per sample where routing is 'mixed'."""
    b, hh, ww, _ = f_fusion.shape
    lr_u = unfold(f_fusion.permute(0, 3, 1, 2), 3, 1, 1)
    if routing != "sharp":
        ref_self = self_reference(lr_u, hh, ww)
        inv_self = self_inv_norms(inv_lr, hh, ww)
        if routing == "self":
            return lr_u, ref_self, inv_self
    ref_search = unfold(sharp_lv3.permute(0, 3, 1, 2), 3, 1, 1)
    inv_search = patch_inv_norms(sharp_lv3)
    if routing == "sharp":
        return lr_u, ref_search, inv_search
    ref_u = torch.where(has_sharp[:, None, None], ref_search, ref_self)
    inv_ref = torch.where(has_sharp[:, None], inv_search, inv_self)
    return lr_u, ref_u, inv_ref


def _l2_normalize(u: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize semantics over axis 1: u / max(||u||, eps)."""
    return u / torch.clamp(torch.sqrt((u * u).sum(dim=1, keepdim=True)), min=eps)


def normalized_reference(f_fusion: torch.Tensor, sharp_lv3: torch.Tensor,
                         routing: str, has_sharp: torch.Tensor | None):
    """(lr_n [B, D, L], ref_n [B, Lr, D]) f32 of the normalized path
    (parity: search_transfer.py:225-250): L2-normalized unfolds, the self
    reference a permutation of lr_n, the reference transposed to rows."""
    b, hh, ww, _ = f_fusion.shape
    lr_n = _l2_normalize(unfold(f_fusion.permute(0, 3, 1, 2), 3, 1, 1).float())
    if routing != "sharp":
        ref_n = ref_self_n = self_reference(lr_n, hh, ww)
    if routing != "self":
        ref_n = ref_search_n = _l2_normalize(
            unfold(sharp_lv3.permute(0, 3, 1, 2), 3, 1, 1).float())
    if routing == "mixed":
        ref_n = torch.where(has_sharp[:, None, None], ref_search_n, ref_self_n)
    return lr_n, ref_n.transpose(1, 2)


def transfer(self_transfer: SelfTransfer, f_fusion: torch.Tensor,
             sharp_lv1: torch.Tensor, sharp_lv2: torch.Tensor,
             sharp_lv3: torch.Tensor, routing: str, dtype: torch.dtype,
             has_sharp: torch.Tensor | None = None, *, corr_raw: bool = True,
             corr_banded: bool = True, corr_scaled: bool = True):
    """f_fusion [B, H, W, 4f]; sharp pyramid [B, 4H, 4W, f], [B, 2H, 2W, 2f],
    [B, H, W, 4f]; `has_sharp` [B] bool, needed by routing 'mixed'. The
    three switches choose the correlation kernel (module docstring);
    `corr_banded` and `corr_scaled` matter only with `corr_raw`.
    Returns (S [B, H, W, 1] f32, T_lv3, T_lv2, T_lv1)."""
    if routing not in ("sharp", "self", "mixed"):
        raise ValueError(f"routing {routing!r}")
    b, hh, ww, _ = f_fusion.shape
    if routing == "mixed":
        if has_sharp is None or has_sharp.shape != (b,):
            raise ValueError("routing 'mixed' takes has_sharp, a [B] bool tensor")
        has_sharp = has_sharp.to(device=f_fusion.device, dtype=torch.bool)
    with span("restore.search", b, device=True):
        if not corr_raw:
            lr_n, ref_n = normalized_reference(f_fusion, sharp_lv3, routing, has_sharp)
            s, idx = correlation_argmax(lr_n.to(dtype).contiguous(),
                                        ref_n.to(dtype).contiguous())
        else:
            inv_lr = patch_inv_norms(f_fusion)
            if corr_banded and routing != "mixed":
                if routing == "sharp":
                    ref_map, inv_ref = sharp_lv3, patch_inv_norms(sharp_lv3)
                else:
                    # x.transpose(2,3).flip(2) in map space; the patch norms follow
                    ref_map = torch.flip(f_fusion.transpose(1, 2), dims=(1,))
                    inv_ref = self_inv_norms(inv_lr, hh, ww)
                s, idx = banded_corr_argmax(f_fusion.to(dtype).contiguous(),
                                            ref_map.to(dtype).contiguous(),
                                            inv_ref.contiguous())
            else:
                lr_u, ref_u, inv_ref = unfold_reference(f_fusion, sharp_lv3, routing,
                                                        has_sharp, inv_lr)
                lr_u, ref_u = lr_u.to(dtype).contiguous(), ref_u.to(dtype).contiguous()
                if corr_scaled:
                    s, idx = correlation_argmax_lds(lr_u, ref_u, inv_ref.contiguous())
                else:
                    s, idx = correlation_argmax_ld(lr_u, scaled_reference(ref_u, inv_ref))
            s = s * inv_lr
    weight_s = s.reshape(b, hh, ww, 1)
    if routing != "mixed":
        return (weight_s,) + transfer_tail(self_transfer, f_fusion, sharp_lv1,
                                           sharp_lv2, sharp_lv3, routing, idx, dtype)
    search = transfer_tail(self_transfer, f_fusion, sharp_lv1, sharp_lv2,
                           sharp_lv3, "sharp", idx, dtype)
    own = transfer_tail(self_transfer, f_fusion, sharp_lv1, sharp_lv2,
                        sharp_lv3, "self", idx, dtype)
    sel = has_sharp[:, None, None, None]
    return (weight_s,) + tuple(torch.where(sel, t_s, t_o)
                               for t_s, t_o in zip(search, own))


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
