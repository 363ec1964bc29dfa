"""SWINT, the ablation model without the sharp-frame path (port of
`speinet_tpu/models/swint.py`; parity: model/swint.py).

The same hourglass and cross-frame Swin fusion as SPEINet, without the RL
edge branch, the sharp pyramid or the search / transfer: each frame of the
window is encoded, the centre is fused with every neighbour by one Swin
call, a 1x1 conv takes the parts back to 4 n_feat channels, and the decoder
restores the centre frame. Parameter names are the original model's:
recons_net.*, swin.*, conv.

At inference the window's frames are encoded as one batch, so K1 runs once
at batch n_sequence B; the Swin blocks run through K2 (or K8 + K9 with
`swin_fuse_block=False`) and their rolls through K3. With `train` each frame
is encoded on its own, centre first, then the neighbours by index, as the
JAX model calls `encode3` once per frame: every TripletAttention gate then
normalises with that frame's batch statistics and folds them into its
running statistics once per frame, in that order.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from speinet_tpu_torch.config import Config
from speinet_tpu_torch.models import compute_dtype
from speinet_tpu_torch.models.blocks import conv1x1
from speinet_tpu_torch.models.recons_video import ReconsVideo
from speinet_tpu_torch.models.swinir import SwinIRCross, swin_fuse
from speinet_tpu_torch.utils.spans import span


class SWINT(nn.Module):
    """Parity: model/swint.py (speinet_tpu/models/swint.py:22-84)."""

    def __init__(self, n_sequence: int = 3, n_feat: int = 32,
                 n_resblock: int = 3, out_channels: int = 3,
                 embed_dim: int = 256,
                 depths: Sequence[int] = (6, 6, 6, 6, 6, 6),
                 num_heads: Sequence[int] = (8, 8, 8, 8, 8, 8),
                 window_size: int = 5, mlp_ratio: float = 2.0,
                 drop_path_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32, *,
                 swin_fuse_block: bool = True):
        super().__init__()
        if n_sequence < 1:
            raise ValueError(f"n_sequence {n_sequence}: a window has a frame")
        f = n_feat
        self.n_sequence = n_sequence
        self.dtype = dtype
        self.recons_net = ReconsVideo(f, n_resblock, out_channels)
        self.swin = SwinIRCross(4 * f, embed_dim, depths, num_heads,
                                window_size, mlp_ratio, drop_path_rate,
                                fuse_block=swin_fuse_block)
        self.conv = nn.Conv2d(4 * f * n_sequence, 4 * f, 1)

    @classmethod
    def from_config(cls, cfg: Config, *, swin_fuse_block: bool = True) -> "SWINT":
        return cls(n_sequence=cfg.n_sequence, n_feat=cfg.n_feat,
                   n_resblock=cfg.n_resblock, out_channels=cfg.n_colors,
                   embed_dim=cfg.embed_dim, depths=tuple(cfg.depths),
                   num_heads=tuple(cfg.num_heads), window_size=cfg.window_size,
                   mlp_ratio=cfg.mlp_ratio, drop_path_rate=cfg.drop_path_rate,
                   dtype=compute_dtype(cfg), swin_fuse_block=swin_fuse_block)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x [B, >= n_sequence, 3, H, W] (frames past the window, such as the
        pre- and sub-sharp frames of the training loader, are not read) ->
        the restored centre frame [B, 3, H, W] float32. Inference runs
        without autograd; with `train` the convs and Swin blocks take their
        training forms and DropPath draws from `generator`."""
        with span("model.forward", device=True):
            if not train:
                with torch.no_grad():
                    return self._forward(x, False, None)
            return self._forward(x, True, generator)

    def _forward(self, x: torch.Tensor, train: bool,
                 generator: torch.Generator | None) -> torch.Tensor:
        dt, ns, b = self.dtype, self.n_sequence, x.shape[0]
        r = self.recons_net
        nhwc = x.permute(0, 1, 3, 4, 2)
        mid = ns // 2
        order = [mid] + [i for i in range(ns) if i != mid]
        frames = [nhwc[:, i].to(dt) for i in order]
        if train:
            feats = [r.encode_pyramid(f.contiguous(), dt, True)[2] for f in frames]
        else:
            lv3 = r.encode_pyramid(torch.cat(frames).contiguous(), dt)[2]
            feats = [lv3[k * b:(k + 1) * b] for k in range(ns)]
        f_fusion = swin_fuse(self.swin, feats[0], feats[1:], dt, train, generator)
        f_fusion = conv1x1(f_fusion, self.conv, dt)
        d1 = r.decode_first(r.decode_second(f_fusion, dt, train), dt, train)
        return r.out_block(d1, dt, train).permute(0, 3, 1, 2).float()
