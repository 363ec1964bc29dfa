"""SPEINet's forward, for inference and training (port of
`speinet_tpu/models/speinet.py`; parity: model/speinet.py).

Input frames are floats in [0, rgb_range]; feature maps are NHWC in the
compute dtype; parameters are float32 and are cast at use.
`forward(x)` restores the centre frame of [B, n_sequence + 2, 3, H, W]
windows (the window's frames, then the pre- and sub-sharp frames) with
per-sample routing, as `SPEINet.__call__` does; `forward(x, train=True,
generator=g)` is its training form (autograd on, no K1 / K2 / K8 / K9,
batch-statistics BatchNorm, DropPath drawn from `g`), as `__call__(x,
train=True)` is. Three more methods split that forward so a video engine
can reuse per-frame work across windows:
    encode_window_legs   enc(f) + enc(RL5(f)) and enc(f) + enc(RL1(f))
    anchor_pyramid       the sharp anchor's encoder pyramid
    restore_from_features  Swin fusion of the neighbours (a residual Swin
                         pass of the centre alone where there are none),
                         fusion conv, search + transfer, decoder; with
                         `train` it is differentiable, K4 included
Parameter names follow the original PyTorch model (recons_net.*, swin.*,
conv_lv1..3, fusion, search*, SelfTransfer.*), including the defined but
unused `search23`.

Four keyword-only switches choose among the kernel paths the JAX package
selects by environment variable, each defaulting, as there, to True:
    swin_fuse_block  SPEINET_SWIN_FUSEBLOCK  K2, or K8 + K9 per Swin block
    corr_raw         SPEINET_CORR_RAW        raw unfolds with folded norms,
                                             or normalized unfolds through K7
    corr_banded      SPEINET_CORR_BANDED     K4 for 'sharp' / 'self', or the
                                             unfold path (K5 / K6)
    corr_scaled      SPEINET_CORR_SCALED     K5, or K6 on a host-scaled
                                             reference
`corr_banded` and `corr_scaled` act only with `corr_raw`. None of them
changes the parameters.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from speinet_tpu_torch.config import Config
from speinet_tpu_torch.models import compute_dtype
from speinet_tpu_torch.models.blocks import conv1x1, conv_k1
from speinet_tpu_torch.models.recons_video import ReconsVideo
from speinet_tpu_torch.models.search_transfer import SelfTransfer, transfer
from speinet_tpu_torch.models.swinir import SwinIRCross, swin_fuse
from speinet_tpu_torch.ops.filters import box_kernel, richardson_lucy
from speinet_tpu_torch.ops.resize import bicubic_upsample_nhwc
from speinet_tpu_torch.utils.spans import span

@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random init with the JAX package's distributions: torch's
    default U(+-1/sqrt(fan_in)) for conv / linear kernels and biases (fan_in
    over the input channels for transposed convs too), truncated normal
    (std 0.02, zero bias) for the Swin linears and relative-position tables,
    and identity LayerNorm / BatchNorm."""
    g = torch.Generator().manual_seed(seed)

    def uniform_(t, bound):
        t.copy_((torch.rand(t.shape, generator=g) * 2 - 1) * bound)

    def trunc_normal_(t):
        # N(0, 1) clipped at +-2 has std 0.8796; rescale to 0.02
        t.copy_(torch.randn(t.shape, generator=g).clamp_(-2, 2) * (0.02 / 0.8796))

    for name, mod in model.named_modules():
        if isinstance(mod, nn.Linear) and ".residual_group." in f".{name}":
            trunc_normal_(mod.weight)
            mod.bias.zero_()
        elif isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight
            fan_in = w[0].numel() if not isinstance(mod, nn.ConvTranspose2d) \
                else w.shape[0] * w.shape[2] * w.shape[3]
            uniform_(w, fan_in ** -0.5)
            if mod.bias is not None:
                uniform_(mod.bias, fan_in ** -0.5)
        elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
            mod.reset_parameters()
        elif hasattr(mod, "relative_position_bias_table"):
            trunc_normal_(mod.relative_position_bias_table)
    return model


class SPEINet(nn.Module):
    """Parity: model/speinet.py:28-168 (inference)."""

    def __init__(self, n_sequence: int = 3, n_feat: int = 32,
                 n_resblock: int = 3, out_channels: int = 3,
                 embed_dim: int = 256,
                 depths: Sequence[int] = (6, 6, 6, 6, 6, 6),
                 num_heads: Sequence[int] = (8, 8, 8, 8, 8, 8),
                 window_size: int = 5, mlp_ratio: float = 2.0,
                 drop_path_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32, *,
                 swin_fuse_block: bool = True, corr_raw: bool = True,
                 corr_banded: bool = True, corr_scaled: bool = True):
        super().__init__()
        if n_sequence < 1:
            raise ValueError(f"n_sequence {n_sequence}: a window has a frame")
        f = n_feat
        self.n_sequence = n_sequence
        self.dtype = dtype
        self.corr_paths = dict(corr_raw=corr_raw, corr_banded=corr_banded,
                               corr_scaled=corr_scaled)
        self.recons_net = ReconsVideo(f, n_resblock, out_channels)
        self.swin = SwinIRCross(4 * f, embed_dim, depths, num_heads,
                                window_size, mlp_ratio, drop_path_rate,
                                fuse_block=swin_fuse_block)
        self.conv_lv1 = nn.Conv2d(2 * f, f, 1)
        self.conv_lv2 = nn.Conv2d(4 * f, 2 * f, 1)
        self.conv_lv3 = nn.Conv2d(8 * f, 4 * f, 1)
        self.fusion = nn.Conv2d(4 * f * n_sequence, 4 * f, 1)   # centre + neighbours
        self.search3 = nn.Conv2d(2 * f, 2 * f, 3, padding=1)
        self.search2 = nn.Conv2d(4 * f, 2 * f, 1)
        self.search1 = nn.Conv2d(4 * f, 2 * f, 1)
        self.search43 = nn.Conv2d(f, f, 3, padding=1)
        self.search33 = nn.Conv2d(2 * f, f, 3, padding=1)
        self.search23 = nn.Conv2d(2 * f, f, 1)     # defined, unused (parity)
        self.search13 = nn.Conv2d(2 * f, f, 1)
        self.SelfTransfer = SelfTransfer(f)

    @classmethod
    def from_config(cls, cfg: Config, **paths: bool) -> "SPEINet":
        """The model `cfg` describes; `paths` are the keyword-only switches."""
        return cls(n_sequence=cfg.n_sequence, n_feat=cfg.n_feat,
                   n_resblock=cfg.n_resblock, out_channels=cfg.n_colors,
                   embed_dim=cfg.embed_dim, depths=tuple(cfg.depths),
                   num_heads=tuple(cfg.num_heads), window_size=cfg.window_size,
                   mlp_ratio=cfg.mlp_ratio, drop_path_rate=cfg.drop_path_rate,
                   dtype=compute_dtype(cfg),
                   **paths)

    def _fast(self, conv: nn.Conv2d, x: torch.Tensor, train: bool) -> torch.Tensor:
        """3x3 refinement conv + ReLU through K1, bias rounded to the compute
        dtype first (FastConv, speinet_tpu/models/blocks.py:291-296); a
        PyTorch conv in training."""
        return conv_k1(x, conv, True, self.dtype, round_bias=True, train=train)

    def _c1(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return conv1x1(x, conv, self.dtype)

    def _decode(self, f_fusion, weight_s, t_lv3, t_lv2, t_lv1, train: bool = False):
        """Decoder with S-weighted texture injection and multi-scale cross
        refinement (parity: speinet.py:92-120)."""
        r, dt = self.recons_net, self.dtype
        up = bicubic_upsample_nhwc
        fast = lambda conv, x: self._fast(conv, x, train)
        sharp_v3 = self._c1(self.conv_lv3, torch.cat([f_fusion, t_lv3], -1)) * weight_s
        f_lv3 = f_fusion + sharp_v3
        decoder_v2 = r.decode_second(f_lv3, dt, train)
        w2 = up(weight_s, 2).to(dt)
        f_v2 = self._c1(self.conv_lv2, torch.cat([decoder_v2, t_lv2], -1)) * w2
        f_lv2 = decoder_v2 + f_v2

        search_1 = torch.relu(self._c1(self.search1, up(f_lv3, 2)))
        search_2 = fast(self.search3, f_lv2)
        search_11 = torch.relu(self._c1(self.search2,
                                        torch.cat([decoder_v2, search_1], -1)))
        search_22 = torch.relu(self._c1(self.search2,
                                        torch.cat([f_lv2, search_2], -1)))
        f_v3 = decoder_v2 + search_11
        f_lv2 = f_lv2 + search_22

        decoder_v1 = r.decode_first(f_lv2, dt, train)
        w4 = up(weight_s, 4).to(dt)
        f_v1 = self._c1(self.conv_lv1, torch.cat([decoder_v1, t_lv1], -1)) * w4
        f_lv1 = decoder_v1 + f_v1

        search_13 = torch.relu(self._c1(self.search13, up(f_v3, 2)))
        search_23 = fast(self.search33, up(f_lv2, 2))
        search_33 = fast(self.search43, f_lv1)
        search_113 = fast(self.search33, torch.cat([search_13, search_23], -1))
        search_223 = fast(self.search33, torch.cat([search_13, search_33], -1))
        search_323 = fast(self.search33, torch.cat([search_23, search_33], -1))
        f_lv1 = f_lv1 + search_113 + search_223 + search_323
        return r.out_block(f_lv1, dt, train)

    @torch.no_grad()
    def encode_window_legs(self, frames: torch.Tensor):
        """frames [F, 3, H, W] -> (M, N) lv3 features:
        M = enc(f) + enc(RL5(f)) (centre leg), N = enc(f) + enc(RL1(f))."""
        dt = self.dtype
        nhwc = lambda t: t.permute(0, 2, 3, 1).to(dt)
        f32 = frames.float()
        kernel = box_kernel(5, device=frames.device)
        rl1 = richardson_lucy(f32, kernel, 1, 0.01, box_size=5)
        rl5 = richardson_lucy(f32, kernel, 5, 0.01, box_size=5)
        stack = torch.cat([nhwc(frames), nhwc(rl1), nhwc(rl5)], dim=0).contiguous()
        _, _, lv3 = self.recons_net.encode_pyramid(stack, dt)
        n = frames.shape[0]
        e, e1, e5 = lv3[:n], lv3[n:2 * n], lv3[2 * n:]
        return e + e5, e + e1

    @torch.no_grad()
    def anchor_pyramid(self, frames: torch.Tensor):
        """Sharp-anchor pyramid [F, 3, H, W] -> (lv1, lv2, lv3) NHWC."""
        nhwc = frames.permute(0, 2, 3, 1).to(self.dtype).contiguous()
        return self.recons_net.encode_pyramid(nhwc, self.dtype)

    def restore_from_features(self, f_mid, neighbor_feats, sharp_lv1, sharp_lv2,
                              sharp_lv3, routing: str,
                              has_sharp: torch.Tensor | None = None,
                              train: bool = False,
                              generator: torch.Generator | None = None
                              ) -> torch.Tensor:
        """Fusion + transfer + decode for a batch whose routing the host
        knows ('sharp' or 'self'), or per sample ('mixed', with `has_sharp`
        [B] bool), from the centre's features and any number of neighbour
        streams. Returns [B, 3, H, W] float32. Without autograd unless
        `train`, which takes the training forms as `forward` does."""
        if not train:
            with torch.no_grad():
                return self._restore(f_mid, neighbor_feats, sharp_lv1, sharp_lv2,
                                     sharp_lv3, routing, has_sharp)
        return self._restore(f_mid, neighbor_feats, sharp_lv1, sharp_lv2,
                             sharp_lv3, routing, has_sharp, True, generator)

    def _restore(self, f_mid, neighbor_feats, sharp_lv1, sharp_lv2, sharp_lv3,
                 routing: str, has_sharp: torch.Tensor | None = None,
                 train: bool = False,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        b = f_mid.shape[0]
        with span("restore.fusion", b, device=True):
            f_fusion = swin_fuse(self.swin, f_mid, neighbor_feats, self.dtype, train,
                                 generator)
            f_fusion = self._c1(self.fusion, f_fusion)
        with span("restore.transfer", b, device=True):
            weight_s, t3, t2, t1 = transfer(self.SelfTransfer, f_fusion, sharp_lv1,
                                            sharp_lv2, sharp_lv3, routing, self.dtype,
                                            has_sharp, **self.corr_paths)
        with span("restore.decode", b, device=True):
            out = self._decode(f_fusion, weight_s.to(self.dtype), t3, t2, t1, train)
            return out.permute(0, 3, 1, 2).float()

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x [B, n_sequence + 2, 3, H, W]: the window's frames, the pre-sharp
        and the sub-sharp frame -> the restored centre frame [B, 3, H, W]
        float32 (parity: speinet.py:215-274). A sample routes to the sharp
        search when frame 3 is not all zero, while the sharp pyramid encodes
        the sub-sharp frame: the reference's quirk, kept. RL5 of the centre
        frame, RL1 of every neighbour and all 3 + 2 (n_sequence - 1) encoder
        legs run as batched calls.

        Inference runs without autograd. With `train` autograd is on, the
        convs and Swin blocks take their training forms, the BatchNorm
        gates normalise with the batch statistics of the stacked legs and
        update their running statistics, and DropPath draws from
        `generator`."""
        with span("model.forward", device=True):
            if not train:
                with torch.no_grad():
                    return self._forward(x, False, None)
            return self._forward(x, True, generator)

    def _forward(self, x: torch.Tensor, train: bool,
                 generator: torch.Generator | None) -> torch.Tensor:
        dt, ns = self.dtype, self.n_sequence
        b = x.shape[0]
        # the JAX package reads x[:, 3]; XLA clamps that static index to the
        # last frame where the window is shorter (n_sequence 1: the
        # sub-sharp frame), which torch would refuse
        flag = x[:, min(3, ns + 1)]
        has_sharp = ~(flag == 0).flatten(1).all(dim=1)
        nhwc = x.permute(0, 1, 3, 4, 2)
        mid_i = ns // 2
        mid = nhwc[:, mid_i].to(dt)
        neighbors = [nhwc[:, i].to(dt) for i in range(ns) if i != mid_i]
        sharp = nhwc[:, ns + 1].to(dt)
        kernel = box_kernel(5, device=x.device)
        rl = lambda t, n: richardson_lucy(t.permute(0, 3, 1, 2).float(), kernel, n,
                                          0.01, box_size=5).permute(0, 2, 3, 1).to(dt)
        with span("model.legs", device=True):
            # legs in the JAX order: sharp, mid, RL5(mid), then (n, RL1(n))
            # for each neighbour, whose RL runs as one call
            legs = [sharp, mid, rl(mid, 5)]
            if neighbors:
                deb_nb = rl(torch.cat(neighbors, dim=0), 1)
                for k, nb in enumerate(neighbors):
                    legs += [nb, deb_nb[k * b:(k + 1) * b]]
            lv1, lv2, lv3 = self.recons_net.encode_pyramid(
                torch.cat(legs, dim=0).contiguous(), dt, train)
        leg = lambda k: lv3[k * b:(k + 1) * b]
        f_mid = leg(1) + leg(2)
        neighbor_feats = [leg(3 + 2 * k) + leg(4 + 2 * k)
                          for k in range(len(neighbors))]
        return self._restore(f_mid, neighbor_feats, lv1[:b], lv2[:b], lv3[:b],
                             "mixed", has_sharp, train, generator)
