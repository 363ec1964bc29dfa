"""Loss system: spec-string parser, L1 / MSE / HEM (port of
`speinet_tpu/training/loss.py`; parity: Loss/__init__.py:23-47 and
Loss/hard_example_mining.py).

HEM's mask is the union of the residual's top half per sample (the
threshold is the [k]-th value of the descending sort, as the reference
indexes it) and exactly int(0.1 H W) random pixels. The random part comes
from a uniform draw that `hem_mask` takes as an argument; `LossComputer`
draws it from the generator it is given, on that generator's device. The
mask carries no gradient.

Plugins (Loss/__init__.py:31-36): a name containing 'VGG' is the perceptual
loss (`training/perceptual.py`) at the relu layer its digits name (22 by
default), a name containing 'GAN' the generator's adversarial loss
(`training/adversarial.py`), which needs the discriminator state; a GAN
spec adds a 'DIS' column for the discriminator's own loss, which the train
step fills (Loss/__init__.py:46-47).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from speinet_tpu_torch.training.adversarial import generator_loss
from speinet_tpu_torch.training.perceptual import vgg_loss


def parse_loss_spec(spec: str) -> List[Tuple[float, str]]:
    """'1*L1+2*HEM' -> [(1.0, 'L1'), (2.0, 'HEM')] (Loss/__init__.py:23-26)."""
    out = []
    for part in spec.split("+"):
        weight, name = part.split("*")
        out.append((float(weight), name))
    return out


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).abs().mean()


def mse_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ((x - y) ** 2).mean()


HARD_P = 0.5      # share of pixels kept as hard examples
RANDOM_P = 0.1    # share of pixels kept at random


def hem_mask(x: torch.Tensor, y: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Hard-example-mining mask (parity: hard_example_mining.py:14-40).

    x, y [B, C, H, W]; u [B, H*W] uniform draws. Returns the [B, 1, H, W]
    mask in x's dtype: residual > its k-th largest value (k = int(HARD_P H W),
    per sample) or u > its k'-th largest (k' = int(RANDOM_P H W): exactly k'
    ones for distinct draws)."""
    b, _, h, w = x.shape
    res = (x - y).abs().sum(dim=1).reshape(b, h * w)
    thre = torch.sort(res, dim=1, descending=True).values[:, int(HARD_P * h * w)]
    hard = res > thre[:, None]
    u_thre = torch.sort(u, dim=1, descending=True).values[:, int(RANDOM_P * h * w)]
    rand = u > u_thre[:, None]
    return (hard | rand).to(x.dtype).reshape(b, 1, h, w)


def hem_loss(x: torch.Tensor, y: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """L1 of the mask-weighted tensors, mean over all elements
    (hard_example_mining.py:42-47)."""
    with torch.no_grad():
        mask = hem_mask(x, y, u)
    return (x * mask - y * mask).abs().mean()


class LossComputer:
    """Weighted multi-loss with per-component logging: `total, components =
    computer(out, gt, generator, gan)`; `components` maps each loss name to
    its weighted value, plus 'Total' when there is more than one
    (Loss/__init__.py:48-49, 69-84). `names` are the log's columns, 'DIS'
    included for a GAN spec."""

    def __init__(self, spec: str, rgb_range: float = 255.0):
        self.spec = parse_loss_spec(spec)
        self.rgb_range = rgb_range
        for _, name in self.spec:
            if name not in ("L1", "MSE", "HEM") and "VGG" not in name \
                    and "GAN" not in name:
                raise NotImplementedError(f"Loss type [{name}] is not found")
        self.has_gan = any("GAN" in name for _, name in self.spec)
        self.names = [name for _, name in self.spec]
        if self.has_gan:
            self.names = self.names + ["DIS"]
        if len(self.spec) > 1:
            self.names = self.names + ["Total"]

    def __call__(self, out: torch.Tensor, gt: torch.Tensor,
                 generator: torch.Generator | None = None, gan=None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        comps: Dict[str, torch.Tensor] = {}
        total = 0.0
        for weight, name in self.spec:
            if name == "L1":
                val = l1_loss(out, gt)
            elif name == "MSE":
                val = mse_loss(out, gt)
            elif name == "HEM":
                b, _, h, w = out.shape
                dev = generator.device if generator is not None else out.device
                u = torch.rand((b, h * w), generator=generator, device=dev)
                val = hem_loss(out, gt, u.to(out.device))
            elif "VGG" in name:
                digits = "".join(ch for ch in name if ch.isdigit()) or "22"
                val = vgg_loss(out, gt, conv_index=digits, rgb_range=self.rgb_range)
            else:
                if gan is None:
                    raise ValueError(
                        f"loss spec '{name}' needs the discriminator state: pass "
                        f"gan= (train_state.make_gan_state builds it)")
                val = generator_loss(gan, out, rgb_range=self.rgb_range)
            comps[name] = weight * val
            total = total + comps[name]
        if len(self.spec) > 1:
            comps["Total"] = total
        return total, comps
