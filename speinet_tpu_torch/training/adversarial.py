"""Adversarial (GAN) loss plugin (port of
`speinet_tpu/training/adversarial.py`; the reference's `loss.adversarial`, a
module its repository does not have).

The discriminator is a norm-free conv net: three stages of (3x3 stride-2
conv, LeakyReLU 0.2, 3x3 conv, LeakyReLU 0.2) at 64 / 128 / 256 channels, a
3x3 conv to one channel of patch logits, and their mean as the logit of
each image. Inputs are NCHW in [0, rgb_range], mapped to [-1, 1]. The
losses are the non-saturating BCE pair

    L_G   = BCE(D(out), 1)                       D's weights frozen
    L_DIS = BCE(D(gt), 1) + BCE(D(out.detach()), 0)

The discriminator and its Adam state (`GanState`) live beside the model's;
`discriminator_step` makes one Adam update (optax `scale_by_adam`'s
defaults: b1 0.9, b2 0.999, eps 1e-8) at the generator's current learning
rate, so D follows the same schedule. Its parameters are `convs.{i}`, the
flax tree's `Conv_{i}` (`utils/convert.py::discriminator_from_flax`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from speinet_tpu_torch.parallel.mesh import average_gradients
from speinet_tpu_torch.utils.device import resolve_device

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


class Discriminator(nn.Module):
    """Stride-2 conv pyramid + mean logit; any input size."""

    def __init__(self, features: Tuple[int, ...] = (64, 128, 256)):
        super().__init__()
        convs, cin = [], 3
        for f in features:
            convs += [nn.Conv2d(cin, f, 3, stride=2, padding=1),
                      nn.Conv2d(f, f, 3, padding=1)]
            cin = f
        convs.append(nn.Conv2d(cin, 1, 3, padding=1))
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, 3, H, W] in [-1, 1] -> logits [B]."""
        for conv in self.convs[:-1]:
            x = F.leaky_relu(conv(x), 0.2)
        return self.convs[-1](x).mean(dim=(1, 2, 3))


@dataclass
class GanState:
    """The discriminator and its optimizer (the JAX package's TrainState.gan)."""
    dis: Discriminator
    opt: torch.optim.Adam


def init_gan_state(generator: torch.Generator, device="cuda") -> GanState:
    """A discriminator drawn from `generator` as flax's Conv init is in
    distribution (kernels a standard normal clipped at +-2 and scaled by
    1 / (0.8796 sqrt(fan_in)), its truncated LeCun normal; zero biases),
    and a fresh Adam, on the card unless `device` is the CPU; the learning
    rate is set at each step."""
    device = resolve_device(device)
    dis = Discriminator()
    with torch.no_grad():
        for conv in dis.convs:
            w = conv.weight
            std = (w[0].numel() ** -0.5) / 0.87962566103423978
            w.copy_(torch.randn(w.shape, generator=generator).clamp_(-2, 2) * std)
            conv.bias.zero_()
    dis.to(device)
    return GanState(dis, torch.optim.Adam(dis.parameters(), lr=0.0,
                                          betas=ADAM_BETAS, eps=ADAM_EPS))


def prep(x_nchw: torch.Tensor, rgb_range: float) -> torch.Tensor:
    """[0, rgb_range] -> [-1, 1], float32."""
    return x_nchw.float() / rgb_range * 2.0 - 1.0


def bce_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean BCE-with-logits against a constant target, in the stable form."""
    return (torch.clamp(logits, min=0.0) - logits * target
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def generator_loss(gan: GanState, out: torch.Tensor,
                   rgb_range: float = 255.0) -> torch.Tensor:
    """BCE(D(out), 1) with D's weights frozen: the gradient reaches `out`
    only (D updates in `discriminator_step`)."""
    frozen = {k: v.detach() for k, v in gan.dis.named_parameters()}
    logits = torch.func.functional_call(gan.dis, frozen, (prep(out, rgb_range),))
    return bce_logits(logits, 1.0)


def discriminator_step(gan: GanState, out: torch.Tensor, gt: torch.Tensor,
                       lr: float, rgb_range: float = 255.0) -> torch.Tensor:
    """One Adam update of D on (gt -> 1, out.detach() -> 0) at rate `lr`,
    its gradient averaged over the process group where one is open; returns
    D's loss before the update, detached."""
    for group in gan.opt.param_groups:
        group["lr"] = lr
    gan.opt.zero_grad(set_to_none=True)
    loss = (bce_logits(gan.dis(prep(gt, rgb_range)), 1.0)
            + bce_logits(gan.dis(prep(out.detach(), rgb_range)), 0.0))
    loss.backward()
    average_gradients(gan.dis.parameters())
    gan.opt.step()
    return loss.detach()
