"""Optimizer, learning-rate schedule and the train / eval steps (port of
`speinet_tpu/training/train_state.py`; parity: trainer/trainer.py:24-30).

- `lr_for_epoch`: StepLR stepped at the top of each epoch
  (trainer_swint_hsa_nsf.py:20), so epoch e (1-based) trains with
  lr * gamma^floor(e / lr_decay), the one-epoch-early decay included.
- `make_optimizer`: torch Adam. Its weight decay adds wd * param to the
  gradient before the moments, which is optax's `add_decayed_weights` ahead
  of `scale_by_adam` in the JAX package. The trainer sets the learning
  rate on the param group at each epoch.
- `make_gan_state`: the discriminator and its Adam state where the loss
  spec has a GAN term (`create_train_state`, train_state.py:41-51), drawn
  from a generator seeded seed + 7 where the JAX package folds 7 into its
  key.
- `train_step`: forward in training form, loss, backward, Adam step; with
  a discriminator, then its own step on the same batch and the detached
  output at the generator's learning rate. Under a process group each rank
  steps on its rows of the global batch: the loss and the gates' batch
  statistics are those of the global batch, DropPath and HEM keep their
  rows of the global draws, and the gradients (the discriminator's too)
  are averaged over the group before Adam, so every rank takes the
  single-process step on the global batch (`parallel/mesh.py`).
- `recalibrate_batch_stats`: the BatchNorm running statistics replaced by
  the average of per-batch statistics under the current weights (:138-163);
  under a group every rank runs its forwards in step, each on its rows.
- `eval_step`: the inference forward.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch
import torch.nn as nn

from speinet_tpu_torch.config import Config
from speinet_tpu_torch.models.blocks import BN_MOMENTUM
from speinet_tpu_torch.parallel.mesh import average_gradients
from speinet_tpu_torch.training.adversarial import (GanState, discriminator_step,
                                                    init_gan_state)
from speinet_tpu_torch.training.loss import LossComputer, parse_loss_spec
from speinet_tpu_torch.utils.spans import span


def lr_for_epoch(cfg: Config, epoch: int) -> float:
    """StepLR with step-at-top-of-epoch semantics (1-based epoch)."""
    return cfg.lr * (cfg.gamma ** (epoch // cfg.lr_decay))


def make_optimizer(cfg: Config, model: nn.Module) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=cfg.lr,
                            betas=(cfg.beta1, cfg.beta2), eps=cfg.epsilon,
                            weight_decay=cfg.weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def make_gan_state(cfg: Config, device="cuda") -> GanState | None:
    """The discriminator state a GAN loss spec needs, else None; on the card
    unless `device` is the CPU."""
    if not any("GAN" in name for _, name in parse_loss_spec(cfg.loss)):
        return None
    return init_gan_state(torch.Generator().manual_seed(cfg.seed + 7), device)


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
               loss_computer: LossComputer, inp: torch.Tensor, gt: torch.Tensor,
               generator: torch.Generator | None = None,
               gan: GanState | None = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One step on inp [B, n_sequence + 2, 3, H, W] against gt [B, 3, H, W];
    DropPath and HEM draw from `generator`. With `gan` (a GAN spec), D's
    step follows the model's, as in `make_train_step`, and its loss is the
    'DIS' component. Returns the detached loss and its components, left on
    the device. The model's gradients stay in `.grad`."""
    optimizer.zero_grad(set_to_none=True)
    out = model(inp, train=True, generator=generator)
    with span("train.loss", device=True):
        total, comps = loss_computer(out, gt, generator, gan)
    with span("train.backward", device=True):
        total.backward()
        average_gradients(model.parameters())
    with span("train.optimizer", device=True):
        optimizer.step()
    comps = {k: v.detach() for k, v in comps.items()}
    if loss_computer.has_gan:
        comps["DIS"] = discriminator_step(gan, out, gt, optimizer.param_groups[0]["lr"],
                                          loss_computer.rgb_range)
    return total.detach(), comps


def _bn_layers(model: nn.Module) -> List[nn.BatchNorm2d]:
    return [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]


@torch.no_grad()
def recalibrate_batch_stats(model: nn.Module, inputs: Iterable[torch.Tensor],
                            generator: torch.Generator | None = None) -> None:
    """SWA-style BatchNorm recalibration: each running statistic becomes the
    plain average, over the batches `inputs`, of that batch's statistic
    under the current weights. As in the JAX package, a batch's statistic
    is read back from one training-form forward from the unchanged running
    statistics: batch = (new - m old) / (1 - m), m = BN_MOMENTUM. Nothing
    else changes."""
    bns = _bn_layers(model)
    if not bns:
        return
    old = [(bn.running_mean.clone(), bn.running_var.clone(),
            bn.num_batches_tracked.clone()) for bn in bns]
    acc = [[torch.zeros_like(bn.running_mean), torch.zeros_like(bn.running_var)]
           for bn in bns]
    n = 0
    for inp in inputs:
        for bn, (m0, v0, t0) in zip(bns, old):
            bn.running_mean.copy_(m0)
            bn.running_var.copy_(v0)
            bn.num_batches_tracked.copy_(t0)
        model(inp, train=True, generator=generator)
        for a, bn, (m0, v0, _) in zip(acc, bns, old):
            a[0] += (bn.running_mean - BN_MOMENTUM * m0) / (1.0 - BN_MOMENTUM)
            a[1] += (bn.running_var - BN_MOMENTUM * v0) / (1.0 - BN_MOMENTUM)
        n += 1
    for a, bn, (m0, v0, t0) in zip(acc, bns, old):
        bn.running_mean.copy_(a[0] / n if n else m0)
        bn.running_var.copy_(a[1] / n if n else v0)
        bn.num_batches_tracked.copy_(t0)


@torch.no_grad()
def eval_step(model: nn.Module, inp: torch.Tensor) -> torch.Tensor:
    return model(inp)
