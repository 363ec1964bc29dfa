"""Optimizer, learning-rate schedule and the train / eval steps (port of
`speinet_tpu/training/train_state.py`; parity: trainer/trainer.py:24-30).

- `lr_for_epoch`: StepLR stepped at the top of each epoch
  (trainer_swint_hsa_nsf.py:20), so epoch e (1-based) trains with
  lr * gamma^floor(e / lr_decay), the one-epoch-early decay included.
- `make_optimizer`: torch Adam. Its weight decay adds wd * param to the
  gradient before the moments, which is optax's `add_decayed_weights` ahead
  of `scale_by_adam` in the JAX package. The trainer sets the learning
  rate on the param group at each epoch.
- `train_step`: forward in training form, loss, backward, Adam step.
- `recalibrate_batch_stats`: the BatchNorm running statistics replaced by
  the average of per-batch statistics under the current weights (:138-163).
- `eval_step`: the inference forward.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch
import torch.nn as nn

from speinet_tpu_torch.config import Config
from speinet_tpu_torch.models.blocks import BN_MOMENTUM
from speinet_tpu_torch.training.loss import LossComputer


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


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
               loss_computer: LossComputer, inp: torch.Tensor, gt: torch.Tensor,
               generator: torch.Generator | None = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One step on inp [B, 5, 3, H, W] against gt [B, 3, H, W]; DropPath
    and HEM draw from `generator`. Returns the detached loss and its
    components, left on the device. The gradients stay in `.grad`."""
    optimizer.zero_grad(set_to_none=True)
    out = model(inp, train=True, generator=generator)
    total, comps = loss_computer(out, gt, generator)
    total.backward()
    optimizer.step()
    return total.detach(), {k: v.detach() for k, v in comps.items()}


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
