"""Training checkpoints with the reference's latest / best / per-epoch
layout (port of `speinet_tpu/utils/checkpoint.py`; parity:
model/__init__.py:43-84, log/log.py:55-61).

`{model_dir}/model_latest`, `model_best` and, with `save_middle`,
`model_{epoch}` each hold one `torch.save` of {model: state_dict,
optimizer: state_dict, step, epoch}, so a resume restores the optimizer
exactly, and with a GAN loss {gan: {dis, opt}}, the discriminator and its
Adam state (the reference keeps them in loss.pt, Loss/__init__.py:126-128).
A checkpoint without them restores the rest and keeps a fresh
discriminator. A port inference `--model_path` takes the `model` entry.
"""

from __future__ import annotations

import os

import torch


class CheckpointManager:
    def __init__(self, model_dir: str, save_middle: bool = False):
        self.model_dir = os.path.abspath(model_dir)
        self.save_middle = save_middle
        os.makedirs(self.model_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.model_dir, name)

    def save(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
             step: int, epoch: int, is_best: bool = False, gan=None) -> None:
        tree = {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                "step": int(step), "epoch": int(epoch)}
        if gan is not None:
            tree["gan"] = {"dis": gan.dis.state_dict(), "opt": gan.opt.state_dict()}
        names = ["model_latest"]
        if is_best:
            names.append("model_best")
        if self.save_middle:
            names.append(f"model_{epoch}")
        for name in names:
            tmp = self._path(name + ".tmp")
            torch.save(tree, tmp)
            os.replace(tmp, self._path(name))

    def restore(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                which: str = "model_latest", gan=None) -> int | None:
        """Load `which` into model, optimizer and, where both it and the
        checkpoint have one, the discriminator state `gan`; its step, or
        None if absent."""
        path = self._path(which)
        if not os.path.exists(path):
            return None
        tree = torch.load(path, map_location="cpu", weights_only=True)
        model.load_state_dict(tree["model"], strict=True)
        optimizer.load_state_dict(tree["optimizer"])
        if gan is not None and "gan" in tree:
            gan.dis.load_state_dict(tree["gan"]["dis"], strict=True)
            gan.opt.load_state_dict(tree["gan"]["opt"])
        return tree["step"]
