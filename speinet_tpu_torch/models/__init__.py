"""Model registry (port of `speinet_tpu/models/__init__.py`; parity:
model/__init__.py:17-18): a model's name in the config -> the port's class,
and the compute dtype the config names."""

from __future__ import annotations

import torch

from speinet_tpu_torch.config import Config

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: Config) -> torch.dtype:
    """The torch dtype that `cfg.compute_dtype` names (float32 or bfloat16)."""
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}")
    return _DTYPES[cfg.compute_dtype]


def make_model(cfg: Config):
    """The model `cfg.model` names (case-insensitive): 'speinet', 'swint'
    or 'recons_video'."""
    name = cfg.model.lower()
    if name == "speinet":
        from speinet_tpu_torch.models.speinet import SPEINet

        return SPEINet.from_config(cfg)
    if name == "swint":
        from speinet_tpu_torch.models.swint import SWINT

        return SWINT.from_config(cfg)
    if name == "recons_video":
        from speinet_tpu_torch.models.recons_video import ReconsVideo

        return ReconsVideo(n_feat=cfg.n_feat, n_resblock=cfg.n_resblock,
                           out_channels=cfg.n_colors)
    raise NotImplementedError(f"Model [{cfg.model}] is not found")
