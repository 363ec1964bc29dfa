"""Single configuration system for training + inference.

The port's own copy of `speinet_tpu/config.py` (the port imports nothing of
the JAX package); keep the two in step. Replaces the reference's three
parallel config paths (argparse singleton `option/__init__.py:1-107`,
template overlay `option/template.py:1-49`, and the hardcoded preset block in
`inference_SPEINet.py:610-697`) with one dataclass.
Every knob of the reference is preserved; template names ('SPEINet',
'SPEINet_REDS') resolve to the same hyperparameters as
`option/template.py:2-47`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Sequence


@dataclass
class Config:
    # -- template ------------------------------------------------------------
    template: str = "SPEINet"
    task: str = "VideoDeblur"

    # -- hardware ------------------------------------------------------------
    n_threads: int = 8            # host-side decode threads
    seed: int = 1
    # TPU-native replacement for the reference's `n_GPUs` DataParallel flag:
    # number of data-parallel mesh devices (0 = use all local devices).
    dp_devices: int = 0
    compute_dtype: str = "float32"   # 'float32' | 'bfloat16' for the hot path
    param_dtype: str = "float32"

    # -- data ----------------------------------------------------------------
    dir_data: str = "./dataset/train"
    dir_data_test: str = "./dataset/val"
    data_train: str = "DVD_NFS"
    data_test: str = "DVD_NFS"
    process: bool = False          # preload whole dataset into RAM
    patch_size: int = 200
    size_must_mode: int = 4
    rgb_range: float = 1.0
    n_colors: int = 3
    no_augment: bool = False
    n_frames_per_video: int = 200

    # -- model ---------------------------------------------------------------
    model: str = "SPEINet"
    pre_train: str = "."
    n_sequence: int = 3
    n_feat: int = 32
    n_resblock: int = 3
    # cross-frame Swin fusion (reference `model/speinet.py:40-49`)
    window_size: int = 5
    depths: List[int] = field(default_factory=lambda: [6, 6, 6, 6, 6, 6])
    embed_dim: int = 256
    num_heads: List[int] = field(default_factory=lambda: [8, 8, 8, 8, 8, 8])
    mlp_ratio: float = 2.0
    resi_connection: str = "1conv"
    drop_path_rate: float = 0.1    # SwinIR default (swinir.py:651)

    # -- training ------------------------------------------------------------
    test_every: int = 1000
    epochs: int = 500
    batch_size: int = 20
    test_only: bool = False
    loss: str = "1*L1+2*HEM"
    lr: float = 1e-4
    lr_decay: int = 150
    gamma: float = 0.5
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    weight_decay: float = 0.0
    mid_loss_weight: float = 1.0
    bn_recalib: int = 0            # >0: recompute BN stats over N train batches
                                   # before each eval/checkpoint (SWA-style;
                                   # fixes the EMA lag of the unbounded
                                   # TripletAttention gates early in training)

    # -- logging / checkpointing --------------------------------------------
    experiment_dir: str = "./experiment/"
    save: str = "speinet_tpu"
    save_middle_models: bool = False
    load: str = "."
    resume: bool = False
    print_every: int = 100
    save_images: bool = True

    # -- inference -----------------------------------------------------------
    border: bool = True            # reflect-pad video ends (inference_SPEINet.py:614)
    chop: bool = False             # spatial 4-tile forward (forward_chop analog)
    chop_shave: int = 20

    @property
    def n_feat4(self) -> int:
        return self.n_feat * 4

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "Config":
        return Config(**json.loads(s))


def set_template(cfg: Config) -> Config:
    """Apply the named template overlay (parity: option/template.py:1-49)."""
    if cfg.template == "SPEINet":
        return cfg.replace(
            task="VideoDeblur", model="SPEINet", n_sequence=3, patch_size=200,
            n_frames_per_video=200, n_feat=32, n_resblock=3, size_must_mode=4,
            loss="1*L1+2*HEM", lr=1e-4, lr_decay=150, window_size=5,
            depths=[6] * 6, embed_dim=256, num_heads=[8] * 6, mlp_ratio=2.0,
            resi_connection="1conv", data_train="DVD_NFS", data_test="DVD_NFS",
            batch_size=20,
        )
    if cfg.template == "SPEINet_REDS":
        return cfg.replace(
            task="VideoDeblur", model="SPEINet", n_sequence=3, patch_size=200,
            n_frames_per_video=200, n_feat=32, n_resblock=3, size_must_mode=4,
            loss="1*L1+2*HEM", lr=5e-5, lr_decay=200, window_size=5,
            depths=[6] * 6, embed_dim=256, num_heads=[8] * 6, mlp_ratio=2.0,
            resi_connection="1conv", data_train="DVD_NFS", data_test="DVD_NFS",
            batch_size=20,
        )
    if cfg.template == "SWINT":
        # ablation model (reference model/swint.py): no sharp path, no RL branch
        return cfg.replace(
            task="VideoDeblur", model="SWINT", n_sequence=3, patch_size=200,
            n_feat=32, n_resblock=3, size_must_mode=4, loss="1*L1+2*HEM",
            window_size=5, depths=[6] * 6, embed_dim=256, num_heads=[8] * 6,
            mlp_ratio=2.0, resi_connection="1conv", batch_size=20,
        )
    if cfg.template == "none":
        return cfg
    raise NotImplementedError(f"Template [{cfg.template}] is not found")


def parse_args(argv: Optional[Sequence[str]] = None) -> Config:
    """CLI with the reference's flag surface (option/__init__.py)."""
    defaults = Config()
    p = argparse.ArgumentParser(description="SPEINet-TPU Video Deblurring")
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        default = getattr(defaults, f.name)
        if isinstance(default, bool):
            p.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                           default=default)
        elif isinstance(default, list):
            p.add_argument(name, type=int, nargs="+", default=default)
        else:
            p.add_argument(name, type=type(default), default=default)
    ns = p.parse_args(argv)
    cfg = Config(**vars(ns))
    cfg = set_template(cfg)
    # re-apply explicit CLI overrides on top of the template (unlike the
    # reference, where the template silently clobbers CLI values)
    explicit = {a.replace("--", "").split("=")[0] for a in (argv or []) if a.startswith("--")}
    overrides = {k: getattr(ns, k) for k in explicit if k in vars(ns) and k != "template"}
    if overrides:
        cfg = cfg.replace(**overrides)
    if cfg.epochs == 0:
        cfg = cfg.replace(epochs=int(1e8))  # parity: option/__init__.py:100-101
    return cfg
