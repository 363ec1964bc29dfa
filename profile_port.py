#!/usr/bin/env python3
"""Where the port's 720p inference and its training time go on one CUDA card.

    python3 profile_port.py

Builds the SPEINet template at full width in bf16 with seeded random
weights, encodes three synthetic 1280x720 frames and one sharp anchor, then
profiles three calls of each stage with torch.profiler: the cached engine's
legs (one frame's encoder legs), anchor (one anchor pyramid) and restore
(two windows, as the engine's chunks of chip_smoke.py hold, in 'sharp',
'self' and 'mixed' routing), and the direct engine's forward of two
windows (one with its pre-sharp frame zeroed, so routed per sample). The
restores are profiled again for the `split` (swin_fuse_block=False,
corr_raw=False) and `prescaled` (corr_banded=False, corr_scaled=False)
kernel paths of chip_smoke.py, same weights. Then the training form: a
forward of the template's batch of 20 windows at patch 200 in training
mode with the loss (`1*L1+2*HEM`), and whole train steps (forward, loss,
backward, Adam), on random frames; both again with the VGG and GAN
plugins (`+0.1*VGG22+0.01*GAN`, the discriminator's step included), a
'sharp' restore at n_sequence 5 (four neighbour streams), and the SWINT
template's inference forward of two 720p windows, training forward and
train step. Prints, per
stage, the wall
ms per call (host clock around work ending in a device sync), the
device-busy share (summed kernel time of the profiled calls over the wall
time of as many unprofiled ones), that device time
by class (the port's kernels, cuDNN convolutions, matmuls, the rest:
elementwise, reductions, copies), the kernels that take most of it, and
the host calls that synchronise with the card in one call of the stage
(torch's sync debug mode), by source line. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
import warnings
from collections import Counter

ROOT = os.path.dirname(os.path.abspath(__file__))
WINDOWS = 2   # windows per restore call
STEPS = 3     # profiled calls per stage
# kernel-path switches of the models whose restores are profiled
PATHS = {"default": {}, "split": dict(swin_fuse_block=False, corr_raw=False),
         "prescaled": dict(corr_banded=False, corr_scaled=False)}


# the __global__ functions of speinet_tpu_torch/csrc/
PORT_KERNELS = re.compile(r"\b(conv|banded_corr|corr_unfold|scale|roll|row_gather|"
                          r"swin_attn|swin_block|swin_mlp)_kernel\b")


def kernel_class(name: str) -> str:
    low = name.lower()
    if PORT_KERNELS.search(name):
        return "port kernels"
    if any(t in low for t in ("fprop", "dgrad", "wgrad", "cudnn", "conv")):
        return "convolutions"
    if any(t in low for t in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "matmuls"
    return "elementwise, reductions, copies"


def host_syncs(fn) -> Counter:
    """The calls that synchronise the host with the card during one fn(),
    counted by the source line that made them."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return Counter(f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                   for w in caught if "synchroniz" in str(w.message))


def add_train_stages(stages: dict, cfg, g, tag: str = "") -> None:
    """The train step of the model `cfg` names at the template's batch and
    patch, own weights, with the discriminator where `cfg.loss` has a GAN
    term."""
    import torch
    from speinet_tpu_torch.models import make_model
    from speinet_tpu_torch.models.speinet import init_weights
    from speinet_tpu_torch.training.loss import LossComputer
    from speinet_tpu_torch.training.train_state import (make_gan_state, make_optimizer,
                                                        train_step)

    model = init_weights(make_model(cfg), seed=0).cuda()
    opt = make_optimizer(cfg, model)
    loss = LossComputer(cfg.loss, rgb_range=cfg.rgb_range)
    gan = make_gan_state(cfg, "cuda")
    b, p = cfg.batch_size, cfg.patch_size
    x = torch.rand((b, 5, 3, p, p), generator=g, device="cuda")
    x[1::2, 3] = 0.0
    gt = torch.rand((b, 3, p, p), generator=g, device="cuda")
    tg = torch.Generator(device="cuda").manual_seed(1)

    def forward():
        return loss(model(x, train=True, generator=tg), gt, tg, gan)

    stages[f"train forward + loss ({b} windows, patch {p}{tag})"] = forward
    stages[f"train step ({b} windows, patch {p}{tag})"] = (
        lambda: train_step(model, opt, loss, x, gt, tg, gan))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_port: CUDA is not available", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from speinet_tpu_torch.config import Config, set_template
    from speinet_tpu_torch.models import make_model
    from speinet_tpu_torch.models.speinet import SPEINet, init_weights

    cfg = set_template(Config(template="SPEINet")).replace(compute_dtype="bfloat16")
    models = {k: init_weights(SPEINet.from_config(cfg, **v), seed=0).cuda().eval()
              for k, v in PATHS.items()}
    model = models["default"]
    g = torch.Generator(device="cuda").manual_seed(0)
    frames = torch.rand((4, 3, 720, 1280), generator=g, device="cuda")
    m, n = model.encode_window_legs(frames[:3])
    lv = model.anchor_pyramid(frames[3:4])
    b = WINDOWS
    rep = lambda t: t.expand(b, *t.shape[1:]).contiguous()
    mixed = torch.arange(b, device="cuda") % 2 == 0
    x = torch.stack([frames[[0, 1, 2, 3, 3]]] * b)     # [b, 5, 3, 720, 1280]
    x[1::2, 3] = 0.0
    stages = {
        "legs (1 frame)": lambda: model.encode_window_legs(frames[:1]),
        "anchor (1 frame)": lambda: model.anchor_pyramid(frames[3:4]),
    }
    for path, mdl in models.items():
        for routing in ("sharp", "self", "mixed"):
            stages[f"restore {routing} ({b} windows, {path})"] = (
                lambda mdl=mdl, r=routing: mdl.restore_from_features(
                    rep(m[1:2]), (rep(n[0:1]), rep(n[2:3])), *map(rep, lv), r,
                    mixed if r == "mixed" else None))
    stages[f"direct forward ({b} windows)"] = lambda: model(x)
    # n_sequence 5: the restore fuses four neighbour streams
    five = init_weights(SPEINet.from_config(cfg.replace(n_sequence=5)), seed=0).cuda().eval()
    m5, n5 = five.encode_window_legs(frames[:3])
    lv5 = five.anchor_pyramid(frames[3:4])
    stages[f"restore sharp ({b} windows, n_sequence 5)"] = lambda: five.restore_from_features(
        rep(m5[1:2]), [rep(n5[k:k + 1]) for k in (0, 2, 0, 2)], *map(rep, lv5), "sharp")
    add_train_stages(stages, cfg, g)
    add_train_stages(stages, cfg.replace(loss=cfg.loss + "+0.1*VGG22+0.01*GAN"), g,
                     ", VGG22 + GAN")
    swint_cfg = set_template(Config(template="SWINT")).replace(compute_dtype="bfloat16")
    swint = init_weights(make_model(swint_cfg), seed=0).cuda().eval()
    stages[f"SWINT forward ({b} windows)"] = lambda: swint(x)
    add_train_stages(stages, swint_cfg, g, ", SWINT")
    print(f"device: {torch.cuda.get_device_name(0)}")
    for name, fn in stages.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(STEPS):
            fn()
        torch.cuda.synchronize()
        wall = (time.time() - t0) / STEPS * 1e3       # without the profiler
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(STEPS):
                fn()
            torch.cuda.synchronize()
        # device events only: the host-side op and autograd events carry
        # their children's device time too
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        rows.sort(key=lambda e: e.device_time_total, reverse=True)
        busy = sum(e.device_time_total for e in rows) / 1e3 / STEPS
        classes = {}
        for e in rows:
            c = kernel_class(e.key)
            classes[c] = classes.get(c, 0.0) + e.device_time_total / 1e3 / STEPS
        top = [dict(kernel=e.key[:120], ms=round(e.device_time_total / 1e3 / STEPS, 3),
                    calls=e.count // STEPS) for e in rows[:12]]
        syncs = host_syncs(fn)
        print(json.dumps(dict(stage=name, wall_ms=round(wall, 3),
                              device_busy_ms=round(busy, 3),
                              busy_share=round(busy / wall, 3),
                              by_class={k: round(v, 3) for k, v in classes.items()},
                              top=top, host_syncs=sum(syncs.values()),
                              sync_lines=dict(syncs.most_common(6)))))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
