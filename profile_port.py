#!/usr/bin/env python3
"""Where the port's 720p inference time goes on one CUDA card.

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
kernel paths of chip_smoke.py, same weights. Prints, per stage, the wall
ms per call (host clock around work ending in a device sync), the
device-busy share (summed kernel time over wall time) and the kernels that
take most of the device time. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

WINDOWS = 2   # windows per restore call
STEPS = 3     # profiled calls per stage
# kernel-path switches of the models whose restores are profiled
PATHS = {"default": {}, "split": dict(swin_fuse_block=False, corr_raw=False),
         "prescaled": dict(corr_banded=False, corr_scaled=False)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_port: CUDA is not available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from speinet_tpu_torch.config import Config, set_template
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
    print(f"device: {torch.cuda.get_device_name(0)}")
    for name, fn in stages.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            for _ in range(STEPS):
                fn()
            torch.cuda.synchronize()
            wall = (time.time() - t0) / STEPS * 1e3
        rows = [e for e in prof.key_averages()
                if getattr(e, "device_time_total", 0) > 0 and not e.key.startswith("aten::")
                and not e.key.startswith("cuda")]
        rows.sort(key=lambda e: e.device_time_total, reverse=True)
        busy = sum(e.device_time_total for e in rows) / 1e3 / STEPS
        top = [dict(kernel=e.key[:90], ms=round(e.device_time_total / 1e3 / STEPS, 3),
                    calls=e.count // STEPS) for e in rows[:12]]
        print(json.dumps(dict(stage=name, wall_ms=round(wall, 3),
                              device_busy_ms=round(busy, 3),
                              busy_share=round(busy / wall, 3), top=top)))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
