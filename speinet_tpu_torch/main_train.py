"""Training entry point (port of `speinet_tpu/main_train.py`; parity:
main_SPEINet.py).

    python -m speinet_tpu_torch.main_train --template SPEINet \\
        --dir_data <train-tree> --dir_data_test <val-tree> \\
        --experiment_dir ./experiment --save myrun

The model is the one the config names (`--template SPEINet` or `SWINT`,
or `--model`), built by `models.make_model`. Runs on the card (`--device
cuda`, the default; it raises without one) in bfloat16 with float32
parameters unless `--compute_dtype` is given, which the card refuses
unless it is bfloat16. `--device cpu` trains the plain
float32 path on the CPU. Every other flag is the config's
(`speinet_tpu_torch/config.py`), `--n_sequence` and a `--loss` spec with
VGG or GAN terms (`training/loss.py`) among them.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from speinet_tpu_torch.config import parse_args
from speinet_tpu_torch.data.loader import Data
from speinet_tpu_torch.models import make_model
from speinet_tpu_torch.models.speinet import init_weights
from speinet_tpu_torch.training.trainer import Trainer
from speinet_tpu_torch.utils.device import resolve_device
from speinet_tpu_torch.utils.logging import Logger


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="SPEINet / SWINT training on PyTorch")
    p.add_argument("--device", type=str, default="cuda")
    argv = list(sys.argv[1:] if argv is None else argv)
    args, config_argv = p.parse_known_args(argv)
    cfg = parse_args(config_argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and not any(
            a.split("=")[0] == "--compute_dtype" for a in config_argv):
        cfg = cfg.replace(compute_dtype="bfloat16")   # what the kernels take
    np.random.seed(cfg.seed)   # host-side seed (main_SPEINet.py:10-12)
    torch.manual_seed(cfg.seed)

    chkp = Logger(cfg)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    chkp.write_log(f"devices: [{device} ({name})]")
    model = init_weights(make_model(cfg), cfg.seed)
    t = Trainer(cfg, Data(cfg), model, chkp, device=device)
    while not t.terminate():
        t.train()
        t.test()
    chkp.done()


if __name__ == "__main__":
    main()
