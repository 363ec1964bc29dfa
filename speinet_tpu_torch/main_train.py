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

Data-parallel training runs one process per card under torchrun:

    torchrun --standalone --nproc_per_node N -m speinet_tpu_torch.main_train ...

Each process opens the group (nccl on the cards, gloo with `--device cpu`)
and takes cuda:LOCAL_RANK; `--batch_size` is the global batch, which must
divide by N, and `--dp_devices` must be 0 or N (`parallel/mesh.py`).
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
from speinet_tpu_torch.parallel.mesh import check_batch, dp_world, maybe_init_distributed
from speinet_tpu_torch.training.trainer import Trainer
from speinet_tpu_torch.utils.logging import Logger


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="SPEINet / SWINT training on PyTorch")
    p.add_argument("--device", type=str, default="cuda")
    argv = list(sys.argv[1:] if argv is None else argv)
    args, config_argv = p.parse_known_args(argv)
    cfg = parse_args(config_argv)
    device = maybe_init_distributed(args.device)
    n_dp = dp_world(cfg.dp_devices)
    check_batch(cfg.batch_size)
    if device.type == "cuda" and not any(
            a.split("=")[0] == "--compute_dtype" for a in config_argv):
        cfg = cfg.replace(compute_dtype="bfloat16")   # what the kernels take
    np.random.seed(cfg.seed)   # host-side seed (main_SPEINet.py:10-12)
    torch.manual_seed(cfg.seed)

    chkp = Logger(cfg)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    chkp.write_log(f"devices: [{device} ({name})]")
    chkp.write_log(f"dp group: {n_dp} device(s)")
    model = init_weights(make_model(cfg), cfg.seed)
    t = Trainer(cfg, Data(cfg), model, chkp, device=device)
    while not t.terminate():
        t.train()
        t.test()
    chkp.done()


if __name__ == "__main__":
    main()
