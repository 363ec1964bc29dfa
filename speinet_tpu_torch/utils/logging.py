"""Experiment logger / metric accumulators (port of
`speinet_tpu/utils/logging.py`; parity: log/log.py).

Directory layout matches the reference:
    {experiment_dir}/{save}/
        model/               (checkpoints)
        result/{data_test}/  (image dumps)
        log.txt              (tee'd text log)
        config.txt           (config dump, appended per run)
        loss.npy, psnr.npy   (metric logs; the reference uses torch .pt)
        loss_components.npy  (per-epoch per-loss-type matrix,
                              parity: Loss/__init__.py:126-128 loss_log.pt)
        psnr.pdf, loss.pdf, loss_loss_{type}.pdf  (plots; per-type plots
                              parity: Loss/__init__.py:105-118)
Resume (`--load`) restores the metric logs so the epoch counter and the
LR fast-forward match the reference semantics (log/log.py:25-31).
imageio (image dumps) and matplotlib (plots) are imported where used.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List

import numpy as np

from speinet_tpu_torch.config import Config


class Logger:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.psnr_log: List[float] = []
        self.loss_log: List[float] = []
        # per-epoch per-component matrix (rows [n_components]); column names
        # fixed on the first start_log (parity: Loss/__init__.py:48-49,92)
        self.comp_names: List[str] = []
        self.comp_log: List[np.ndarray] = []

        if cfg.load == ".":
            save = cfg.save if cfg.save != "." else \
                datetime.datetime.now().strftime("%Y%m%d_%H:%M")
            self.dir = os.path.join(cfg.experiment_dir, save)
        else:
            self.dir = os.path.join(cfg.experiment_dir, cfg.load)
            if os.path.exists(os.path.join(self.dir, "psnr.npy")):
                self.psnr_log = list(np.load(os.path.join(self.dir, "psnr.npy")))
                self.loss_log = list(np.load(os.path.join(self.dir, "loss.npy")))
                comp_path = os.path.join(self.dir, "loss_components.npy")
                if os.path.exists(comp_path):
                    mat = np.load(comp_path)
                    names_path = os.path.join(self.dir, "loss_components_names.txt")
                    with open(names_path) as f:
                        self.comp_names = f.read().split()
                    self.comp_log = [row for row in mat]
                print(f"Continue from epoch {len(self.psnr_log)}...")

        os.makedirs(os.path.join(self.dir, "model"), exist_ok=True)
        os.makedirs(os.path.join(self.dir, "result", cfg.data_test), exist_ok=True)
        open_type = "a" if os.path.exists(os.path.join(self.dir, "log.txt")) else "w"
        self.log_file = open(os.path.join(self.dir, "log.txt"), open_type)
        with open(os.path.join(self.dir, "config.txt"), open_type) as f:
            f.write(f"From epoch {len(self.psnr_log)}...\n\n")
            f.write(cfg.to_json() + "\n\n")

        self._cur_loss = 0.0
        self._cur_psnr = 0.0

    def write_log(self, log: str):
        print(log, flush=True)
        self.log_file.write(log + "\n")
        self.log_file.flush()

    # start/report/end accumulator protocol (log/log.py:83-99); the
    # per-component columns mirror Loss/__init__.py:92-94 (start_log
    # appends a zero row, end_log divides by the batch count)
    def start_log(self, train: bool = True, comp_names: List[str] = None):
        if train:
            self.loss_log.append(0.0)
            if comp_names:
                if not self.comp_names:
                    self.comp_names = list(comp_names)
                self.comp_log.append(np.zeros(len(self.comp_names)))
        else:
            self.psnr_log.append(0.0)

    def report_log(self, item: float, train: bool = True,
                   components: Dict[str, float] = None):
        if train:
            self.loss_log[-1] += item
            if components and self.comp_names and len(self.comp_log):
                self.comp_log[-1] += np.asarray(
                    [components.get(n, 0.0) for n in self.comp_names])
        else:
            self.psnr_log[-1] += item

    def end_log(self, n_div: int, train: bool = True):
        if train:
            self.loss_log[-1] /= n_div
            if self.comp_log:
                self.comp_log[-1] = self.comp_log[-1] / n_div
        else:
            self.psnr_log[-1] /= n_div

    def save_metrics(self):
        np.save(os.path.join(self.dir, "psnr.npy"), np.asarray(self.psnr_log))
        np.save(os.path.join(self.dir, "loss.npy"), np.asarray(self.loss_log))
        self.plot(self.psnr_log, "PSNR", "psnr.pdf")
        self.plot(self.loss_log, "Loss", "loss.pdf")
        if self.comp_names and self.comp_log:
            mat = np.stack(self.comp_log)
            np.save(os.path.join(self.dir, "loss_components.npy"), mat)
            with open(os.path.join(self.dir, "loss_components_names.txt"),
                      "w") as f:
                f.write(" ".join(self.comp_names))
            # one plot per loss type (parity: Loss/__init__.py:105-118
            # emits loss_loss_{type}.pdf)
            for i, name in enumerate(self.comp_names):
                self.plot(list(mat[:, i]), f"{name} Loss",
                          f"loss_loss_{name}.pdf")

    def plot(self, values, label: str, filename: str):
        if not values:
            return
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        axis = np.arange(1, len(values) + 1)
        fig = plt.figure()
        plt.title(f"{label} Graph")
        plt.plot(axis, np.asarray(values), label=label)
        plt.legend()
        plt.xlabel("Epochs")
        plt.ylabel(label)
        plt.grid(True)
        plt.savefig(os.path.join(self.dir, filename))
        plt.close(fig)

    def save_images(self, filename: str, images, epoch: int):
        """filename 'video.frame'; images: list of HWC uint8 arrays in
        (gt, blur, deblur) order (parity: log/log.py:63-81)."""
        import imageio.v2 as imageio

        f = filename.split(".")
        dirname = os.path.join(self.dir, "result", self.cfg.data_test, f[0])
        os.makedirs(dirname, exist_ok=True)
        postfix = ["gt", "blur", "deblur_iter1", "deblur_iter2"]
        for img, post in zip(images, postfix):
            imageio.imwrite(os.path.join(dirname, f"{f[1]}_{post}.png"),
                            np.asarray(img))

    def done(self):
        self.log_file.close()
