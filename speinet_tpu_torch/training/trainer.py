"""Epoch trainer (port of `speinet_tpu/training/trainer.py`; parity:
trainer/trainer.py + trainer_swint_hsa_nsf.py).

train(): per epoch, set the learning rate by the step-at-top StepLR rule,
iterate batches (the centre GT frame is the target,
trainer_swint_hsa_nsf.py:31-32), one train step each, a log line every
print_every batches in the reference's format; the loss sums stay on the
device between those lines. test(): full-resolution evaluation, PSNR with
a 4-pixel shave, best checkpoint by epoch PSNR, optional image dumps.
terminate(): test_only short-circuit, or epoch >= epochs
(trainer/trainer.py:38-44). The epoch counter resumes from the metric log.

On the card the model computes in bfloat16 with float32 parameters;
DropPath and HEM draw from one generator on the model's device. A loss
spec with a GAN term trains a discriminator beside the model (its step
after each of the model's, its loss logged as DIS) and checkpoints it.

Under a process group (`parallel/mesh.py`) every rank trains on its rows of
each global batch and takes the same step; the loss sums of a log line are
averaged over the group when the line is written, and nowhere else. test()
deals each group of consecutive windows to the ranks, one each, the last
group padded by repeating its last window, and gathers the outputs back in
order, so every rank scores every window as one process would (the JAX
trainer pads its eval batches to the mesh, trainer.py:154-191). Rank 0
alone writes the checkpoint, the images and the metric files; every rank
restores from the same checkpoint and resumes from the same epoch.
"""

from __future__ import annotations

import os
import time

import torch

from speinet_tpu_torch.config import Config
from speinet_tpu_torch.data.loader import prefetch_to_device, to_device
from speinet_tpu_torch.ops.metrics import postprocess_uint8, psnr_shave
from speinet_tpu_torch.parallel.mesh import (gather_batch, is_main, mean_over_group,
                                             rank, world)
from speinet_tpu_torch.training.loss import LossComputer
from speinet_tpu_torch.training.train_state import (eval_step, lr_for_epoch,
                                                    make_gan_state, make_optimizer,
                                                    recalibrate_batch_stats,
                                                    set_lr, train_step)
from speinet_tpu_torch.utils.checkpoint import CheckpointManager, model_state_dict
from speinet_tpu_torch.utils.device import resolve_device
from speinet_tpu_torch.utils.logging import Logger


class Trainer:
    def __init__(self, cfg: Config, data, model: torch.nn.Module, logger: Logger,
                 device="cuda"):
        """`data` holds `loader_train` and `loader_test` (data/loader.py::Data)."""
        self.device = resolve_device(device)
        if self.device.type == "cuda" and cfg.compute_dtype != "bfloat16":
            raise ValueError("the port's CUDA kernels take bfloat16: train with "
                             "compute_dtype='bfloat16' on the card")
        self.cfg = cfg
        self.data = data
        self.ckp = logger
        self.model = model.to(self.device)
        self.optimizer = make_optimizer(cfg, self.model)
        self.loss = LossComputer(cfg.loss, rgb_range=cfg.rgb_range)
        self.gan = make_gan_state(cfg, self.device)
        self.ckpt = CheckpointManager(f"{logger.dir}/model",
                                      save_middle=cfg.save_middle_models)
        self.step = 0
        restored = None
        if cfg.resume or cfg.load != ".":
            restored = self.ckpt.restore(self.model, self.optimizer, "model_latest",
                                         self.gan)
        elif cfg.test_only:
            restored = self.ckpt.restore(self.model, self.optimizer, "model_best",
                                         self.gan)
        if restored is not None:
            self.step = restored
            self.ckp.write_log(f"Restored checkpoint at step {self.step}")
        elif cfg.pre_train != "." and os.path.exists(cfg.pre_train):
            # a port state_dict (.pt) or trainer checkpoint, as infer.py's
            # --model_path takes
            self.model.load_state_dict(model_state_dict(cfg.pre_train), strict=True)
            self.ckp.write_log(f"Loaded pre-trained weights from {cfg.pre_train}")
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        # epoch counter resumes from the restored metric log (trainer.py:19-22)
        self.epoch = len(self.ckp.psnr_log)

    def terminate(self) -> bool:
        if self.cfg.test_only:
            self.test()
            return True
        return self.epoch >= self.cfg.epochs

    def train(self) -> None:
        cfg = self.cfg
        self.epoch += 1
        lr = lr_for_epoch(cfg, self.epoch)
        set_lr(self.optimizer, lr)
        self.ckp.write_log(f"Epoch {self.epoch:3d} with Lr {lr:.2e}")
        self.ckp.start_log(comp_names=self.loss.names)
        n_batches = 0
        t0 = time.time()
        # loss sums stay on the device between log lines: a float() per
        # step would wait for the card every step
        run_total = run_comps = None
        last_comps = None

        def flush():
            """Log the loss sums since the last line and the last step's
            components, each averaged over the group."""
            nonlocal run_total, run_comps, last_comps
            if run_total is None:
                return
            keys = list(run_comps)
            vals = mean_over_group(torch.stack(
                [run_total] + [run_comps[k] for k in keys]
                + [last_comps[k] for k in keys])).tolist()
            n = len(keys)
            self.ckp.report_log(vals[0], components=dict(zip(keys, vals[1:n + 1])))
            last_comps = dict(zip(keys, vals[n + 1:]))
            run_total = run_comps = None

        loader = self.data.loader_train
        for batch, sample in enumerate(prefetch_to_device(iter(loader), self.device)):
            inputs, gts = sample[0], sample[1]   # 5-tuples carry blur maps
            gt_center = gts[:, cfg.n_sequence // 2]
            total, comps = train_step(self.model, self.optimizer, self.loss, inputs,
                                      gt_center, self.generator, self.gan)
            self.step += 1
            if run_total is None:
                run_total, run_comps = total, dict(comps)
            else:
                run_total = run_total + total
                run_comps = {k: run_comps[k] + v for k, v in comps.items()}
            last_comps = comps
            n_batches += 1
            if (batch + 1) % cfg.print_every == 0:
                flush()
                comp_str = "".join(f"[{k}: {float(v):.4f}]" for k, v in last_comps.items())
                self.ckp.write_log(
                    f"[{(batch + 1) * cfg.batch_size}/"
                    f"{len(loader) * cfg.batch_size}]\t"
                    f"Loss : [total: {self.ckp.loss_log[-1] / (batch + 1):.4f}]"
                    f"{comp_str}[{(time.time() - t0) / (batch + 1):.2f}s/b]")
        flush()
        self.ckp.end_log(max(n_batches, 1))

    def test(self) -> None:
        cfg = self.cfg
        self.ckp.write_log("\nEvaluation:")
        if cfg.bn_recalib > 0:
            batches = []
            for sample in self.data.loader_train:
                batches.append(to_device(sample[0], self.device))
                if len(batches) >= cfg.bn_recalib:
                    break
            recalibrate_batch_stats(self.model, batches, self.generator)
        self.ckp.start_log(train=False)
        n = 0
        mid = cfg.n_sequence // 2
        group = []     # (input, centre gt, names) of up to world() windows

        def flush():
            """Each rank restores its window of the group (the padding
            repeats the last one); every rank scores the gathered outputs."""
            nonlocal n
            if not group:
                return
            inputs, gts, names = group[min(rank(), len(group) - 1)]
            out = gather_batch(eval_step(self.model, to_device(inputs, self.device)))
            for k, (inputs, gts, names) in enumerate(group):
                gt = to_device(gts[:, mid], self.device)
                self.ckp.report_log(
                    float(psnr_shave(gt[0], out[k], rgb_range=cfg.rgb_range)),
                    train=False)
                n += 1
                if cfg.save_images and is_main():
                    imgs = [postprocess_uint8(t, cfg.rgb_range) for t in
                            (gt[0], to_device(inputs[0, mid], self.device), out[k])]
                    self.ckp.save_images(names[0][mid], imgs, self.epoch)
            group.clear()

        for sample in self.data.loader_test:
            if group and group[0][0].shape != sample[0].shape:
                flush()    # the frame size changed (another video's size)
            group.append((sample[0], sample[1], sample[3]))
            if len(group) == world():
                flush()
        flush()
        self.ckp.end_log(max(n, 1), train=False)
        psnr_log = self.ckp.psnr_log
        best_idx = max(range(len(psnr_log)), key=psnr_log.__getitem__)
        self.ckp.write_log(
            f"[{cfg.data_test}]\taverage PSNR: {psnr_log[-1]:.3f} "
            f"(Best: {psnr_log[best_idx]:.3f} @epoch {best_idx + 1})")
        if not cfg.test_only and is_main():
            self.ckpt.save(self.model, self.optimizer, self.step, self.epoch,
                           is_best=(best_idx + 1 == self.epoch), gan=self.gan)
            self.ckp.save_metrics()
