"""End-to-end quality evidence (port of `scripts/quality_evidence.py`).

Generates a synthetic GoProRS tree (sharp drifting textures -> windowed-mean
blur + labels), trains the full-template SPEINet with the port's trainer,
restores a slim eval tree with the port's inference engine from the best
checkpoint, and reports the output PSNR beside the blurry input's:

    python -m speinet_tpu_torch.evidence.quality [--steps 156] [--epochs 7] \\
        [--out docs/quality_evidence_torch] [--work DIR] [--device cpu]

`--steps` sizes one epoch (batches of `--batch` at patch 200) through
`--n_frames_per_video`, which binds only where the generated videos have
more blurry frames than that (at the defaults they have about 22, so an
epoch is 39 steps); `--resume` continues the run in `--work` for more
epochs, `--lr` sets the learning rate of the epochs it adds. Training
runs in bfloat16 with float32 parameters on the card (float32 on the
CPU), with the BatchNorm statistics recalibrated over `--bn_recalib`
batches before each eval. The
summary and the trainer's logs go to `--out`: `summary.json` (the JAX
script's keys, and the process's kernel launches), `log.txt`, `loss.npy`, `psnr.npy` (the trainer's eval PSNR
per epoch) and `loss_components.npy`.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import tempfile
import time

import numpy as np

from speinet_tpu_torch.ops.metrics import psnr_uint8_host
from speinet_tpu_torch.utils.image_io import imread, imwrite


def make_eval_tree(tree: str, eval_tree: str, eval_frames: int) -> str:
    """The slim eval tree: the first `eval_frames` frames of the tree's first
    video, blurry and sharp, cropped to multiples of 20 (window 5 at a
    quarter of the resolution, as every reference eval set is), with their
    labels. Written once; returns `eval_tree`."""
    if os.path.exists(os.path.join(eval_tree, "blur")):
        return eval_tree
    v0 = sorted(os.listdir(os.path.join(tree, "blur")))[0]
    for sub in ("blur", "gt"):
        dst = os.path.join(eval_tree, sub, v0)
        os.makedirs(dst, exist_ok=True)
        for f in sorted(os.listdir(os.path.join(tree, sub, v0)))[:eval_frames]:
            img = imread(os.path.join(tree, sub, v0, f))
            h, w = img.shape[0] - img.shape[0] % 20, img.shape[1] - img.shape[1] % 20
            imwrite(os.path.join(dst, f), img[:h, :w])
    os.makedirs(os.path.join(eval_tree, "label"), exist_ok=True)
    lab = np.load(os.path.join(tree, "label", v0 + ".npy"))
    np.save(os.path.join(eval_tree, "label", v0 + ".npy"), lab[:eval_frames])
    return eval_tree


def blurry_baseline(eval_tree: str):
    """(PSNR of each blurry input frame against its ground truth, those of
    the frames labelled blurry, {frame name: label}), the PSNR the
    inference logs use (crop_border 4). Frames labelled sharp can equal
    their ground truth (a blur window of one frame): PSNR inf."""
    base, base_blurry, labels = [], [], {}
    for v in sorted(os.listdir(os.path.join(eval_tree, "blur"))):
        lab = np.load(os.path.join(eval_tree, "label", v + ".npy"))
        bf = sorted(glob.glob(os.path.join(eval_tree, "blur", v, "*.png")))
        gf = sorted(glob.glob(os.path.join(eval_tree, "gt", v, "*.png")))
        for i, (b, g) in enumerate(zip(bf, gf)):
            p = psnr_uint8_host(imread(g).astype(np.float64),
                                imread(b).astype(np.float64), crop_border=4)
            base.append(p)
            labels[v + "-" + os.path.splitext(os.path.basename(b))[0]] = int(lab[i])
            if lab[i] == 0:
                base_blurry.append(p)
    return base, base_blurry, labels


def finite_mean(values) -> float:
    return float(np.mean([x for x in values if np.isfinite(x)]))


def model_blurry_psnrs(log_path: str | None, labels: dict) -> list:
    """The per-frame PSNRs an inference log gives (`> name PSNR=...` lines)
    of the frames labelled blurry."""
    out = []
    if log_path:
        for line in open(log_path):
            m = re.match(r"> (\S+) PSNR=([\d.]+)", line)
            if m and labels.get(m.group(1)) == 0:
                out.append(float(m.group(2)))
    return out


def latest_inference_log(result_path: str) -> str | None:
    logs = sorted(glob.glob(os.path.join(result_path, "inference_log_*.txt")),
                  key=os.path.getmtime)
    return logs[-1] if logs else None


def epochs_trained(train_log: str) -> int:
    """The last epoch the trainer's log.txt names (resumed runs add up)."""
    if not os.path.exists(train_log):
        return 0
    eps = [int(m.group(1)) for m in re.finditer(r"Epoch\s+(\d+) ", open(train_log).read())]
    return max(eps) if eps else 0


def train_argv(tree: str, eval_tree: str, exp: str, args) -> list:
    """main_train's arguments: the template at patch 200, one epoch of about
    `args.steps` batches (each video contributes n_frames_per_video frames,
    a training epoch twice the windows), the tree held in memory."""
    per_video = max(4, args.steps * args.batch // (args.n_videos * 2))
    argv = [
        "--template", "SPEINet", "--dir_data", tree,
        "--dir_data_test", eval_tree,
        "--experiment_dir", exp + "/", "--save", "run",
        "--epochs", str(args.epochs),
        "--batch_size", str(args.batch), "--patch_size", "200",
        "--n_frames_per_video", str(per_video), "--print_every", "20",
        "--save_images", "false",
        "--bn_recalib", str(args.bn_recalib),
        "--process", "true", "--seed", str(args.seed),
    ]
    if args.resume:
        argv += ["--load", "run", "--resume", "true"]
    if args.lr is not None:
        argv += ["--lr", repr(args.lr)]
    if args.lr_decay is not None:
        argv += ["--lr_decay", str(args.lr_decay)]
    return argv + ["--device", args.device]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="end-to-end quality evidence")
    p.add_argument("--steps", type=int, default=300, help="batches per epoch")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--resume", action="store_true",
                   help="continue the run under --work instead of restarting")
    p.add_argument("--bn_recalib", type=int, default=8)
    p.add_argument("--n_videos", type=int, default=4)
    p.add_argument("--n_frames", type=int, default=150)
    p.add_argument("--style", default="lowpass", choices=["lowpass", "natural"])
    p.add_argument("--drift", type=int, nargs=4, default=[2, 5, 1, 4],
                   metavar=("DXLO", "DXHI", "DYLO", "DYHI"))
    p.add_argument("--eval_frames", type=int, default=20)
    p.add_argument("--seed", type=int, default=1,
                   help="the trainer's seed (init, crops, draws); the tree keeps its own")
    p.add_argument("--save_images", action="store_true",
                   help="keep the restored eval frames under <work>/results")
    p.add_argument("--lr_decay", type=int, default=None,
                   help="StepLR period in epochs (template default 150)")
    p.add_argument("--out", default="docs/quality_evidence_torch")
    p.add_argument("--work", default=os.path.join(tempfile.gettempdir(),
                                                  "quality_evidence"))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from speinet_tpu_torch.config import Config, set_template
    from speinet_tpu_torch.data.gopro_rs import generate_dataset, make_sharp_videos
    from speinet_tpu_torch.infer import Inference
    from speinet_tpu_torch.kernels import _lib
    from speinet_tpu_torch.main_train import main as train_main
    from speinet_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    sharp = os.path.join(args.work, "sharp")
    tree = os.path.join(args.work, "rs")
    if not os.path.exists(os.path.join(tree, "blur")):
        print("generating synthetic GoProRS tree...", flush=True)
        make_sharp_videos(sharp, n_videos=args.n_videos, n_frames=args.n_frames,
                          style=args.style, drift=tuple(args.drift))
        generate_dataset(sharp, tree, ratios=(0.5,), mixed=False, seed=3)
    eval_tree = (make_eval_tree(tree, os.path.join(args.work, "rs_eval20"),
                                args.eval_frames) if args.eval_frames else tree)

    exp = os.path.join(args.work, "exp")
    t0 = time.time()
    train_main(train_argv(tree, eval_tree, exp, args))
    train_sec = time.time() - t0
    print(f"train wall: {train_sec:.0f}s", flush=True)

    cfg = set_template(Config(template="SPEINet"))
    if device.type == "cuda":
        cfg = cfg.replace(compute_dtype="bfloat16")     # what the kernels take
    results = os.path.join(args.work, "results")
    inf = Inference(cfg, eval_tree,
                    model_path=os.path.join(exp, "run", "model", "model_best"),
                    result_path=results, save_image=args.save_images, device=device)
    psnr, ssim = inf.infer()
    inf.close()

    base, base_blurry, labels = blurry_baseline(eval_tree)
    blurry_only_psnr = float(np.mean(base_blurry))
    model_blurry = model_blurry_psnrs(latest_inference_log(results), labels)
    model_blurry_psnr = float(np.mean(model_blurry)) if model_blurry else None
    summary = {
        "steps": args.steps,
        "epochs_trained": epochs_trained(os.path.join(exp, "run", "log.txt")),
        "batch": args.batch,
        "train_wall_sec": round(train_sec, 1),
        "blurry_input_psnr_all_finite": round(finite_mean(base), 3),
        "blurry_input_psnr_blurry_frames": round(blurry_only_psnr, 3),
        "model_output_psnr": round(float(psnr), 3),
        "model_output_ssim": round(float(ssim), 4),
        "model_output_psnr_blurry_frames":
            round(model_blurry_psnr, 3) if model_blurry_psnr else None,
        "gain_db_blurry_frames":
            round(model_blurry_psnr - blurry_only_psnr, 3) if model_blurry_psnr else None,
        # this process's kernel launches (training, evals and inference)
        "launches": dict(_lib.LAUNCHES),
        "backward_launches": dict(_lib.BACKWARD_LAUNCHES),
    }
    print(json.dumps(summary, indent=2))
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    for name in ("log.txt", "loss.npy", "psnr.npy", "loss_components.npy"):
        src = os.path.join(exp, "run", name)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(args.out, name))
    return summary


if __name__ == "__main__":
    main()
