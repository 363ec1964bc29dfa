"""Detector training and evaluation (port of
`speinet_tpu/detector/train.py`). Parity targets:

- sharp_detector_params_estimation_parallel.py:267-319: synthesize blurry
  sequences from sharp videos, extract the six focus features, 90 / 10
  split, fit the logistic model, a decision tree and a random forest,
  pickle each as `{Model}_{ratio}_{kernel}.pkl`, append the metrics to a
  CSV;
- LD_detector_gopros_train.py:203-322: the same on a pre-generated
  blur / label tree;
- test_detector.py:245-276: per-video label accuracy of a fitted
  classifier against the ground-truth labels, with timing.

The feature pass runs batched on `device` (the card unless the caller asks
for the CPU); the fits are host numpy. imageio is imported only where
frames are read.

    python -m speinet_tpu_torch.detector.train --dir-path <sharp-videos> \\
        --kernel-size 11 --ratio 0.5 --out-dir pickles/ [--device cpu]
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import time
from typing import Tuple

import numpy as np
import torch

from speinet_tpu_torch.data.gopro_rs import generate_blurry_sequence
from speinet_tpu_torch.detector.classifier import (DecisionTree, RandomForest,
                                                   binary_metrics,
                                                   fit_logistic_regression)
from speinet_tpu_torch.detector.features import focus_features
from speinet_tpu_torch.utils.device import resolve_device

# --grid: the reference's sweep of 8 ratios x 7 kernel sizes (run_detector.sh)
GRID_RATIOS = (0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.4, 0.5)
GRID_KERNELS = (3, 5, 7, 9, 11, 13, 15)


def video_features(frames: np.ndarray, kernel_size: int, batch: int = 16,
                   device="cuda") -> np.ndarray:
    """frames [N, H, W, 3] in 0..255 -> [N, 6] float32 focus features,
    computed `batch` frames at a time on `device` (the card unless the
    caller asks for the CPU)."""
    device = resolve_device(device)
    x = np.asarray(frames, np.float32).transpose(0, 3, 1, 2)
    feats = []
    for i in range(0, len(x), batch):
        t = torch.from_numpy(np.ascontiguousarray(x[i:i + batch])).to(device)
        feats.append(focus_features(t, kernel_size).cpu().numpy())
    return np.concatenate(feats, axis=0)


def _read_frames(folder: str) -> list:
    import imageio.v2 as imageio

    return [imageio.imread(p) for p in sorted(glob.glob(os.path.join(folder, "*")))]


def collate_synthetic(sharp_dir: str, ratio: float, kernel_size: int,
                      seed: int = 0, device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Features and labels of blurry sequences synthesized from each video
    folder of sharp frames under `sharp_dir`, in name order, from one seeded
    generator (parity: sharp_detector_params_estimation_parallel.py:221-237)."""
    rng = np.random.default_rng(seed)
    all_x, all_y = [], []
    for v in sorted(os.listdir(sharp_dir)):
        vdir = os.path.join(sharp_dir, v)
        if not os.path.isdir(vdir):
            continue
        blur, _, labels = generate_blurry_sequence(_read_frames(vdir), ratio, rng)
        all_x.append(video_features(blur, kernel_size, device=device))
        all_y.append(labels)
    return np.concatenate(all_x), np.concatenate(all_y)


def collate_pregenerated(root: str, kernel_size: int, device="cuda"
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Features and labels of a blur/ label/ tree (LD_detector_gopros_train.py)."""
    all_x, all_y = [], []
    for v in sorted(os.listdir(os.path.join(root, "blur"))):
        frames = np.stack(_read_frames(os.path.join(root, "blur", v)))
        labels = np.load(os.path.join(root, "label", v + ".npy")).reshape(-1)
        all_x.append(video_features(frames, kernel_size, device=device))
        all_y.append(labels[:len(frames)])
    return np.concatenate(all_x), np.concatenate(all_y)


def holdout_split(n: int, test_fraction: float = 0.1,
                  seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(held-out indices, training indices) of n samples: a seeded
    permutation, its first `test_fraction` (at least one) held out."""
    order = np.random.default_rng(seed).permutation(n)
    n_test = max(1, int(n * test_fraction))
    return order[:n_test], order[n_test:]


def train_detectors(x: np.ndarray, y: np.ndarray, out_dir: str, ratio: float,
                    kernel_size: int, test_fraction: float = 0.1,
                    seed: int = 0, csv_path: str | None = None,
                    n_forest_trees: int = 100) -> dict:
    """Fit, evaluate on a held-out share and pickle the three classifier
    families; append their metrics to `csv_path` (parity: estimate_parameters
    and the metric dump, :239-250, :267-319)."""
    test_idx, train_idx = holdout_split(len(y), test_fraction, seed)
    xtr, ytr, xte, yte = x[train_idx], y[train_idx], x[test_idx], y[test_idx]

    os.makedirs(out_dir, exist_ok=True)
    pkl = lambda model: os.path.join(out_dir, f"{model}_{ratio}_{kernel_size}.pkl")
    results = {}
    lr = fit_logistic_regression(xtr, ytr)
    lr.save(pkl("LogisticRegression"))
    results["LogisticRegression"] = binary_metrics(yte, lr.predict(xte))
    dt = DecisionTree().fit(xtr, ytr)
    dt.save(pkl("DecisionTree"))
    results["DecisionTree"] = binary_metrics(yte, dt.predict(xte))
    rf = RandomForest(n_estimators=n_forest_trees, seed=seed).fit(xtr, ytr)
    rf.save(pkl("RandomForest"))
    results["RandomForest"] = binary_metrics(yte, rf.predict(xte))

    if csv_path:
        new = not os.path.exists(csv_path)
        with open(csv_path, "a", newline="") as f:
            w = csv.writer(f)
            if new:
                w.writerow(["model", "ratio", "kernel_size", "accuracy",
                            "recall", "precision", "f1"])
            for name, m in results.items():
                w.writerow([name, ratio, kernel_size, m["accuracy"],
                            m["recall"], m["precision"], m["f1"]])
    return results


def evaluate_videos(root: str, model, kernel_size: int, device="cuda") -> dict:
    """Per-video label accuracy of `model` against the tree's labels, with
    the seconds each video took, and the frame-weighted total under
    '__total__' (parity: test_detector.py:245-276)."""
    per_video = {}
    for v in sorted(os.listdir(os.path.join(root, "blur"))):
        t0 = time.time()
        frames = np.stack(_read_frames(os.path.join(root, "blur", v)))
        pred = np.asarray(model.predict(video_features(frames, kernel_size,
                                                       device=device))).reshape(-1)
        labels = np.load(os.path.join(root, "label", v + ".npy")).reshape(-1)[:len(pred)]
        per_video[v] = {"accuracy": float((pred == labels).mean()),
                        "n_frames": len(pred), "seconds": time.time() - t0}
    n = sum(m["n_frames"] for m in per_video.values())
    per_video["__total__"] = {
        "accuracy": sum(m["accuracy"] * m["n_frames"] for m in per_video.values()) / n,
        "n_frames": n}
    return per_video


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Sharpness detector estimation")
    p.add_argument("--dir-path", required=True,
                   help="sharp-video dir (synthesize) or blur/label tree root")
    p.add_argument("--pregenerated", action="store_true")
    p.add_argument("--kernel-size", "-k", type=int, default=11)
    p.add_argument("--ratio", type=float, default=0.5)
    p.add_argument("--out-dir", default="./pickle")
    p.add_argument("--csv", default="output.csv")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--grid", action="store_true",
                   help="sweep ratios x kernel sizes (parity: run_detector.sh)")
    p.add_argument("--device", default="cuda",
                   help="where the features are computed: cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    combos = ([(r, k) for r in GRID_RATIOS for k in GRID_KERNELS] if args.grid
              else [(args.ratio, args.kernel_size)])
    for ratio, kernel in combos:
        if args.pregenerated:
            x, y = collate_pregenerated(args.dir_path, kernel, device)
        else:
            x, y = collate_synthetic(args.dir_path, ratio, kernel, args.seed, device)
        res = train_detectors(x, y, args.out_dir, ratio, kernel,
                              seed=args.seed, csv_path=args.csv)
        for name, m in res.items():
            print(f"[ratio={ratio} k={kernel}] {name}: "
                  f"acc={m['accuracy']:.4f} recall={m['recall']:.4f} "
                  f"precision={m['precision']:.4f} f1={m['f1']:.4f}")


if __name__ == "__main__":
    main()
