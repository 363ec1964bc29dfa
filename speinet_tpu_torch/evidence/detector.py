"""Detector accuracy evidence (port of `scripts/detector_evidence.py`):
the classifier grid on a reproducible synthetic tree.

The sharp videos have natural-image statistics (a 1/f-spectrum texture,
hard-edged drifting shapes, fine grain), so the six focus measures, which
all measure high-frequency content, see what street scenes give them; the
GoProRS windowed-mean generator re-blurs them, the blur process the
reference detector was trained on. For each ratio x kernel size the
features are computed (on the card unless `--device cpu`), and the
logistic model, a decision tree and a random forest are fitted and scored
on a held-out tenth:

    python -m speinet_tpu_torch.evidence.detector [--out docs/detector_eval_torch] \\
        [--ratios 0.05 0.25 0.5] [--kernels 7 11 15] [--device cpu]

It writes `output.csv` (the metrics of every fit) and `summary.json` (the
accuracies per cell).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from speinet_tpu_torch.utils.image_io import imwrite


def make_detector_videos(root, n_videos=6, n_frames=200, h=240, w=320, seed=3):
    """Sharp videos under `root/video{v:02d}/{i:05d}.png`: a 1/f texture
    with 12 hard-edged shapes (rectangles or disks) and grain, periodic, so
    each video's drift is a roll (the JAX script's draws, in its order)."""
    rng = np.random.default_rng(seed)
    yy0, xx0 = np.mgrid[0:h, 0:w]
    for v in range(n_videos):
        d = os.path.join(root, f"video{v:02d}")
        os.makedirs(d, exist_ok=True)
        base = rng.standard_normal((h, w, 3))
        f = np.fft.rfft2(base, axes=(0, 1))
        fy = np.fft.fftfreq(h)[:, None, None]
        fx = np.fft.rfftfreq(w)[None, :, None]
        rad = np.sqrt(fy * fy + fx * fx)
        f *= 1.0 / np.maximum(rad, 1.0 / max(h, w))
        tex = np.fft.irfft2(f, s=(h, w), axes=(0, 1))
        tex = (tex - tex.min()) / (np.ptp(tex) + 1e-9)
        for _ in range(12):
            cy, cx = rng.integers(0, h), rng.integers(0, w)
            r = int(rng.integers(8, 40))
            col = rng.random(3)
            if rng.random() < 0.5:
                m = ((np.abs(((yy0 - cy + h // 2) % h) - h // 2) < r)
                     & (np.abs(((xx0 - cx + w // 2) % w) - w // 2) < r))
            else:
                dy = ((yy0 - cy + h // 2) % h) - h // 2
                dx = ((xx0 - cx + w // 2) % w) - w // 2
                m = dy * dy + dx * dx < r * r
            tex[m] = 0.7 * tex[m] + 0.3 * col
        tex = np.clip(tex + 0.03 * rng.standard_normal((h, w, 3)), 0, 1)
        dx, dy = int(rng.integers(2, 6)), int(rng.integers(1, 4))
        for i in range(n_frames):
            img = np.roll(tex, (i * dy, i * dx), axis=(0, 1))
            imwrite(os.path.join(d, f"{i:05d}.png"), (img * 255).astype(np.uint8))


def grid_cell(sharp: str, ratio: float, kernel: int, pickle_dir: str,
              csv_path: str | None, device="cuda") -> dict:
    """One ratio x kernel cell: {model: accuracy rounded to 4 places}, the
    fits' metrics appended to `csv_path`."""
    from speinet_tpu_torch.detector.train import collate_synthetic, train_detectors

    x, y = collate_synthetic(sharp, ratio, kernel, seed=17, device=device)
    res = train_detectors(x, y, pickle_dir, ratio, kernel, seed=17, csv_path=csv_path)
    return {m: round(v["accuracy"], 4) for m, v in res.items()}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="detector accuracy evidence")
    p.add_argument("--out", default="docs/detector_eval_torch")
    p.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                  "detector_evidence"))
    p.add_argument("--n_videos", type=int, default=6)
    p.add_argument("--n_frames", type=int, default=200)
    p.add_argument("--ratios", type=float, nargs="+", default=[0.05, 0.25, 0.5])
    p.add_argument("--kernels", type=int, nargs="+", default=[7, 11, 15])
    p.add_argument("--device", default="cuda",
                   help="where the features are computed: cuda (default) or cpu")
    a = p.parse_args(argv)

    from speinet_tpu_torch.utils.device import resolve_device

    device = resolve_device(a.device)
    sharp = os.path.join(a.root, "sharp")
    if not os.path.isdir(sharp):
        make_detector_videos(sharp, n_videos=a.n_videos, n_frames=a.n_frames,
                             h=240, w=320, seed=3)
    os.makedirs(a.out, exist_ok=True)
    csv_path = os.path.join(a.out, "output.csv")
    if os.path.exists(csv_path):
        os.remove(csv_path)
    summary = {}
    for ratio in a.ratios:
        for k in a.kernels:
            line = grid_cell(sharp, ratio, k, os.path.join(a.root, "pickle"),
                             csv_path, device)
            summary[f"ratio={ratio} k={k}"] = line
            print(f"ratio={ratio} k={k}: "
                  + " ".join(f"{m}={v}" for m, v in line.items()), flush=True)
    with open(os.path.join(a.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    best = max(v["LogisticRegression"] for v in summary.values())
    print(f"best LogisticRegression accuracy: {best:.4f} "
          f"(reference gopros_output.csv: 0.9571)")
    return summary


if __name__ == "__main__":
    main()
