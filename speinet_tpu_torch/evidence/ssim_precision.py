"""SSIM of restored frames at two filter precisions:

    python -m speinet_tpu_torch.evidence.ssim_precision RESULTS EVAL_TREE

RESULTS holds the restored frames as the inference engine saves them
(`<video>/<frame>.png`, `quality.py --save_images` under `<work>/results`),
EVAL_TREE the `blur/` and `gt/` frames they were restored from. Each frame
is scored by `ops/metrics.py::ssim_matlab` (its Gaussian filters as float32
sums) and by `ssim_bf16_filters`, which rounds every operand of the two
filter passes to bfloat16 and sums in float32: what a float32
`conv_general_dilated` at default precision computes on a TPU, where the
JAX package's `ssim_matlab` filters by convolution. Prints the mean of
each over the model's frames and over the blurry inputs, as JSON.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from speinet_tpu_torch.ops.metrics import _gaussian_window, ssim_matlab
from speinet_tpu_torch.utils.image_io import imread


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _filter_bf16(img: torch.Tensor, win1d) -> torch.Tensor:
    """The valid separable Gaussian of [H, W, C] with each pass's operands
    (image, weights, first pass's output) rounded to bf16, f32 sums."""
    k = len(win1d)
    w = _bf16(torch.as_tensor(np.asarray(win1d, np.float32)))
    h, wd = img.shape[0] - k + 1, img.shape[1] - k + 1
    x = _bf16(img)
    x = _bf16(sum(w[i] * x[i:i + h] for i in range(k)))
    return sum(w[j] * x[:, j:j + wd] for j in range(k))


def ssim_bf16_filters(img1: torch.Tensor, img2: torch.Tensor,
                      crop_border: int = 4) -> float:
    """`ssim_matlab` with its five filters' operands rounded to bf16."""
    a = img1[crop_border:-crop_border, crop_border:-crop_border].float()
    b = img2[crop_border:-crop_border, crop_border:-crop_border].float()
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    win = _gaussian_window().astype(np.float32)
    mu1, mu2 = _filter_bf16(a, win), _filter_bf16(b, win)
    s1 = _filter_bf16(a * a, win) - mu1 ** 2
    s2 = _filter_bf16(b * b, win) - mu2 ** 2
    s12 = _filter_bf16(a * b, win) - mu1 * mu2
    ssim_map = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 ** 2 + mu2 ** 2 + c1) * (s1 + s2 + c2))
    return float(ssim_map.mean())


def score(results: str, eval_tree: str) -> dict:
    rows = []
    for v in sorted(os.listdir(os.path.join(eval_tree, "gt"))):
        for gf in sorted(glob.glob(os.path.join(eval_tree, "gt", v, "*.png"))):
            name = os.path.basename(gf)
            gt = torch.from_numpy(imread(gf))
            out = torch.from_numpy(imread(os.path.join(results, v, name)))
            blur = torch.from_numpy(imread(os.path.join(eval_tree, "blur", v, name)))
            rows.append([float(ssim_matlab(gt, out)), ssim_bf16_filters(gt, out),
                         float(ssim_matlab(gt, blur)), ssim_bf16_filters(gt, blur)])
    m = np.mean(rows, axis=0)
    return {"frames": len(rows), "model_ssim_f32": round(float(m[0]), 4),
            "model_ssim_bf16_filters": round(float(m[1]), 4),
            "blurry_ssim_f32": round(float(m[2]), 4),
            "blurry_ssim_bf16_filters": round(float(m[3]), 4)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="SSIM at two filter precisions")
    p.add_argument("results")
    p.add_argument("eval_tree")
    a = p.parse_args(argv)
    out = score(a.results, a.eval_tree)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
