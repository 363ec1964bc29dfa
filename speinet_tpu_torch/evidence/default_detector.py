"""Fit the packaged fallback sharpness detector (port of
`scripts/train_default_detector.py`).

Inference labels a video that has no label/ directory with a logistic
detector (the reference falls back to a shipped sklearn pickle,
inference_SPEINet.py:349-353). This fits it: 9 synthetic videos (3 at each
blur ratio 0.1, 0.3, 0.5), re-blurred by the GoProRS generator, their focus
features at kernel 11 (on the card unless `--device cpu`), a seeded 90 / 10
split and the logistic fit; the held-out metrics are printed.

    python -m speinet_tpu_torch.evidence.default_detector --out model.npz \\
        [--device cpu]

It writes the .npz that `detector/classifier.py::LogisticRegression.load`
reads to `--out`; the packaged `detector/default_logreg.npz` (the JAX
package's fit) is replaced only when `--out` names it.
"""

from __future__ import annotations

import argparse

import numpy as np


def synth_sharp_video(rng: np.random.Generator, n: int = 120, h: int = 180,
                      w: int = 240) -> list:
    """Textured moving frames (uint8 HxWx3): four sinusoid products with
    drifting phase plus grain, enough high-frequency content for the focus
    measures to tell sharp frames from window-averaged ones."""
    yy, xx = np.mgrid[0:h, 0:w]
    freqs = rng.uniform(3.0, 9.0, size=(4, 2))
    amps = rng.uniform(0.1, 0.25, size=4)
    frames = []
    for t in range(n):
        img = 0.5 * np.ones((h, w))
        for (fy, fx), a in zip(freqs, amps):
            img = img + a * np.sin(xx / fx + 0.35 * t) * np.cos(yy / fy - 0.2 * t)
        img = img + 0.04 * rng.standard_normal((h, w))
        img = np.clip(img, 0, 1) * 255.0
        frames.append(np.stack([img, img * 0.95, img * 0.9], -1).astype(np.uint8))
    return frames


def features_and_labels(device="cuda"):
    """(features [N, 6], labels [N]) of the 9 re-blurred videos, all drawn
    from one generator seeded 0 in the JAX script's order."""
    from speinet_tpu_torch.data.gopro_rs import generate_blurry_sequence
    from speinet_tpu_torch.detector.train import video_features

    rng = np.random.default_rng(0)
    xs, ys = [], []
    for ratio in (0.1, 0.3, 0.5):
        for _ in range(3):
            frames = synth_sharp_video(rng)
            blur, _, labels = generate_blurry_sequence(frames, ratio, rng)
            xs.append(video_features(blur, kernel_size=11, device=device))
            ys.append(labels)
    return np.concatenate(xs), np.concatenate(ys)


def fit(x: np.ndarray, y: np.ndarray):
    """(the logistic model fitted on 90% of the samples, its metrics on the
    held-out 10%), the split a permutation seeded 1."""
    from speinet_tpu_torch.detector.classifier import (binary_metrics,
                                                       fit_logistic_regression)

    order = np.random.default_rng(1).permutation(len(y))
    n_test = len(y) // 10
    lr = fit_logistic_regression(x[order[n_test:]], y[order[n_test:]])
    return lr, binary_metrics(y[order[:n_test]], lr.predict(x[order[:n_test]]))


def save_npz(lr, path: str) -> None:
    np.savez(path, coef=np.asarray(lr.coef), intercept=np.float64(lr.intercept),
             mean=np.asarray(lr.mean), scale=np.asarray(lr.scale))


def main(argv=None):
    p = argparse.ArgumentParser(description="fit the default sharpness detector")
    p.add_argument("--out", required=True, help="the .npz to write")
    p.add_argument("--device", default="cuda",
                   help="where the features are computed: cuda (default) or cpu")
    a = p.parse_args(argv)

    from speinet_tpu_torch.utils.device import resolve_device

    x, y = features_and_labels(resolve_device(a.device))
    lr, m = fit(x, y)
    print(f"default detector: n={len(y)} acc={m['accuracy']:.4f} "
          f"recall={m['recall']:.4f} precision={m['precision']:.4f} "
          f"f1={m['f1']:.4f}")
    save_npz(lr, a.out)
    print(f"saved {a.out}")
    return lr, m, x, y


if __name__ == "__main__":
    main()
