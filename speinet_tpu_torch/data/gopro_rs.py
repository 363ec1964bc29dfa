"""GoProRS synthetic re-blur dataset generator (port of
`speinet_tpu/data/gopro_rs.py`; parity: LD_detector/choice_dataset_train.py:
34-59, mix_choice_dataset.py, LD_detector/split.py).

Host data preparation, numpy only, as in the JAX package: it runs no model
and touches no card. A sharp video is consumed greedily: each step draws a
Bernoulli(ratio) label (forced sharp when <= threshold frames remain); a
sharp step averages a random window of 1..threshold frames, a blurry one
threshold+1..window_range[1] frames; the blurry frame is the window's mean
and its ground truth the window's centre. Every draw comes from one
`np.random.Generator` in the JAX package's order, so one seed gives the same
labels and frames in both packages. imageio reads and writes the PNGs; it
is imported only where files are read or written.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
from typing import List, Sequence, Tuple

import numpy as np

# per-split ratio menus (parity: mix_choice_dataset.py:137-155): train and
# test draw one of {0.1, 0.3, 0.5} per video, val is fixed at 0.5
DEFAULT_SPLIT_RATIOS = {"train": (0.1, 0.3, 0.5), "val": (0.5,),
                        "test": (0.1, 0.3, 0.5)}


def generate_blurry_sequence(frames: Sequence[np.ndarray], ratio: float,
                             rng: np.random.Generator,
                             window_range: Tuple[int, int] = (1, 15),
                             threshold: int = 5
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(blurry [N, H, W, C] float32, gt [N, H, W, C] float32, labels [N]
    int64) of a sharp video's frames."""
    frames = list(frames)
    blurry, gts, labels = [], [], []
    while frames:
        label = int((rng.random() < ratio) or (len(frames) <= threshold))
        labels.append(label)
        if label:
            wsize = int(rng.integers(window_range[0], threshold + 1))
        else:
            wsize = int(rng.integers(threshold + 1, window_range[1] + 1))
        window, frames = frames[:wsize], frames[wsize:]
        blurry.append(np.mean(window, axis=0))
        gts.append(np.asarray(window[len(window) // 2], np.float32))
    return (np.stack(blurry).astype(np.float32), np.stack(gts),
            np.asarray(labels, np.int64))


def generate_dataset(src_dir: str, out_dir: str,
                     ratios: Sequence[float] = (0.05, 0.25, 0.5), seed: int = 0,
                     mixed: bool = True) -> List[str]:
    """The blur/ gt/ label/ tree the training pipeline reads
    ({out}/blur/<video>/*.png, {out}/gt/<video>/*.png, {out}/label/<video>.npy)
    from `src_dir`'s per-video folders of sharp frames. With `mixed` one
    ratio is drawn per video (mix_choice_dataset.py), else ratios[0] holds
    for all. Returns the videos written."""
    import imageio.v2 as imageio

    rng = np.random.default_rng(seed)
    written = []
    for v in sorted(os.listdir(src_dir)):
        vdir = os.path.join(src_dir, v)
        if not os.path.isdir(vdir):
            continue
        frames = [imageio.imread(os.path.join(vdir, n)) for n in sorted(os.listdir(vdir))]
        ratio = float(rng.choice(ratios)) if mixed else float(ratios[0])
        blur, gt, labels = generate_blurry_sequence(frames, ratio, rng)
        dirs = {kind: os.path.join(out_dir, kind, v) for kind in ("blur", "gt")}
        ldir = os.path.join(out_dir, "label")
        for d in (*dirs.values(), ldir):
            os.makedirs(d, exist_ok=True)
        for i in range(len(labels)):
            for kind, arr in (("blur", blur), ("gt", gt)):
                imageio.imwrite(os.path.join(dirs[kind], f"{i:08d}.png"),
                                np.clip(arr[i], 0, 255).astype(np.uint8))
        np.save(os.path.join(ldir, v + ".npy"), labels)
        written.append(v)
    return written


def generate_splits(src_dirs: dict, out_dir: str, split_ratios: dict | None = None,
                    seed: int = 0, manifest: str = "dataset_manifest.json") -> dict:
    """Per-split generation (parity: mix_choice_dataset.py:78-192): each split
    of `src_dirs` ({"train": <sharp dir>, "val": ..., "test": ...}, any
    subset) has its own source tree, ratio menu and seed (seed + its index
    in sorted order), lands under {out}/{split}/, and a JSON manifest of
    the per-split frame paths and labels is written (the reference's
    save_output_to_file, :121-136). Returns {split: [videos]}."""
    split_ratios = split_ratios or DEFAULT_SPLIT_RATIOS
    written, payload = {}, {}
    for si, (split, src) in enumerate(sorted(src_dirs.items())):
        ratios = tuple(split_ratios[split])
        split_out = os.path.join(out_dir, split)
        written[split] = generate_dataset(src, split_out, ratios=ratios,
                                          seed=seed + si, mixed=len(ratios) > 1)
        cap = split.capitalize()
        payload[f"{cap} Blurry Paths"] = [
            sorted(glob.glob(os.path.join(split_out, "blur", v, "*.png")))
            for v in written[split]]
        payload[f"{cap} GT Paths"] = [
            sorted(glob.glob(os.path.join(split_out, "gt", v, "*.png")))
            for v in written[split]]
        payload[f"{cap} Labels"] = [
            np.load(os.path.join(split_out, "label", v + ".npy")).tolist()
            for v in written[split]]
    if manifest:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, manifest), "w") as f:
            json.dump(payload, f, indent=4)
    return written


def split_dataset(root: str, out_train: str, out_val: str,
                  val_fraction: float = 0.1, seed: int = 0) -> None:
    """Video-level train / val split of a blur/ gt/ label/ tree (parity:
    LD_detector/split.py): max(1, int(n val_fraction)) videos, chosen by a
    seeded permutation, go to `out_val`, the rest to `out_train`."""
    videos = sorted(os.listdir(os.path.join(root, "blur")))
    order = np.random.default_rng(seed).permutation(len(videos))
    n_val = max(1, int(len(videos) * val_fraction))
    val_set = {videos[i] for i in order[:n_val]}
    for v in videos:
        dst = out_val if v in val_set else out_train
        for sub in ("blur", "gt"):
            shutil.copytree(os.path.join(root, sub, v), os.path.join(dst, sub, v),
                            dirs_exist_ok=True)
        os.makedirs(os.path.join(dst, "label"), exist_ok=True)
        shutil.copy(os.path.join(root, "label", v + ".npy"),
                    os.path.join(dst, "label", v + ".npy"))
