"""Sliding-window video dataset (host side, numpy; port of
`speinet_tpu/data/videodata.py`).

Parity target: data/videodata_nfs.py (the DVD_NFS dataset SPEINet trains
on). Scans `{dir}/gt/<video>/*`, `{dir}/blur/<video>/*`,
`{dir}/label/<video>.npy`; precomputes per-frame nearest-sharp indices; a
sample is a 3-frame window plus the pre/sub sharp frames (5 input frames),
random-cropped to an aligned patch, size_must_mode-truncated, augmented,
and normalized to [0, rgb_range] CHW float32.

Also covers the legacy blur-map variant (data/videodata.py) via
`blur_map=True`, which loads a 4th `Blur_map/` stream.

The reference's quirks are preserved where they define semantics:
- pre-sharp frame zeroed when its frame number is >7 from the window
  center (videodata_nfs.py:254-255; the sub-sharp zeroing is commented out
  there and stays off here)
- train __len__ = num_frame * 2, test __len__ = num_frame - 2
  (videodata_nfs.py:209-213)
Frames are read by `_imread` (imageio, imported there); a subclass may
serve them from memory instead.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from speinet_tpu_torch.config import Config
from speinet_tpu_torch.data.indices import frame_number, return_blurry_indices


def np2float(img: np.ndarray, rgb_range: float = 1.0) -> np.ndarray:
    """HWC uint8 -> CHW float32 in [0, rgb_range] (util/utils.py:29-38)."""
    t = np.ascontiguousarray(img.transpose(2, 0, 1)).astype(np.float32)
    return t * (rgb_range / 255.0)


def get_patch(*arrays: np.ndarray, patch_size: int, rng: np.random.Generator
              ) -> List[np.ndarray]:
    """Aligned random crop (util/utils.py:8-26). arrays: HWC."""
    ih, iw = arrays[0].shape[:2]
    ix = int(rng.integers(0, iw - patch_size + 1))
    iy = int(rng.integers(0, ih - patch_size + 1))
    return [a[iy : iy + patch_size, ix : ix + patch_size] for a in arrays]


def data_augment(*arrays: np.ndarray, rng: np.random.Generator) -> List[np.ndarray]:
    """Random hflip/vflip/rot90, aligned (util/utils.py:50-65)."""
    hflip = rng.random() < 0.5
    vflip = rng.random() < 0.5
    rot90 = rng.random() < 0.5

    def aug(img):
        if hflip:
            img = img[:, ::-1]
        if vflip:
            img = img[::-1]
        if rot90:
            img = np.rot90(img)
        return np.ascontiguousarray(img)

    return [aug(a) for a in arrays]


@dataclass
class Sample:
    inputs: np.ndarray    # [5, 3, H, W] float32 (or [n_seq, ...] in plain mode)
    gt: np.ndarray        # [3, 3, H, W]
    labels: np.ndarray    # [n_seq]
    filenames: List[str]
    blur_maps: Optional[np.ndarray] = None   # [n_seq, H, W] in bm mode


class VideoDataset:
    """Parity: data/videodata_nfs.py:VIDEODATA (mode='nsf', default).

    mode='bm'    loads a 4th `Blur_map/` stream alongside labels (legacy
                 DVD dataset for SWINT, data/videodata.py) — blur maps are
                 returned but, as in the reference, not consumed by the
                 model forward.
    mode='plain' 3-frame windows only, no labels/sharp frames
                 (data/videodata-ori.py).
    """

    def __init__(self, cfg: Config, name: str = "", train: bool = True,
                 mode: str = "nsf"):
        self.cfg = cfg
        self.name = name
        self.train = train
        self.mode = mode
        self.n_seq = cfg.n_sequence
        root = cfg.dir_data if train else cfg.dir_data_test
        self.dir_gt = os.path.join(root, "gt")
        self.dir_input = os.path.join(root, "blur")
        self.dir_label = os.path.join(root, "label")
        self.dir_bm = os.path.join(root, "Blur_map")
        self.n_frames_video: List[int] = []
        (self.images_gt, self.images_input, self.images_label,
         self.pre_idx, self.sub_idx) = self._scan()
        self.num_video = len(self.images_gt)
        self.num_frame = sum(self.n_frames_video) - (self.n_seq - 1) * len(self.n_frames_video)
        self._cache = {} if cfg.process else None
        if cfg.process:
            self._preload()

    # -- scanning ------------------------------------------------------------
    def _scan(self):
        vid_gt = sorted(glob.glob(os.path.join(self.dir_gt, "*")))
        vid_in = sorted(glob.glob(os.path.join(self.dir_input, "*")))
        limit = self.cfg.n_frames_per_video if self.train else None
        images_gt, images_input, images_label = [], [], []
        pre_all, sub_all = [], []
        if self.mode == "plain":
            if len(vid_gt) != len(vid_in):
                raise FileNotFoundError("gt/blur video count mismatch")
            for g, b in zip(vid_gt, vid_in):
                gts = sorted(glob.glob(os.path.join(g, "*")))[:limit]
                ins = sorted(glob.glob(os.path.join(b, "*")))[:limit]
                images_gt.append(gts)
                images_input.append(ins)
                images_label.append(np.zeros(len(gts), np.int64))
                pre_all.append([0] * len(gts))
                sub_all.append([0] * len(gts))
                self.n_frames_video.append(len(gts))
            return images_gt, images_input, images_label, pre_all, sub_all
        vid_lab = sorted(glob.glob(os.path.join(self.dir_label, "*")))
        if not (len(vid_gt) == len(vid_in) == len(vid_lab)):
            raise FileNotFoundError(
                f"dataset mismatch: {len(vid_gt)} gt / {len(vid_in)} blur / "
                f"{len(vid_lab)} label videos under {os.path.dirname(self.dir_gt)}")
        self.images_bm = []
        for g, b, l in zip(vid_gt, vid_in, vid_lab):
            gts = sorted(glob.glob(os.path.join(g, "*")))[:limit]
            ins = sorted(glob.glob(os.path.join(b, "*")))[:limit]
            labels = np.load(l)[:limit]
            pre, sub = return_blurry_indices(np.asarray(labels).squeeze().tolist())
            images_gt.append(gts)
            images_input.append(ins)
            images_label.append(np.asarray(labels))
            pre_all.append(pre)
            sub_all.append(sub)
            self.n_frames_video.append(len(gts))
            if self.mode == "bm":
                bm_dir = os.path.join(self.dir_bm, os.path.basename(g))
                self.images_bm.append(sorted(glob.glob(os.path.join(bm_dir, "*")))[:limit])
        return images_gt, images_input, images_label, pre_all, sub_all

    def _preload(self):
        for frames in self.images_input + self.images_gt:
            for f in frames:
                self._cache[f] = self._imread(f)

    def _imread(self, path: str) -> np.ndarray:
        if self._cache is not None and path in self._cache:
            return self._cache[path]
        import imageio.v2 as imageio

        return imageio.imread(path)

    # -- indexing ------------------------------------------------------------
    def __len__(self):
        return self.num_frame * 2 if self.train else self.num_frame - 2

    def _get_index(self, idx: int) -> int:
        return idx % self.num_frame if self.train else idx

    def _find_video_num(self, idx: int) -> Tuple[int, int]:
        n_poss = [n - self.n_seq + 1 for n in self.n_frames_video]
        for i, j in enumerate(n_poss):
            if idx < j:
                return i, idx
            idx -= j
        raise IndexError(idx)

    # -- sample assembly -----------------------------------------------------
    def load_window(self, idx: int) -> Sample:
        """Load the 5-frame input window + 3-frame gt, pre-crop
        (parity: videodata_nfs.py:228-261)."""
        idx = self._get_index(idx)
        v, f = self._find_video_num(idx)
        f_labels = self.images_label[v][f : f + self.n_seq]
        f_gts = self.images_gt[v][f : f + self.n_seq]
        f_inputs = list(self.images_input[v][f : f + self.n_seq])
        if self.mode != "plain":
            f_inputs.append(self.images_input[v][self.pre_idx[v][f]])
            f_inputs.append(self.images_input[v][self.sub_idx[v][f]])
        filenames = [
            os.path.split(os.path.dirname(p))[-1] + "." +
            os.path.splitext(os.path.basename(p))[0] for p in f_inputs]
        gts = np.stack([self._imread(p) for p in f_gts])
        inputs = np.stack([self._imread(p) for p in f_inputs])
        if self.mode != "plain":
            nums = [frame_number(n) for n in filenames]
            if abs(nums[2] - nums[3]) > 7:
                inputs[-2] = 0  # zero the pre-sharp frame (videodata_nfs.py:254-255)
        bms = None
        if self.mode == "bm":
            bms = np.stack([np.atleast_3d(self._imread(p))[..., 0]
                            for p in self.images_bm[v][f : f + self.n_seq]])
        return Sample(inputs, gts, np.asarray(f_labels, np.float32), filenames,
                      blur_maps=bms)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None):
        """Crop/augment/normalize (parity: videodata_nfs.py:180-207,276-288).

        Returns (inputs [n_seq+2, 3, h, w] f32, gt [n_seq, 3, h, w] f32,
        labels, filenames)."""
        rng = rng or np.random.default_rng()
        s = self.load_window(idx)
        smm = self.cfg.size_must_mode
        frames = list(s.inputs) + list(s.gt)
        if s.blur_maps is not None:
            frames += [bm[..., None] for bm in s.blur_maps]
        if self.train:
            frames = get_patch(*frames, patch_size=self.cfg.patch_size, rng=rng)
            h, w = frames[0].shape[:2]
            nh, nw = h - h % smm, w - w % smm
            frames = [f[:nh, :nw] for f in frames]
            if not self.cfg.no_augment:
                frames = data_augment(*frames, rng=rng)
        else:
            h, w = frames[0].shape[:2]
            nh, nw = h - h % smm, w - w % smm
            frames = [f[:nh, :nw] for f in frames]
        k = self.n_seq if self.mode == "plain" else self.n_seq + 2
        inputs = np.stack([np2float(f, self.cfg.rgb_range) for f in frames[:k]])
        gt = np.stack([np2float(f, self.cfg.rgb_range)
                       for f in frames[k : k + self.n_seq]])
        if s.blur_maps is not None:
            bms = np.stack([np2float(f, self.cfg.rgb_range)
                            for f in frames[k + self.n_seq :]])
            return inputs, gt, s.labels, s.filenames, bms
        return inputs, gt, s.labels, s.filenames
