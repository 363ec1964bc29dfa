"""Inference engines (port of `speinet_tpu/infer.py`; parity:
inference_SPEINet.py).

Per video: sharp labels (from `label/<video>.npy`, or from the sharpness
detector when the tree has no `label/` directory), border-padded sliding
windows of `n_sequence` frames (3 by default) with the pre/sub sharp
anchors and the >7-frame zero rule, windows restored `batch_windows` at a
time, PSNR (float64 host, border crop 4) and MATLAB SSIM, PNGs, and the
reference's `inference_log` format. Two engines:
- direct (the default): each window's frames and its two anchors go through
  `SPEINet.forward`, with per-sample routing; `--self_ensemble` averages
  the 8 flips / transposes of the input (`forward_x8`), `--chop` runs four
  overlapping quadrants as one batch (`parallel/chop.py`);
- `--cache_pyramids`: per-frame encoder legs and anchor pyramids computed
  once and reused across windows; a chunk restores with routing 'sharp' or
  'self' when all its windows agree, else as one 'mixed' call.

Frame decoding is kept apart from the window logic: `infer_video` takes
frame keys and a `load(key) -> HxWx3 uint8` function, so in-memory frames
work as well as the PNG tree of the CLI.

    python -m speinet_tpu_torch.infer --data_path <tree> \
        [--cache_pyramids] [--self_ensemble] [--chop] \
        [--model_path port_state_dict.pt] [--detector_pickle model.pkl] \
        [--n_sequence 3] [--profile trace_dir]

On the card the CLI computes in bfloat16 unless --compute_dtype says
otherwise; with --device cpu it keeps the config's float32. `--model_path`
takes a port state_dict or a trainer checkpoint (its `model` entry).

Data parallelism (parity: speinet_tpu/infer.py:93-135): under torchrun
(`torchrun --standalone --nproc_per_node N -m speinet_tpu_torch.infer ...`)
each process takes cuda:LOCAL_RANK, `batch_windows` is rounded up to a
multiple of N, and each rank restores its rows of every window batch, the
outputs gathered back in order (`parallel/mesh.py::shard_rows`). The cached
engine's legs and anchors run on every rank, as they run replicated on the
JAX mesh. With `--chop` the windows are not split; the 4B tiles of each
chopped forward are (`parallel/chop.py`). Rank 0 alone writes images and
logs; every rank scores every frame.

`--swin_fuse_block`, `--corr_raw`, `--corr_banded` and `--corr_scaled` (0 or
1, default 1) choose among the kernel paths as the JAX package's
SPEINET_SWIN_FUSEBLOCK, SPEINET_CORR_RAW, SPEINET_CORR_BANDED and
SPEINET_CORR_SCALED do (`models/speinet.py`).
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from speinet_tpu_torch.config import Config
from speinet_tpu_torch.data.indices import gene_seq, gene_seq_nsf
from speinet_tpu_torch.detector.classifier import LogisticRegression
from speinet_tpu_torch.detector.train import video_features
from speinet_tpu_torch.models.speinet import SPEINet, init_weights
from speinet_tpu_torch.ops.metrics import psnr_uint8_host, ssim_matlab
from speinet_tpu_torch.parallel.chop import chop_forward
from speinet_tpu_torch.parallel.mesh import (active, dp_world, is_main,
                                             maybe_init_distributed, shard_rows)
from speinet_tpu_torch.utils.checkpoint import model_state_dict
from speinet_tpu_torch.utils.image_io import imread, imwrite

# --default_data presets: (data_path, result_path) relative to the working
# tree (parity: inference_SPEINet.py:626-697, which hardcodes user paths)
PRESETS = {
    "REDS": ("./data/deblur/REDS_8x_Random/test", "./infer_results/reds"),
    "GOPRO": ("./data/deblur/GOPRO/test", "./infer_results/gopro"),
    "BSD": ("./data/deblur/BSDtest", "./infer_results/bsd"),
    "BSDtest_all": ("./data/deblur/BSDtest_all/BSD_3ms24ms",
                    "./infer_results/bsd_3ms24ms"),
}


def _frame_number(path: str) -> int:
    return int(os.path.splitext(os.path.basename(path))[0].split(".")[-1])


def forward_x8(x: torch.Tensor, fwd) -> torch.Tensor:
    """8-way flip / transpose self-ensemble of x [B, T, C, H, W]: the mean
    of the 8 outputs, each mapped back (parity: util/network_utils.py:
    308-341, speinet_tpu/infer.py:53)."""
    outs = []
    for tf in range(8):
        xt = x
        if tf & 1:
            xt = torch.flip(xt, (-1,))
        if tf & 2:
            xt = torch.flip(xt, (-2,))
        if tf & 4:
            xt = xt.transpose(-1, -2)
        y = fwd(xt.contiguous())
        if tf & 4:
            y = y.transpose(-1, -2)
        if tf & 2:
            y = torch.flip(y, (-2,))
        if tf & 1:
            y = torch.flip(y, (-1,))
        outs.append(y)
    return torch.stack(outs).mean(dim=0)


def window_metas(padded_inputs: Sequence[str], pre_lists, sub_lists,
                 n_seq: int) -> List[tuple]:
    """Per window of the cached engine: (centre key, neighbour keys,
    has_sharp, anchor key or "<ZERO>"). Both sharp frames are measured from
    the LAST window frame (reference inference_SPEINet.py:385-388), not from
    the centre: the pre-sharp frame decides the routing, and a sub-sharp
    frame more than 7 frames away is replaced by zeros."""
    metas = []
    for w in range(len(padded_inputs) - 2 * (n_seq // 2)):
        c_path = padded_inputs[w + n_seq // 2]
        nb_paths = tuple(padded_inputs[w + i] for i in range(n_seq)
                         if i != n_seq // 2)
        ref_n = _frame_number(padded_inputs[w + n_seq - 1])
        hs = abs(ref_n - _frame_number(padded_inputs[pre_lists[w][0]])) <= 7
        sub_path = padded_inputs[sub_lists[w][n_seq - 1]]
        akey = sub_path if abs(ref_n - _frame_number(sub_path)) <= 7 else "<ZERO>"
        metas.append((c_path, nb_paths, hs, akey))
    return metas


class TraverseLogger:
    """Parity: inference_SPEINet.py:26-34. Under a process group rank 0 alone
    prints and writes."""

    def __init__(self, result_dir: str, filename: str):
        self.path = os.path.join(result_dir, filename)
        self.f = None
        if is_main():
            self.f = open(self.path, "a" if os.path.exists(self.path) else "w")

    def write_log(self, log: str) -> None:
        if self.f is None:
            return
        print(log, flush=True)
        self.f.write(log + "\n")
        self.f.flush()

    def close(self) -> None:
        if self.f is not None:
            self.f.close()


class Inference:
    def __init__(self, cfg: Config, data_path: str, model_path: str,
                 result_path: str, save_image: bool = True, border: bool = True,
                 detector_pickle: str | None = None, self_ensemble: bool = False,
                 batch_windows: int = 1, cache_pyramids: bool = False,
                 device="cuda", seed: int = 0, *, swin_fuse_block: bool = True,
                 corr_raw: bool = True, corr_banded: bool = True,
                 corr_scaled: bool = True):
        if cache_pyramids and (self_ensemble or cfg.chop):
            raise ValueError("--self_ensemble and --chop run on the direct "
                             "engine; drop --cache_pyramids")
        # under torchrun: the group opened, cuda:LOCAL_RANK on the card
        self.device = maybe_init_distributed(device)
        if self.device.type == "cuda" and cfg.compute_dtype != "bfloat16":
            raise ValueError("the port's CUDA kernels take bfloat16: run with "
                             "compute_dtype='bfloat16' on the card")
        self.cfg = cfg
        self.n_seq = cfg.n_sequence
        self.size_must_mode = cfg.size_must_mode
        self.save_image = save_image
        self.border = border
        self.batch_windows = max(1, batch_windows)
        n_dp = dp_world(cfg.dp_devices)
        if n_dp > 1 and not cfg.chop and self.batch_windows % n_dp:
            # round the window batch up to fill the group (infer.py:98-100)
            self.batch_windows = -(-self.batch_windows // n_dp) * n_dp
        self.cache_pyramids = cache_pyramids
        self.self_ensemble = self_ensemble
        self.detector_pickle = detector_pickle
        self.result_path = result_path
        self.input_path = os.path.join(data_path, "blur")
        self.gt_path = os.path.join(data_path, "gt")
        self.label_path = os.path.join(data_path, "label")
        if is_main():
            os.makedirs(result_path, exist_ok=True)

        now = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())
        self.logger = TraverseLogger(result_path, f"inference_log_{now}.txt")
        self.logger.write_log(f"Inference - {now}")
        dev_name = (torch.cuda.get_device_name(self.device)
                    if self.device.type == "cuda" else "cpu")
        for k, v in [("save_image", save_image), ("border", border),
                     ("model_path", model_path), ("data_path", data_path),
                     ("result_path", result_path), ("n_seq", self.n_seq),
                     ("size_must_mode", self.size_must_mode),
                     ("device", f"{self.device} ({dev_name})")]:
            self.logger.write_log(f"{k}: {v}")

        self.model = SPEINet.from_config(
            cfg, swin_fuse_block=swin_fuse_block, corr_raw=corr_raw,
            corr_banded=corr_banded, corr_scaled=corr_scaled)
        if model_path:
            self.model.load_state_dict(model_state_dict(model_path), strict=True)
        else:
            init_weights(self.model, seed)     # random init (smoke / demo mode)
        self.model.to(self.device).eval()
        self.logger.write_log(f"Loading model from {model_path}")
        if active():
            self.logger.write_log(f"dp group: {n_dp} device(s), "
                                  f"batch_windows={self.batch_windows}")
        # seconds spent in each engine stage, each ended by a device sync:
        # the cached engine's legs / anchor / restore, the direct forward
        self.stage_seconds = {"legs": 0.0, "anchor": 0.0, "restore": 0.0,
                              "forward": 0.0}
        self.total_psnr: Dict[str, List[float]] = {}
        self.total_ssim: Dict[str, List[float]] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timed(self, stage: str, fn, *args):
        t0 = time.time()
        out = fn(*args)
        self._sync()
        self.stage_seconds[stage] += time.time() - t0
        return out

    def infer_video(self, v: str, input_frames: Sequence[str],
                    gt_frames: Sequence[str], labels,
                    load: Callable[[str], np.ndarray], pool: ThreadPoolExecutor):
        """Sliding-window inference of one video with the engine chosen at
        construction. `input_frames` / `gt_frames` are keys whose base names
        end in the frame number; `load(key)` returns the HxWx3 uint8 frame.
        Returns the per-frame (psnr, ssim) lists."""
        run = self._infer_video_cached if self.cache_pyramids else self._infer_video_direct
        video_psnr, video_ssim = run(v, input_frames, gt_frames, labels, load, pool)
        self.total_psnr[v] = video_psnr
        self.total_ssim[v] = video_ssim
        return video_psnr, video_ssim

    def _score_chunk(self, v, names, out, gt_results, start, t_pre,
                     video_psnr, video_ssim) -> None:
        """Quantize a restored chunk [n, 3, H, W], score each frame against
        its ground truth, save it, and write the reference's log line."""
        imgs_dev = torch.clamp(torch.round(out * (255.0 / self.cfg.rgb_range)),
                               0, 255).to(torch.uint8).permute(0, 2, 3, 1)
        imgs = imgs_dev.cpu().numpy()
        t_fwd = time.time()
        nb = len(names)
        for k, filename in enumerate(names):
            img, gt = imgs[k], gt_results[k]()
            psnr = psnr_uint8_host(img, gt, crop_border=4)
            ssim = float(ssim_matlab(torch.from_numpy(np.ascontiguousarray(gt)).to(
                self.device), imgs_dev[k]))
            video_psnr.append(psnr)
            video_ssim.append(ssim)
            if self.save_image and is_main():
                os.makedirs(os.path.join(self.result_path, v), exist_ok=True)
                imwrite(os.path.join(self.result_path, v, f"{filename}.png"), img)
            t_post = time.time()
            self.logger.write_log(
                f"> {v}-{filename} PSNR={psnr:.5}, SSIM={ssim:.4} "
                f"pre_time:{(t_pre - start) / nb:.3}s, "
                f"forward_time:{(t_fwd - t_pre) / nb:.3}s, "
                f"post_time:{(t_post - t_fwd) / nb:.3}s, "
                f"total_time:{(t_post - start) / nb:.3}s")

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 5, 3, H, W] windows -> [B, 3, H, W], chopped and / or
        self-ensembled as configured; under a process group each rank
        restores its rows (or with chop, its tiles)."""
        if self.cfg.chop:
            fwd = lambda t: chop_forward(self.model, t, shave=self.cfg.chop_shave)
            return forward_x8(x, fwd) if self.self_ensemble else fwd(x)
        fwd = (lambda t: forward_x8(t, self.model)) if self.self_ensemble else self.model
        return shard_rows(fwd, x)

    def _prepare_window(self, in_seq, gt_seq, pre_seq, sub_seq, padded_inputs,
                        load):
        """Decode, crop and zero-rule one window (host side, thread-safe):
        (name, [5, 3, H, W] float32, HxWx3 uint8 ground truth). The pre- and
        sub-sharp frames are zeroed when more than 7 frames from the
        window's last frame (parity: speinet_tpu/infer.py:228-249)."""
        n_seq = self.n_seq
        filename = os.path.basename(in_seq[n_seq // 2]).split(".")[0]
        seq = list(in_seq) + [padded_inputs[pre_seq[0]],
                              padded_inputs[sub_seq[n_seq - 1]]]
        nums = [_frame_number(p) for p in seq]
        inputs = [load(p) for p in seq]
        gt = load(gt_seq[n_seq // 2])
        h, w = inputs[n_seq // 2].shape[:2]
        nh, nw = h - h % self.size_must_mode, w - w % self.size_must_mode
        inputs = [im[:nh, :nw] for im in inputs]
        gt = gt[:nh, :nw]
        # the JAX package measures entries 3 and 4 of the stack from entry
        # 2 whatever the window's length: the pre- and sub-sharp frames from
        # the last window frame at n_sequence 3, three window frames at 5
        # (so nothing is zeroed there). At n_sequence 1 it has no entry 3
        # and fails; the port measures both from the window's one frame.
        ref, pre, sub = (2, 3, 4) if n_seq >= 3 else (0, 1, 2)
        if abs(nums[ref] - nums[pre]) > 7:
            inputs[pre] = np.zeros_like(inputs[pre])
        if abs(nums[ref] - nums[sub]) > 7:
            inputs[sub] = np.zeros_like(inputs[sub])
        x = np.stack([im.transpose(2, 0, 1) for im in inputs]).astype(np.float32)
        x *= self.cfg.rgb_range / 255.0
        return filename, x, gt

    def _infer_video_direct(self, v, input_frames, gt_frames, labels, load, pool):
        """Each window's five frames through the model; windows are decoded
        by the pool one chunk ahead of the card."""
        n_seq, bw = self.n_seq, self.batch_windows
        pre_lists, sub_lists = gene_seq_nsf(labels, n_seq=n_seq, border=self.border)
        input_seqs, padded_inputs = gene_seq(input_frames, n_seq=n_seq,
                                             border=self.border)
        gt_seqs, _ = gene_seq(gt_frames, n_seq=n_seq, border=self.border)
        n_win = len(input_seqs)
        futures = {}
        video_psnr, video_ssim = [], []
        for s in range(0, n_win, bw):
            start = time.time()
            for w in range(s, min(s + 2 * bw, n_win)):   # this chunk and the next
                if w not in futures:
                    futures[w] = pool.submit(self._prepare_window, input_seqs[w],
                                             gt_seqs[w], pre_lists[w], sub_lists[w],
                                             padded_inputs, load)
            chunk = [futures.pop(w).result() for w in range(s, min(s + bw, n_win))]
            x = torch.from_numpy(np.stack([c[1] for c in chunk])).to(self.device)
            t_pre = time.time()
            out = self._timed("forward", self._forward, x)
            self._score_chunk(v, [c[0] for c in chunk], out,
                              [lambda g=c[2]: g for c in chunk], start, t_pre,
                              video_psnr, video_ssim)
        return video_psnr, video_ssim

    def _infer_video_cached(self, v, input_frames, gt_frames, labels, load, pool):
        """Sliding-window inference with per-frame features and anchor
        pyramids cached across windows."""
        n_seq = self.n_seq
        bw = self.batch_windows
        dev = self.device
        scale = self.cfg.rgb_range / 255.0
        pre_lists, sub_lists = gene_seq_nsf(labels, n_seq=n_seq, border=self.border)
        input_seqs, padded_inputs = gene_seq(input_frames, n_seq=n_seq,
                                             border=self.border)
        gt_seqs, _ = gene_seq(gt_frames, n_seq=n_seq, border=self.border)
        n_win = len(input_seqs)
        probe = load(padded_inputs[n_seq // 2])
        nh = probe.shape[0] - probe.shape[0] % self.size_must_mode
        nw = probe.shape[1] - probe.shape[1] % self.size_must_mode

        def load_frame(key):
            im = load(key)[:nh, :nw]
            return im.transpose(2, 0, 1).astype(np.float32) * scale

        last_pos = {p: i for i, p in enumerate(padded_inputs)}
        metas = window_metas(padded_inputs, pre_lists, sub_lists, n_seq)

        decoded, feat, anchors = {}, {}, {}

        def to_dev(arr: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(arr).to(dev)

        def ensure_feats(paths):
            need = [p for p in dict.fromkeys(paths) if p not in feat]
            for i in range(0, len(need), bw):
                chunk = need[i:i + bw]
                arr = np.stack([decoded[p].result() for p in chunk])
                m, n = self._timed("legs", self.model.encode_window_legs, to_dev(arr))
                for k, p in enumerate(chunk):
                    feat[p] = (m[k:k + 1], n[k:k + 1])

        def ensure_anchor(key):
            if key in anchors:
                return
            if key == "<ZERO>":
                arr = np.zeros((1, 3, nh, nw), np.float32)
            else:
                arr = decoded[key].result()[None]
            anchors[key] = self._timed("anchor", self.model.anchor_pyramid,
                                       to_dev(arr))

        video_psnr, video_ssim = [], []
        for s in range(0, n_win, bw):
            start = time.time()
            wins = list(range(s, min(s + bw, n_win)))
            for w in range(s, min(s + 2 * bw, n_win)):   # this chunk and the next
                for p in (metas[w][0],) + metas[w][1] + (metas[w][3],):
                    if p != "<ZERO>" and p not in decoded and p not in feat:
                        decoded[p] = pool.submit(load_frame, p)
            gts = [pool.submit(lambda k: load(k)[:nh, :nw], gt_seqs[w][n_seq // 2])
                   for w in wins]
            chunk_paths = [p for w in wins for p in (metas[w][0],) + metas[w][1]]
            for p in dict.fromkeys(chunk_paths):
                if p not in feat:
                    decoded[p].result()
            t_pre = time.time()
            ensure_feats(chunk_paths)
            for w in wins:
                ensure_anchor(metas[w][3])
            hs = [metas[w][2] for w in wins]
            routing = "sharp" if all(hs) else "self" if not any(hs) else "mixed"
            cat = lambda xs: torch.cat(xs, dim=0)
            n_nb = n_seq - 1

            def restore(f_mid, *rest):
                """Under a group on this rank's rows of the chunk only."""
                return self.model.restore_from_features(
                    f_mid, list(rest[:n_nb]), *rest[n_nb:n_nb + 3], routing,
                    rest[-1])

            out = self._timed(
                "restore", shard_rows, restore,
                cat([feat[metas[w][0]][0] for w in wins]),
                *[cat([feat[metas[w][1][k]][1] for w in wins]) for k in range(n_nb)],
                cat([anchors[metas[w][3]][0] for w in wins]),
                cat([anchors[metas[w][3]][1] for w in wins]),
                cat([anchors[metas[w][3]][2] for w in wins]),
                torch.tensor(hs, device=dev))
            names = [os.path.basename(metas[w][0]).split(".")[0] for w in wins]
            self._score_chunk(v, names, out, [g.result for g in gts], start, t_pre,
                              video_psnr, video_ssim)
            # evict what no remaining window needs
            horizon = s + bw
            for p in [p for p, i in last_pos.items() if i < horizon]:
                feat.pop(p, None)
                decoded.pop(p, None)
            keep = {metas[w][3] for w in range(horizon, n_win)} | {"<ZERO>"}
            for p in [p for p in anchors if p not in keep]:
                anchors.pop(p)
        return video_psnr, video_ssim

    def _labels_for_video(self, v: str, input_frames: Sequence[str],
                          load: Callable[[str], np.ndarray]) -> np.ndarray:
        """label/<video>.npy when the tree has a label/ directory, else the
        sharpness detector's labels of the frames (parity:
        inference_SPEINet.py:349-353, speinet_tpu/infer.py:219-226)."""
        if os.path.exists(self.label_path):
            return np.load(os.path.join(self.label_path, v + ".npy"))
        frames = np.stack([load(p) for p in input_frames])
        feats = video_features(frames, kernel_size=11, device=self.device)
        return LogisticRegression.load(self.detector_pickle).predict(feats).reshape(-1)

    def infer(self):
        """Every video of the PNG tree; returns (mean PSNR, mean SSIM)."""
        videos = sorted(os.listdir(self.input_path))
        with ThreadPoolExecutor(max_workers=self.cfg.n_threads) as pool:
            for v in videos:
                input_frames = sorted(glob.glob(os.path.join(self.input_path, v, "*")))
                gt_frames = sorted(glob.glob(os.path.join(self.gt_path, v, "*")))
                labels = self._labels_for_video(v, input_frames, imread)
                self.infer_video(v, input_frames, gt_frames, labels, imread, pool)
        sum_psnr = sum_ssim = 0.0
        n_img = 0
        for k in self.total_psnr:
            self.logger.write_log(
                f"# Video:{k} AVG-PSNR={np.mean(self.total_psnr[k]):.5}, "
                f"AVG-SSIM={np.mean(self.total_ssim[k]):.4}")
            sum_psnr += sum(self.total_psnr[k])
            sum_ssim += sum(self.total_ssim[k])
            n_img += len(self.total_psnr[k])
        if n_img:
            self.logger.write_log(f"# Total AVG-PSNR={sum_psnr / n_img:.5}, "
                                  f"AVG-SSIM={sum_ssim / n_img:.4}")
        return (sum_psnr / n_img if n_img else 0.0,
                sum_ssim / n_img if n_img else 0.0)

    def close(self) -> None:
        self.logger.close()


def profile_run(fn, trace_dir: str, device: torch.device):
    """fn() under torch.profiler, host activity and, on the card, its
    kernels; the trace goes into `trace_dir` as a TensorBoard / Chrome trace
    (`*.pt.trace.json`), as the JAX package's --profile writes a
    jax.profiler trace."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(trace_dir)):
        return fn()


def main(argv=None):
    import sys

    from speinet_tpu_torch.config import parse_args as parse_config_args

    p = argparse.ArgumentParser(
        description="SPEINet inference on PyTorch / CUDA",
        epilog="Any Config field (--template, --compute_dtype, ...) is also "
               "accepted and overlaid on the template.")
    p.add_argument("--save_image", type=lambda s: s.lower() != "false", default=True)
    p.add_argument("--chop", action="store_true",
                   help="4-tile spatial chopped forward")
    p.add_argument("--default_data", type=str, default="",
                   help="preset: " + " | ".join(PRESETS))
    p.add_argument("--data_path", type=str, default="./dataset/test")
    p.add_argument("--model_path", type=str, default="",
                   help="a port state_dict (.pt) or a trainer checkpoint "
                        "(model_best, model_latest); empty = seeded random init")
    p.add_argument("--result_path", type=str, default="./infer_results")
    p.add_argument("--detector_pickle", type=str, default="",
                   help="sharpness detector for trees without label/; empty = "
                        "the packaged default")
    p.add_argument("--self_ensemble", action="store_true",
                   help="8-way flip / transpose ensemble (forward_x8)")
    p.add_argument("--batch_windows", type=int, default=1,
                   help="sliding windows per forward pass")
    p.add_argument("--cache_pyramids", action="store_true",
                   help="reuse per-frame encoder features across windows")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--profile", type=str, default="",
                   help="write a torch.profiler trace of the run into this "
                        "directory")
    for flag, switch, what in (
            ("swin_fuse_block", "SPEINET_SWIN_FUSEBLOCK",
             "1: one kernel per Swin block (K2); 0: attention (K8) + MLP (K9)"),
            ("corr_raw", "SPEINET_CORR_RAW",
             "1: raw unfolds with the norms folded around the kernel; "
             "0: L2-normalized unfolds through K7"),
            ("corr_banded", "SPEINET_CORR_BANDED",
             "1: 'sharp' / 'self' on the maps (K4); 0: on unfolds (K5 / K6)"),
            ("corr_scaled", "SPEINET_CORR_SCALED",
             "1: reference scaled in the kernel (K5); 0: on the host (K6)")):
        p.add_argument(f"--{flag}", type=int, choices=(0, 1), default=1,
                       help=f"{what} (mirrors the JAX package's {switch})")
    argv = list(sys.argv[1:] if argv is None else argv)
    args, config_argv = p.parse_known_args(argv)
    cfg = parse_config_args(config_argv).replace(chop=args.chop)
    if args.default_data:
        if args.default_data not in PRESETS:
            raise SystemExit(f"unknown preset {args.default_data}; "
                             f"choose from {sorted(PRESETS)}")
        dpath, rpath = PRESETS[args.default_data]
        if args.data_path == "./dataset/test":
            args.data_path = dpath
        if args.result_path == "./infer_results":
            args.result_path = rpath
    if torch.device(args.device).type == "cuda" and not any(
            a.split("=")[0] == "--compute_dtype" for a in config_argv):
        cfg = cfg.replace(compute_dtype="bfloat16")   # what the kernels take
    inf = Inference(cfg, args.data_path, args.model_path, args.result_path,
                    save_image=args.save_image, border=cfg.border,
                    detector_pickle=args.detector_pickle or None,
                    self_ensemble=args.self_ensemble,
                    batch_windows=args.batch_windows,
                    cache_pyramids=args.cache_pyramids, device=args.device,
                    swin_fuse_block=bool(args.swin_fuse_block),
                    corr_raw=bool(args.corr_raw), corr_banded=bool(args.corr_banded),
                    corr_scaled=bool(args.corr_scaled))
    try:
        if args.profile:
            profile_run(inf.infer, args.profile, inf.device)
        else:
            inf.infer()
    finally:
        inf.close()


if __name__ == "__main__":
    main()
