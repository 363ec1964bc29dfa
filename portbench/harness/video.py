"""Video cells: 720p videos restored back to back by the program's video
engine (`speinet_tpu_torch.infer.Inference.infer_video`), frames served
from a pool in host memory through the engine's `load` callable.

The engine's per-frame log goes to a `ChunkClock` of the benchmark's own,
which stamps the completion of each chunk (the `batch_windows` windows
the engine restores and scores together) and closes the window at the
first chunk that completes after its end. The model's three engine calls
are wrapped on the instance with spans; the restore's wrapper also copies
a sample of restored chunks, drawn from the seed, to pinned host memory
(asynchronously, on the card's stream) for the check against the
reference."""

from __future__ import annotations

import gc
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from portbench.harness import flops as flop_count
from portbench.harness.common import bound_s, device_info, phase
from portbench.harness.synth import frame_pool, sharp_labels
from portbench.harness.trace import Tracer, breakdown
from portbench.reference.model import Net, Ops, make_weights, speinet_windows
from portbench.reference.precision import strict_float32
from portbench.reference.windows import ZERO, windows

SAMPLE_CHUNKS = 5           # window chunks sampled for the check, drawn from the seed
SAMPLE_FROM_CHUNKS = 120    # ... among the window's first chunks
TRACE_SKIP_S = 4.0          # window seconds before the profiled stretch
TRACE_CHUNKS = 10           # chunks profiled
DECODE_THREADS = 4          # threads serving the engine's frame loads


class WindowClosed(Exception):
    """Raised through the engine when the chunk that ends the window is done."""


class ChunkClock:
    """The engine's logger: one call per scored frame; stamps chunk ends."""

    def __init__(self, bw: int):
        self.bw = bw
        self.deadline = None
        self.video = -1
        self.lines = self.n_win = 0
        self.frames = []        # (t done, video, window)
        self.chunks = []        # t done
        self.on_chunk = None

    def start_video(self, video: int, n_win: int) -> None:
        self.video, self.lines, self.n_win = video, 0, n_win

    def write_log(self, line: str) -> None:
        if not line.startswith("> "):
            return
        self.lines += 1
        if self.lines % self.bw and self.lines != self.n_win:
            self.frames.append((None, self.video, self.lines - 1))
            return
        t = time.perf_counter()
        k = len(self.frames)
        while k and self.frames[k - 1][0] is None:
            k -= 1
            self.frames[k] = (t,) + self.frames[k][1:]
        self.frames.append((t, self.video, self.lines - 1))
        self.chunks.append(t)
        if self.on_chunk is not None:
            self.on_chunk(t)
        if self.deadline is not None and t >= self.deadline:
            raise WindowClosed

    def close(self) -> None:
        pass


class Videos:
    """Video k of the stream: n frames of the pool from an offset drawn from
    the seed, and the labels of pattern k mod len(patterns): the label
    patterns are the traffic's own (drawn once from its `label_seed`), so
    every seed restores the same routings and anchors, on other frames
    with other weights. Frames are served by key."""

    def __init__(self, pool_sharp, pool_blur, n: int, patterns, seed: int):
        self.sharp, self.blur = pool_sharp, pool_blur
        self.n, self.patterns = n, patterns
        self.rng = np.random.default_rng([seed, 1])
        self.videos = []

    @staticmethod
    def patterns_of(tp: dict):
        """The traffic's label patterns."""
        rng = np.random.default_rng(tp["label_seed"])
        return [sharp_labels(tp["frames_per_video"], tp["sharp_ratio"], rng)
                for _ in range(tp["label_patterns"])]

    def get(self, k: int):
        while len(self.videos) <= k:
            off = int(self.rng.integers(len(self.sharp)))
            self.videos.append((off, self.patterns[len(self.videos) % len(self.patterns)]))
        return self.videos[k]

    def keys(self, k: int, kind: str, n: int | None = None):
        return [f"{kind}{k:05d}/{i:08d}" for i in range(self.n if n is None else n)]

    def load(self, key: str) -> np.ndarray:
        kind, k, i = key[:4], int(key[4:9]), int(key[10:])
        pool = self.blur if kind == "blur" else self.sharp
        return pool[(self.get(k)[0] + i) % len(pool)]

    def frame(self, key: str, device) -> torch.Tensor:
        """The frame as the model reads it: [3, H, W] float32 in [0, 1]."""
        return torch.from_numpy(self.load(key).transpose(2, 0, 1).astype(np.float32)
                                / 255.0).to(device)


def port_config(cfg: dict):
    from speinet_tpu_torch.config import Config

    fields = set(Config.__dataclass_fields__)
    return Config(template="none").replace(**{k: v for k, v in cfg.items() if k in fields})


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
        t_process: float, checks) -> dict:
    """One run of the cell: set-up, the window, with `trace` its profiled
    stretch, then the check (into `checks`). Returns attempted, failed,
    the end-to-end metrics (`e2e`), the per-layer metrics' context and
    breakdown (traced runs) and the device record."""
    from speinet_tpu_torch.infer import Inference
    from speinet_tpu_torch.kernels import _lib

    tp = traffic["params"]
    bw, n_frames = tp["batch_windows"], tp["frames_per_video"]
    h, w = tp["height"], tp["width"]
    ns = cfg["n_sequence"]
    phase("imports")
    weights = make_weights(cfg, seed, device)
    phase("weights")
    sharp, blur = frame_pool(tp["pool_frames"], h, w, seed + 1, device)
    vids = Videos(sharp, blur, n_frames, Videos.patterns_of(tp), seed)
    phase("inputs")
    tmp = tempfile.mkdtemp(prefix="portbench_")
    pcfg = port_config(cfg)
    inf = Inference(pcfg, data_path=tmp, model_path="", result_path=tmp,
                    save_image=False, batch_windows=bw, cache_pyramids=True,
                    device=str(device), seed=seed % (1 << 31))
    inf.model.load_state_dict(weights, strict=True)
    inf.logger.close()
    phase("engine")
    clock = ChunkClock(bw)
    inf.logger = clock
    model = inf.model

    # spans around the engine's three model calls; the restore's wrapper
    # also keeps the sample of restored chunks
    rng = np.random.default_rng([seed, 2])
    picks = set(rng.choice(SAMPLE_FROM_CHUNKS, SAMPLE_CHUNKS, replace=False).tolist())
    cap_shape = (bw, 3, h, w)
    pinned = [torch.empty(cap_shape, pin_memory=device.type == "cuda")
              for _ in range(SAMPLE_CHUNKS + 3)]
    state = {"window": False, "chunk": 0, "routings": set(), "captured": []}

    tracer = Tracer()

    def spanned(name, fn):
        def call(*a, **k):
            with tracer.span(name):
                return fn(*a, **k)
        return call

    restore_fn = model.restore_from_features

    def restore(*a, **k):
        with tracer.span("restore"):
            out = restore_fn(*a, **k)
        if state["window"]:
            routing = a[5] if len(a) > 5 else k["routing"]
            c = state["chunk"]
            first = routing not in state["routings"]
            state["routings"].add(routing)
            if (first or c in picks) and len(state["captured"]) < len(pinned):
                buf = pinned[len(state["captured"])][:out.shape[0]]
                buf.copy_(out, non_blocking=True)
                state["captured"].append((clock.video, clock.lines // bw, routing, buf))
            state["chunk"] += 1
        return out

    model.encode_window_legs = spanned("legs", model.encode_window_legs)
    model.anchor_pyramid = spanned("anchor", model.anchor_pyramid)
    model.restore_from_features = restore

    pool = ThreadPoolExecutor(max_workers=DECODE_THREADS)
    try:
        # warm-up: every routing at the cell's shapes ('sharp', 'mixed', 'self')
        wl = np.asarray(tp["warmup_labels"], np.int64)
        warm = Videos(sharp, blur, len(wl), [wl], seed)
        clock.start_video(-1, len(wl))
        inf.infer_video("warmup", warm.keys(0, "blur", len(wl)),
                        warm.keys(0, "gtfr", len(wl)), wl, warm.load, pool)
        torch.cuda.synchronize(device) if device.type == "cuda" else None

        phase("warm-up")
        if trace:
            tracer.warm()
        traced = {}
        trace_skip = min(TRACE_SKIP_S, 0.2 * seconds)

        def on_chunk(t):
            """Profile TRACE_CHUNKS chunks from the first chunk done after
            `trace_skip` seconds of the window."""
            if not trace or "stop" in traced:
                return
            if "start" not in traced:
                if t >= t0 + trace_skip:
                    traced.update(stages0=dict(inf.stage_seconds), chunks0=len(clock.chunks),
                                  launches0=dict(_lib.LAUNCHES), frames0=len(clock.frames))
                    tracer.start()
                    traced["start"] = time.perf_counter()
            elif len(clock.chunks) >= traced["chunks0"] + TRACE_CHUNKS:
                tracer.stop()
                traced.update(stop=time.perf_counter(), stages1=dict(inf.stage_seconds),
                              launches1=dict(_lib.LAUNCHES), frames1=len(clock.frames))

        for k in inf.stage_seconds:
            inf.stage_seconds[k] = 0.0
        clock.frames.clear()
        clock.chunks.clear()
        clock.on_chunk = on_chunk
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.time() - t_process
        t0 = time.perf_counter()
        clock.deadline = t0 + seconds
        state["window"] = True
        k = 0
        try:
            while True:
                off, labels = vids.get(k)
                clock.start_video(k, n_frames)
                inf.infer_video(f"v{k}", vids.keys(k, "blur"), vids.keys(k, "gtfr"),
                                labels, vids.load, pool)
                k += 1
        except WindowClosed:
            pass
        state["window"] = False
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_end = clock.chunks[-1]
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    finally:
        pool.shutdown(wait=True)
        inf.close()
        shutil.rmtree(tmp, ignore_errors=True)
    stages = dict(inf.stage_seconds)
    captured = state["captured"]
    del inf, model, restore_fn
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    window_s = t_end - t0
    n_done = len(clock.frames)
    gaps = np.diff([t0] + clock.chunks) * 1e3
    e2e = {"frames_per_s": n_done / window_s,
           "chunk_ms.p95": float(np.percentile(gaps, 95)),
           "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}

    per_layer_ctx = None
    bd = None
    if trace:
        summ = tracer.summarize()
        frames_t = clock.frames[traced["frames0"]:traced["frames1"]]
        wins = [(v, wi) for _, v, wi in frames_t]
        stage = {s: stages[s] - (traced["stages1"][s] - traced["stages0"][s])
                 for s in stages}
        n_untraced = n_done - len(frames_t)
        per_layer_ctx = {
            "kind": "video", "trace": summ, "stage_seconds": stage,
            "frames": n_untraced, "traced_frames": len(frames_t),
            "launches": {kk: traced["launches1"][kk] - traced["launches0"][kk]
                         for kk in traced["launches0"]},
            "k2_launch": flop_count.k2_launch(cfg, bw, h, w),
            "model_flops": flop_count.video_flops(cfg, vids, wins, h, w),
            "bound_s": bound_s,
        }
        bd = breakdown(summ)

    phase("window and trace")
    # the check: the sampled chunks against the reference, in float32
    net = Net(cfg, Ops())
    with torch.no_grad(), strict_float32():
        for k, v in compare_chunks(net, weights, vids, captured, bw, ns, device).items():
            checks.add(k, v)
    return {"attempted": n_done, "failed": 0, "e2e": e2e, "per_layer_ctx": per_layer_ctx,
            "breakdown": bd,
            "device": device_info(device, peak, per_layer_ctx and per_layer_ctx["trace"])}


def chunk_windows(vids: Videos, v: int, c: int, bw: int, ns: int):
    """The windows of chunk c of video v: (frame keys, has_sharp, anchor)."""
    off, labels = vids.get(v)
    wins = windows(vids.keys(v, "blur"), labels, ns)
    return wins[c * bw:(c + 1) * bw]


def reference_chunk(net: Net, p, vids: Videos, wins, device) -> torch.Tensor:
    """The reference's restored frames [n, 3, H, W] of these windows."""
    frames = torch.stack([torch.stack([vids.frame(k, device) for k in f])
                          for f, _, _ in wins])
    anchors = torch.stack([torch.zeros_like(frames[0, 0]) if a == ZERO
                           else vids.frame(a, device) for _, _, a in wins])
    return speinet_windows(p, net, frames, anchors, [hs for _, hs, _ in wins])


def rel_rms(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Per frame ||out - ref|| / ||ref||, the worst of the frames."""
    d = (out.float() - ref).flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1)
    return float(d.max())


def _err_quantile(out: torch.Tensor, ref: torch.Tensor, q: float) -> float:
    """Per frame the q-quantile of |out - ref| over its values, against the
    frame's RMS, the worst of the frames."""
    d = torch.quantile((out.float() - ref).abs().flatten(1), q, dim=1)
    return float((d / ref.flatten(1).pow(2).mean(dim=1).sqrt()).max())


def med_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The median error (`_err_quantile`): blind to the few patches that a
    near tie in the search sends elsewhere, not to an error everywhere."""
    return _err_quantile(out, ref, 0.5)


def p99_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The 99th percentile error: sees an error on a hundredth of a frame
    or more (a wrong tile, band or window border)."""
    return _err_quantile(out, ref, 0.99)


FRAME_NUMBERS = {"frame_rel_rms": rel_rms, "frame_med_err": med_err,
                 "frame_p99_err": p99_err}


def compare_chunks(net: Net, p, vids: Videos, captured, bw: int, ns: int,
                   device) -> dict:
    """Each of FRAME_NUMBERS, the worst over the sampled chunks' frames
    (inf where nothing was sampled)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out = dict.fromkeys(FRAME_NUMBERS, float("inf") if not captured else 0.0)
    for v, c, _, buf in captured:
        wins = chunk_windows(vids, v, c, bw, ns)
        ref = reference_chunk(net, p, vids, wins, device)
        got = buf[:len(wins)].to(device)
        read = {k: fn(got, ref) for k, fn in FRAME_NUMBERS.items()}
        out = {k: max(out[k], read[k]) for k in out}
        print(f"chunk {v}/{c} {[w[1] for w in wins]}: "
              + " ".join(f"{k} {x:.5f}" for k, x in read.items()), file=sys.stderr)
    return out
