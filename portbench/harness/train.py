"""Training cells: the program's trainer (`Trainer.train()`: its batch
iterator, `prefetch_to_device` and `train_step`) on 720p videos held in
memory, patches cropped by the program's loader.

Set-up builds one trainer and drives it through its first steps as one
epoch of `REFERENCE_STEPS` batches, through the same `train()` and the
same feed the window uses, so the next batch is uploaded while a step
runs, as in the window; the reference follows those steps. The window is
one more epoch, whose feed stops handing out batches once the window's
time is up; the batches already prefetched are still stepped, and
counted, and the window ends at a device sync after the last."""

from __future__ import annotations

import gc
import os
import sys
import shutil
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench.harness import flops as flop_count
from portbench.harness.common import device_info, phase
from portbench.harness.synth import frame_pool
from portbench.harness.trace import Tracer, breakdown
from portbench.harness.video import port_config
from portbench.reference.model import Net, Ops, make_weights
from portbench.reference.precision import strict_float32
from portbench.reference.train import loss_fn, train_steps

REFERENCE_STEPS = 3       # the set-up steps the reference follows
TRACE_SKIP_STEPS = 2      # window steps before the profiled stretch
TRACE_STEPS = 1           # steps profiled: a step is some 20,000 kernels; the
                          # profiler dropped marker kernels from a trace of three


def memory_tree(root: str, pool_sharp, pool_blur, videos: int, frames: int,
                ratios, rng: np.random.Generator) -> dict:
    """A dataset tree under root (gt/, blur/, label/) of empty frame files;
    the frames themselves are the pool's, by path. Each video takes one
    ratio of the menu, in turn, and that share of sharp frames at random
    places; its frames run through the pool from a random offset."""
    store = {}
    os.makedirs(os.path.join(root, "label"), exist_ok=True)
    n_pool = len(pool_sharp)
    for v in range(videos):
        name = f"video{v:03d}"
        labels = np.zeros(frames, np.int64)
        k = int(round(ratios[v % len(ratios)] * frames))
        labels[rng.choice(frames, size=k, replace=False)] = 1
        np.save(os.path.join(root, "label", name + ".npy"), labels)
        off = int(rng.integers(n_pool))
        for kind, pool in (("gt", pool_sharp), ("blur", pool_blur)):
            os.makedirs(os.path.join(root, kind, name))
            for i in range(frames):
                path = os.path.join(root, kind, name, f"{i:08d}.png")
                open(path, "wb").close()
                store[path] = pool[(off + i) % n_pool]
    return store


class Feed:
    """The loader handed to the trainer: the program's batch iterator, a
    span and a host-clock time around each next(), and a stop after
    `limit` batches or once `deadline` has passed. Keeps the first
    `keep` batches for the reference."""

    def __init__(self, loader, keep: int, tracer: Tracer):
        self.loader = loader
        self.tracer = tracer
        self.limit = None
        self.deadline = None
        self.keep = keep
        self.kept = []
        self.next_s = []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        n = 0
        while self.limit is None or n < self.limit:
            if self.deadline is not None and time.perf_counter() >= self.deadline:
                return
            t = time.perf_counter()
            with self.tracer.span("next_batch"):
                batch = next(it, None)
            self.next_s.append(time.perf_counter() - t)
            if batch is None:
                raise RuntimeError("the epoch ended inside the window: the tree "
                                   "holds too few windows")
            if len(self.kept) < self.keep:
                self.kept.append((batch[0].copy(), batch[1].copy()))
            n += 1
            yield batch


def build_loader(cfg: dict, tp: dict, seed: int, tmp: str, device):
    """(the program's config, its shuffled batch iterator over the cell's
    in-memory tree under tmp)."""
    from speinet_tpu_torch.data.loader import BatchIterator
    from speinet_tpu_torch.data.videodata import VideoDataset

    sharp, blur = frame_pool(tp["pool_frames"], tp["height"], tp["width"], seed + 1, device)
    rng = np.random.default_rng([seed, 3])
    store = memory_tree(os.path.join(tmp, "train"), sharp, blur, tp["videos"],
                        tp["frames_per_video"], tp["sharp_ratios"], rng)
    pcfg = port_config(cfg).replace(
        seed=seed % (1 << 62), dir_data=os.path.join(tmp, "train"),
        experiment_dir=tmp + "/", save="bench", epochs=1 << 30,
        print_every=1 << 30, save_images=False, n_threads=tp["loader_threads"],
        n_frames_per_video=tp["frames_per_video"])

    class MemoryVideos(VideoDataset):
        def _imread(self, path):
            return store[path]

    loader = BatchIterator(MemoryVideos(pcfg, train=True), pcfg.batch_size, shuffle=True,
                           seed=pcfg.seed, n_threads=pcfg.n_threads, drop_last=True)
    return pcfg, loader


class Spanned:
    """A callable of the program (the trainer's loss) with a span around
    each call; every attribute is the callable's own. Keeps the first
    element of its first `keep` results (the step's loss), detached."""

    def __init__(self, fn, tracer: Tracer, name: str, keep: int = 0):
        self._fn, self._tracer, self._name = fn, tracer, name
        self._keep, self.kept = keep, []

    def __getattr__(self, attr):
        return getattr(self._fn, attr)

    def __call__(self, *a, **k):
        with self._tracer.span(self._name):
            out = self._fn(*a, **k)
        if len(self.kept) < self._keep:
            self.kept.append(out[0].detach().clone())
        return out


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
        t_process: float, checks) -> dict:
    """One run of the cell: set-up, the window, with `trace` its profiled
    stretch, then the check (into `checks`). Returns attempted, failed,
    the end-to-end metrics (`e2e`), the per-layer metrics' context and
    breakdown (traced runs) and the device record."""
    from speinet_tpu_torch.models import make_model
    from speinet_tpu_torch.training.trainer import Trainer
    from speinet_tpu_torch.utils.logging import Logger

    tp = traffic["params"]
    n_ref = REFERENCE_STEPS
    phase("imports")
    weights = make_weights(cfg, seed, device)
    phase("weights")
    tmp = tempfile.mkdtemp(prefix="portbench_")
    pcfg, loader = build_loader(cfg, tp, seed, tmp, device)

    class Quiet(Logger):
        def plot(self, values, label, filename):
            pass

        def write_log(self, log):
            self.log_file.write(log + "\n")

    phase("inputs")
    tracer = Tracer()
    feed = Feed(loader, n_ref, tracer)
    model = make_model(pcfg)
    model.load_state_dict(weights, strict=True)
    phase("model")
    logger = Quiet(pcfg)
    trainer = Trainer(pcfg, SimpleNamespace(loader_train=feed, loader_test=None), model,
                      logger, device=str(device))
    phase("trainer")
    if trace:
        tracer.warm()
    marks = {}
    forward_fn = model.forward

    def forward(*a, **k):
        step = trainer.step
        if trace and marks.get("window"):
            if step == marks["start_step"]:
                tracer.start()
                marks["traced"] = True
            elif step == marks["start_step"] + TRACE_STEPS:
                tracer.stop()
                marks["stopped"] = True
        with tracer.span("forward"):
            out = forward_fn(*a, **k)
        if "out1" not in marks:
            marks["out1"] = out.detach().float().clone()
        return out

    model.forward = forward
    opt = trainer.optimizer
    step_fn = opt.step
    names = {id(p): n for n, p in model.named_parameters()}

    def optimizer_step(*a, **k):
        with tracer.span("optimizer"):
            out = step_fn(*a, **k)
        if "grad1" not in marks:       # the first step's gradient, from Adam's state
            b1 = opt.param_groups[0]["betas"][0]
            marks["grad1"] = {names[id(p)]: s["exp_avg"] / (1 - b1)
                              for p, s in opt.state.items()}
        return out

    opt.step = optimizer_step
    trainer.loss = Spanned(trainer.loss, tracer, "loss", keep=n_ref)

    phase("profiler and spans")
    # the first steps: one epoch of n_ref batches
    feed.limit = n_ref
    trainer.train()
    losses = [float(v) for v in trainer.loss.kept]
    grad1 = marks["grad1"]
    p_end = {n: p.detach().clone() for n, p in model.named_parameters()}

    phase("first steps")
    feed.limit = None
    feed.next_s.clear()
    marks.update(window=True, start_step=trainer.step + TRACE_SKIP_STEPS)
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - t_process
    step0 = trainer.step
    t0 = time.perf_counter()
    feed.deadline = t0 + seconds
    trainer.train()
    sync(device)
    t_end = time.perf_counter()
    marks["window"] = False
    steps = trainer.step - step0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    batch = pcfg.batch_size
    next_s = list(feed.next_s)
    kept = feed.kept
    logger.done()
    del trainer, model, opt, forward_fn, step_fn, feed, loader
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)

    window_s = t_end - t0
    e2e = {"windows_per_s": steps * batch / window_s,
           "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    ctx, bd = None, None
    if trace and marks.get("stopped"):
        summ = tracer.summarize()
        n_sharp = int(sum(bool(np.any(x[3] != 0)) for x in kept[0][0]))
        ctx = {"kind": "train", "trace": summ, "traced_steps": TRACE_STEPS,
               "next_s": next_s, "batch": batch,
               "step_flops": flop_count.train_step_flops(
                   _json(cfg), batch, cfg["patch_size"], n_sharp)}
        bd = breakdown(summ)

    phase("window and trace")
    # the check: the first steps against the reference, in float32
    batches = [(torch.from_numpy(x).to(device),
                torch.from_numpy(g[:, cfg["n_sequence"] // 2]).to(device)) for x, g in kept]
    net = Net(cfg, Ops(), ckpt=True)
    with strict_float32():
        ref = train_steps(net, weights, batches, pcfg.seed + 1, lr=cfg["lr"])
    for k, v in compare_steps(losses, grad1, p_end, weights, ref, marks["out1"]).items():
        checks.add(k, v)
    print(f"losses {losses} reference {ref['losses']}", file=sys.stderr)
    print(f"worst grad1 leaves {worst_leaves(grad1, ref['grad1'])}", file=sys.stderr)
    moving = {k: p_end[k] - weights[k] for k in ref["grad1"]}
    print(f"worst change leaves {worst_leaves(moving, {k: ref['p_end'][k] - weights[k] for k in moving})}",
          file=sys.stderr)
    return {"attempted": steps, "failed": 0, "e2e": e2e, "per_layer_ctx": ctx,
            "breakdown": bd, "device": device_info(device, peak, ctx and ctx["trace"])}


def _json(cfg: dict) -> str:
    import json

    return json.dumps(cfg, sort_keys=True)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _norms(d: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in d.items()}


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Per leaf, |norm(program) - norm(reference)| against the larger of
    that leaf's reference norm and the median leaf's."""
    rn = {k: float(ref[k].double().norm()) for k in ref}
    med = float(np.median(list(rn.values())))
    return {k: abs((float(prog[k].double().norm()) if k in prog else 0.0) - rn[k])
            / max(rn[k], med) for k in ref}


def leaf_gap(prog: dict, ref: dict) -> float:
    """The worst leaf's gap (`leaf_gaps`)."""
    return max(leaf_gaps(prog, ref).values())


def worst_leaves(prog: dict, ref: dict, n: int = 4) -> list:
    gaps = leaf_gaps(prog, ref)
    return sorted(((round(v, 5), k) for k, v in gaps.items()), reverse=True)[:n]


def out_gap(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst sample's ||out - ref|| / ||ref|| of the first step's
    restored frames; a sample the program did not restore reads 1."""
    worst = 1.0 if out.shape[0] < ref.shape[0] else 0.0
    n = min(out.shape[0], ref.shape[0])
    d = (out[:n].float() - ref[:n]).flatten(1).norm(dim=1) / ref[:n].flatten(1).norm(dim=1)
    return max(worst, float(d.max()))


def own_loss_gap(loss: float, out1: torch.Tensor, ref: dict) -> float:
    """|the program's first loss - the reference's loss of the program's
    own first restored frames| / the latter, on the reference's ground
    truth and HEM draw: the loss stage alone, which sees how many samples
    the loss took; a sample the program did not restore reads 1."""
    gt, u = ref["gt1"], ref["u1"]
    if out1.shape != gt.shape:
        return 1.0
    own = float(loss_fn(out1.to(gt.dtype), gt, u))
    return abs(loss - own) / own


def compare_steps(losses, grad1, p_end, p0, ref, out1) -> dict:
    """out1_rel: the first step's restored frames by `out_gap`;
    loss1_rel: the first step's |loss - reference| / reference;
    loss1_own: the first step's loss by `own_loss_gap`;
    loss_rel: the worst step's; grad1_leaf: the first step's gradient by
    leaf_gap, grad1_median the median leaf's gap; change_leaf and
    change_median: the same of the parameters' change over the steps, over
    the leaves whose reference gradient is at least a thousandth of the
    median leaf's (the others move under Adam by round-off alone)."""
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    g_ref = ref["grad1"]
    gn = {k: float(v.double().norm()) for k, v in g_ref.items()}
    med = float(np.median(list(gn.values())))
    moving = {k for k, v in gn.items() if v >= 1e-3 * med}
    change_p = {k: p_end[k] - p0[k] for k in moving}
    change_r = {k: ref["p_end"][k] - p0[k] for k in moving}
    g_gaps, c_gaps = leaf_gaps(grad1, g_ref), leaf_gaps(change_p, change_r)
    return {"out1_rel": out_gap(out1, ref["out1"]), "loss1_rel": rel[0],
            "loss1_own": own_loss_gap(losses[0], out1, ref),
            "loss_rel": max(rel),
            "grad1_leaf": max(g_gaps.values()),
            "grad1_median": float(np.median(list(g_gaps.values()))),
            "change_leaf": max(c_gaps.values()),
            "change_median": float(np.median(list(c_gaps.values())))}
