"""The readings that the check's limits are set from, besides the program's
own runs: the control (the reference computed with float8 operands, in
the program's place) and the faults a cell can have, each planted in the
reference put in the program's place, at the cell's own size.

Video cells: the control; an answer altered where it is produced, whole
(one restored frame of the chunk replaced by its blurred input) or in
part (one quadrant of that frame so replaced). Training cells: the
control; half of the batch left out, the mean taken over the rest, once
with only that half forwarded (`half_batch`) and once with the whole
batch forwarded and half of it dropped from the loss (`half_loss`); a
step that leaves the state unchanged reads 1 by the change's measure and
needs no run."""

from __future__ import annotations

import shutil
import tempfile

import torch

from portbench.harness.train import REFERENCE_STEPS, build_loader, compare_steps
from portbench.harness.video import FRAME_NUMBERS, Videos, chunk_windows, reference_chunk
from portbench.harness.synth import frame_pool
from portbench.reference.model import Net, Ops, make_weights
from portbench.reference.precision import fp8, strict_float32
from portbench.reference.train import loss_fn, train_steps


def video_chunks(vids: Videos, bw: int, ns: int, per_routing: int = 1):
    """(video, chunk) pairs of the stream's first videos, `per_routing` of
    each routing that occurs there."""
    found: dict = {}
    for v in range(4):
        n_chunks = -(-vids.n // bw)
        for c in range(n_chunks):
            wins = chunk_windows(vids, v, c, bw, ns)
            hs = [w[1] for w in wins]
            r = "sharp" if all(hs) else "self" if not any(hs) else "mixed"
            if len(found.setdefault(r, [])) < per_routing:
                found[r].append((v, c))
    return [vc for r in sorted(found) for vc in found[r]]


def video_readings(cfg: dict, traffic: dict, seed: int, device) -> dict:
    tp = traffic["params"]
    bw, ns = tp["batch_windows"], cfg["n_sequence"]
    h, w = tp["height"], tp["width"]
    p = make_weights(cfg, seed, device)
    sharp, blur = frame_pool(tp["pool_frames"], h, w, seed + 1, device)
    vids = Videos(sharp, blur, tp["frames_per_video"], Videos.patterns_of(tp), seed)
    ref_net, ctl_net = Net(cfg, Ops()), Net(cfg, Ops(fp8))
    sources = ("control", "answer_altered", "quadrant_altered")
    out = {k: dict.fromkeys(sources, 0.0) for k in FRAME_NUMBERS}
    chunks = video_chunks(vids, bw, ns)
    with torch.no_grad(), strict_float32():
        for v, c in chunks:
            wins = chunk_windows(vids, v, c, bw, ns)
            ref = reference_chunk(ref_net, p, vids, wins, device)
            blurred = vids.frame(wins[0][0][ns // 2], device)
            bad = ref.clone()
            bad[0] = blurred
            part = ref.clone()
            part[0, :, :h // 2, :w // 2] = blurred[:, :h // 2, :w // 2]
            got = {"control": reference_chunk(ctl_net, p, vids, wins, device),
                   "answer_altered": bad, "quadrant_altered": part}
            for k, fn in FRAME_NUMBERS.items():
                for src in sources:
                    out[k][src] = max(out[k][src], fn(got[src], ref))
    return {**out, "chunks": chunks}


def train_readings(cfg: dict, traffic: dict, seed: int, device) -> dict:
    tp = traffic["params"]
    p = make_weights(cfg, seed, device)
    tmp = tempfile.mkdtemp(prefix="portbench_")
    try:
        pcfg, loader = build_loader(cfg, tp, seed, tmp, device)
        it = iter(loader)          # the trainer's first steps: one epoch's first batches
        raw = [next(it) for _ in range(REFERENCE_STEPS)]
        del it
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mid = cfg["n_sequence"] // 2
    batches = [(torch.from_numpy(x).to(device), torch.from_numpy(g[:, mid]).to(device))
               for x, g, *_ in raw]
    half = [(x[:x.shape[0] // 2], g[:g.shape[0] // 2]) for x, g in batches]

    def half_loss(out, gt, u):
        n = out.shape[0] // 2
        return loss_fn(out[:n], gt[:n], u[:n])

    gen_seed = pcfg.seed + 1
    out = {}
    with strict_float32():
        ref = train_steps(Net(cfg, Ops(), ckpt=True), p, batches, gen_seed, lr=cfg["lr"])
        for name, net, bs, loss in (
                ("control", Net(cfg, Ops(fp8), ckpt=True), batches, loss_fn),
                ("half_batch", Net(cfg, Ops(), ckpt=True), half, loss_fn),
                ("half_loss", Net(cfg, Ops(), ckpt=True), batches, half_loss)):
            run = train_steps(net, p, bs, gen_seed, lr=cfg["lr"], loss=loss)
            out[name] = compare_steps(run["losses"], run["grad1"], run["p_end"], p, ref,
                                      run["out1"])
            del run
    out["state_unchanged"] = {"change_leaf": 1.0}
    return out
