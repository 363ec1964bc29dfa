"""Head-to-head training curves (port of `scripts/head_to_head.py`).

The JAX repository trained the reference architecture (a torch replica)
and the JAX package on one generated GoProRS tree under one shared sample
plan (the same window indices, crops and flips, step by step), with one
loss (1*L1+2*HEM), optimizer (Adam 1e-4) and step count, and scored both
with one PSNR on the same eval windows. Its curves are committed under
`docs/quality_evidence/`. This module writes the same tree and plan and
trains the port on them, so its curve stands beside those:

    python -m speinet_tpu_torch.evidence.head_to_head --phase gen --root R
    python -m speinet_tpu_torch.evidence.head_to_head --phase port --root R \\
        [--seed 11] [--device cpu]
    python -m speinet_tpu_torch.evidence.head_to_head --phase report --root R \\
        [--table docs/quality_evidence/head_to_head.md] --out R/head_to_head.md

`port` trains `SPEINet` at the shared shrunk config (n_feat 16, n_resblock
2, embed 64, depths [2, 2], heads [4, 4], window 5, patch 80, batch 4),
initialised from a generator seeded by `--seed`; DropPath and HEM draw from
a second generator (seed + 2). It computes in bfloat16 on the card and in
float32 on the CPU, and writes `curve_port[_s<seed>].json` in the schema of
the committed `curve_jax.json`. `report` tabulates every `curve_*.json`
under the root, and the columns of committed markdown tables given by
`--table`. The `H2H_*` environment variables override the config as in the
JAX script. The JAX script's `torch` phase (its replica of the reference)
has no counterpart: its curves are committed.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import tempfile
import time

import numpy as np

N_FEAT = int(os.environ.get("H2H_NFEAT", "16"))
N_RES = int(os.environ.get("H2H_NRES", "2"))
EMBED = int(os.environ.get("H2H_EMBED", "64"))
DEPTHS = tuple(int(v) for v in os.environ.get("H2H_DEPTHS", "2,2").split(","))
HEADS = tuple(int(v) for v in os.environ.get("H2H_HEADS", "4,4").split(","))
WS, MLP = 5, 2.0
PATCH = int(os.environ.get("H2H_PATCH", "80"))
BATCH, LR = 4, 1e-4
SEED = 11
FRAMEWORK = "speinet_tpu_torch"


def build_cfg():
    from speinet_tpu_torch.config import Config, set_template

    return set_template(Config(template="SPEINet")).replace(
        n_feat=N_FEAT, n_resblock=N_RES, embed_dim=EMBED,
        depths=list(DEPTHS), num_heads=list(HEADS), window_size=WS,
        mlp_ratio=MLP, patch_size=PATCH, batch_size=BATCH, lr=LR,
        n_threads=1, process=True)


def phase_gen(root: str, steps: int) -> None:
    """The tree (train: 3 videos of 120 192x224 frames; eval: 1 video of 40
    180x220 frames, so lv3 is 45x55, a multiple of the window) and the
    sample plan of `steps` batches."""
    from speinet_tpu_torch.data.gopro_rs import generate_dataset, make_sharp_videos
    from speinet_tpu_torch.data.videodata import VideoDataset

    os.makedirs(root, exist_ok=True)
    sharp = os.path.join(root, "sharp")
    make_sharp_videos(os.path.join(sharp, "train"), n_videos=3, n_frames=120,
                      h=192, w=224, seed=SEED)
    make_sharp_videos(os.path.join(sharp, "eval"), n_videos=1, n_frames=40,
                      h=180, w=220, seed=SEED + 1)
    generate_dataset(os.path.join(sharp, "train"), os.path.join(root, "train"),
                     ratios=(0.5,), seed=SEED, mixed=False)
    generate_dataset(os.path.join(sharp, "eval"), os.path.join(root, "eval"),
                     ratios=(0.5,), seed=SEED + 1, mixed=False)
    ds = VideoDataset(build_cfg().replace(dir_data=os.path.join(root, "train")),
                      train=True)
    rng = np.random.default_rng(SEED)
    plan = {
        "steps": steps,
        "batch": BATCH,
        "indices": rng.integers(0, len(ds), size=(steps, BATCH)).tolist(),
        "seeds": rng.integers(0, 2**31 - 1, size=(steps, BATCH)).tolist(),
    }
    with open(os.path.join(root, "plan.json"), "w") as f:
        json.dump(plan, f)
    print(f"tree + plan ready under {root} ({steps} steps x {BATCH})")


def iter_batches(root: str, cfg):
    """(step, inputs [B, 5, 3, h, w], centre gt [B, 3, h, w]) float32 of the
    plan, each sample drawn with its own seeded generator."""
    from speinet_tpu_torch.data.videodata import VideoDataset

    with open(os.path.join(root, "plan.json")) as f:
        plan = json.load(f)
    ds = VideoDataset(cfg.replace(dir_data=os.path.join(root, "train")), train=True)
    mid = cfg.n_sequence // 2
    for step in range(plan["steps"]):
        rows = [ds.__getitem__(plan["indices"][step][j],
                               rng=np.random.default_rng(plan["seeds"][step][j]))
                for j in range(plan["batch"])]
        inputs = np.stack([r[0] for r in rows]).astype(np.float32)
        gt = np.stack([r[1][mid] for r in rows]).astype(np.float32)
        yield step, inputs, gt


def eval_windows(root: str, cfg, n_windows: int = 16):
    """The fixed eval set: the first n full-frame windows of the eval tree."""
    from speinet_tpu_torch.data.videodata import VideoDataset

    ds = VideoDataset(cfg.replace(dir_data_test=os.path.join(root, "eval")),
                      train=False)
    rows = [ds[i] for i in range(0, min(len(ds), n_windows))]
    mid = cfg.n_sequence // 2
    inputs = np.stack([r[0] for r in rows]).astype(np.float32)
    gt = np.stack([r[1][mid] for r in rows]).astype(np.float32)
    return inputs, gt


def psnr_shave4(out: np.ndarray, gt: np.ndarray) -> float:
    """The reference's calc_psnr (util/utils.py:81-92): shave 4, rgb_range 1."""
    diff = (out - gt)[..., 4:-4, 4:-4]
    mse = float((diff ** 2).mean())
    return -10.0 * np.log10(max(mse, 1e-12))


def curve_name(framework: str, seed: int) -> str:
    return f"curve_{framework}{'' if seed == SEED else f'_s{seed}'}.json"


def phase_port(root: str, out_json: str, eval_every: int, seed: int = SEED,
               device="cuda", train_steps: int | None = None,
               eval_windows_n: int = 16) -> dict:
    """Train the port on the plan (its first `train_steps` batches, or all),
    scoring the eval windows every `eval_every` steps and after the last;
    write the curve to `out_json` after each score, and at the end the
    whole record: the curve, the losses of every step, the seconds, and the
    kernel launches of this process (`launches`, `backward_launches`) and
    of the train steps alone (`train_launches`, `train_backward_launches`).
    Returns that record."""
    import torch

    from speinet_tpu_torch.kernels import _lib
    from speinet_tpu_torch.models.speinet import SPEINet, init_weights
    from speinet_tpu_torch.training.loss import LossComputer
    from speinet_tpu_torch.training.train_state import (eval_step, make_optimizer,
                                                        train_step)
    from speinet_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg = build_cfg()
    if dev.type == "cuda":
        cfg = cfg.replace(compute_dtype="bfloat16")     # what the kernels take
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    model = init_weights(SPEINet.from_config(cfg), seed).to(dev)
    n_par = sum(p.numel() for p in model.parameters())
    print(f"[port] model: {n_par / 1e6:.2f} M params on {dev} ({name}), "
          f"{cfg.compute_dtype}", flush=True)
    opt = make_optimizer(cfg, model)
    loss = LossComputer(cfg.loss, rgb_range=cfg.rgb_range)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    ev_in, ev_gt = eval_windows(root, cfg, eval_windows_n)
    ev_in_t = torch.from_numpy(ev_in).to(dev)
    curve, losses, t0 = [], [], time.time()
    train_launches = dict.fromkeys(_lib.LAUNCHES, 0)
    train_backward = dict.fromkeys(_lib.BACKWARD_LAUNCHES, 0)
    record = {}

    def evaluate(step):
        outs = [eval_step(model, ev_in_t[i:i + 1]).float().cpu().numpy()
                for i in range(len(ev_in))]
        p = float(np.mean([psnr_shave4(o[0], g) for o, g in zip(outs, ev_gt)]))
        curve.append({"step": step, "psnr": round(p, 4),
                      "wall_s": round(time.time() - t0, 1)})
        print(f"[port] step {step}: eval PSNR {p:.3f} ({time.time() - t0:.0f}s)",
              flush=True)
        record.update({"framework": FRAMEWORK, "params_m": n_par / 1e6,
                       "curve": curve, "device": name})
        with open(out_json, "w") as f:
            json.dump(record, f, indent=1)

    last = 0
    for step, inputs, gt in iter_batches(root, cfg):
        if train_steps is not None and step >= train_steps:
            break
        before = dict(_lib.LAUNCHES), dict(_lib.BACKWARD_LAUNCHES)
        total, _ = train_step(model, opt, loss, torch.from_numpy(inputs).to(dev),
                              torch.from_numpy(gt).to(dev), gen)
        for k in train_launches:
            train_launches[k] += _lib.LAUNCHES[k] - before[0][k]
        for k in train_backward:
            train_backward[k] += _lib.BACKWARD_LAUNCHES[k] - before[1][k]
        losses.append(total)
        if step % 10 == 0:
            print(f"[port] step {step}: loss {float(total):.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
        last = step + 1
        if last % eval_every == 0:
            evaluate(last)
    if not curve or curve[-1]["step"] != last:
        evaluate(last)
    record.update(losses=[float(v) for v in losses], seconds=time.time() - t0,
                  launches=dict(_lib.LAUNCHES),
                  backward_launches=dict(_lib.BACKWARD_LAUNCHES),
                  train_launches=train_launches,
                  train_backward_launches=train_backward)
    with open(out_json, "w") as f:
        json.dump(record, f, indent=1)
    return record


def read_table(path: str) -> dict:
    """{(framework, seed): {"curve": [...]}} from the step table of a
    committed head-to-head report (columns `<framework> s<seed>`)."""
    rows, header = {}, None
    for line in open(path):
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if header is None:
            if cells and cells[0] == "step":
                header = [re.fullmatch(r"(\S+) s(\d+)", c) for c in cells[1:]]
                for m in header:
                    rows[(m.group(1), int(m.group(2)))] = {"curve": []}
            continue
        if not cells or not cells[0].isdigit():
            if cells and set(cells[0]) <= set("-"):
                continue
            break
        for m, v in zip(header, cells[1:]):
            if v not in ("", "—", "-"):
                rows[(m.group(1), int(m.group(2)))]["curve"].append(
                    {"step": int(cells[0]), "psnr": float(v)})
    return rows


def phase_report(root: str, out_md: str, tables=()) -> dict:
    """Tabulate every curve_{torch,jax,port}*.json under `root` and the
    columns of the markdown `tables`; a JSON curve wins over a table column
    of the same framework and seed."""
    rows, source = {}, {}
    for table in tables:
        for key, rec in read_table(table).items():
            rows[key], source[key] = rec, table
    for path in sorted(glob.glob(os.path.join(root, "curve_*.json"))):
        m = re.fullmatch(r"curve_(torch|jax|port)(?:_s(\d+))?\.json",
                         os.path.basename(path))
        if m:
            key = (m.group(1), int(m.group(2) or SEED))
            with open(path) as f:
                rows[key] = json.load(f)
            source[key] = path
    order = {"torch": 0, "jax": 1, "port": 2}
    keys = sorted(rows, key=lambda k: (order.get(k[0], 3), k[1]))
    steps = sorted({c["step"] for r in rows.values() for c in r["curve"]})
    os.makedirs(os.path.dirname(os.path.abspath(out_md)), exist_ok=True)
    with open(out_md, "w") as f:
        f.write("# Head-to-head: reference architecture (torch), speinet_tpu "
                "(jax) and speinet_tpu_torch (port)\n\n")
        f.write("Identical synthetic GoProRS tree, identical batch sequence "
                "(shared sample plan), identical shrunk hyperparams "
                f"(n_feat={N_FEAT}, n_resblock={N_RES}, embed={EMBED}, "
                f"depths={list(DEPTHS)}, heads={list(HEADS)}, ws={WS}, "
                f"patch={PATCH}, batch={BATCH}, Adam lr={LR}, loss 1*L1+2*HEM). "
                "Eval: PSNR shave=4 on the same fixed eval windows. Seeds vary "
                "model init + HEM sampling only; the data/batch sequence is "
                "shared. Written by `python -m "
                "speinet_tpu_torch.evidence.head_to_head --phase report`.\n\n")
        header = " | ".join(f"{fw} s{sd}" for fw, sd in keys)
        f.write(f"| step | {header} |\n|---|{'---|' * len(keys)}\n")
        for s in steps:
            cells = []
            for k in keys:
                v = next((c["psnr"] for c in rows[k]["curve"] if c["step"] == s), None)
                cells.append(f"{v:.3f}" if v is not None else "—")
            f.write(f"| {s} | {' | '.join(cells)} |\n")
        for k in keys:
            r, last = rows[k], rows[k]["curve"][-1]
            src = os.path.relpath(source[k], os.path.dirname(os.path.abspath(out_md)))
            line = f"\n{k[0]} s{k[1]}: final {last['psnr']:.3f} dB at step {last['step']}"
            if "params_m" in r:
                line += f", {r['params_m']:.2f} M params"
            if "wall_s" in last:
                line += f", {last['wall_s']:.0f}s wall"
            if "device" in r:
                line += f", on {r['device']}"
            f.write(line + f" (from `{src}`)\n")
    print(f"wrote {out_md}")
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="head-to-head training curves")
    p.add_argument("--phase", required=True, choices=["gen", "port", "report"])
    p.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                  "head_to_head"))
    p.add_argument("--steps", type=int, default=600, help="plan length (gen)")
    p.add_argument("--eval_every", type=int, default=100)
    p.add_argument("--seed", type=int, default=SEED,
                   help="model-init / HEM seed (the data plan stays fixed)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--table", nargs="*", default=[],
                   help="committed markdown reports whose columns join the table")
    p.add_argument("--out", default=None,
                   help="report path (default <root>/head_to_head.md)")
    a = p.parse_args(argv)
    if a.phase == "gen":
        phase_gen(a.root, a.steps)
    elif a.phase == "port":
        phase_port(a.root, os.path.join(a.root, curve_name("port", a.seed)),
                   a.eval_every, a.seed, a.device)
    else:
        phase_report(a.root, a.out or os.path.join(a.root, "head_to_head.md"),
                     a.table)


if __name__ == "__main__":
    main()
