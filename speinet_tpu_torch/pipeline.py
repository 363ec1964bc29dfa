"""One-command pipeline: generate, detector training, SPEINet training and
inference, chained with exit-code checks (port of `scripts/pipeline.py`;
parity: the reference's train.sh:1-22).

    generate (GoProRS tree)  ->  detector train
        ->  SPEINet train    ->  inference eval (detector-routed)

Each stage is a subprocess; a stage that fails stops the chain with its exit
code. Stages share one work directory and can be skipped (--skip
gen,detector,train,infer) to resume.

    python -m speinet_tpu_torch.pipeline --work <dir> [--epochs 1]
    python -m speinet_tpu_torch.pipeline --data <GoProRS tree> --epochs 120
    python -m speinet_tpu_torch.pipeline --device cpu --work <dir> \\
        --extra_train --n_feat 8 --embed_dim 32 --depths 2 --num_heads 4

The training stage runs under `python -m torch.distributed.run --standalone
--nproc_per_node N`, N the `--dp_devices` flag or, with 0, the count of
visible cards; with `--device cpu` it runs as one plain process. The width
flags among `--extra_train` (WIDTH_FLAGS) also reach the inference stage,
so a narrow model runs end to end, and the inference stage reads the
trained `model_best`, a trainer checkpoint. The generator's sharp videos
come from `data/gopro_rs.py::make_sharp_videos`.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# model-shape flags of main_train that infer.py must see to rebuild the model
WIDTH_FLAGS = ("--n_feat", "--n_resblock", "--embed_dim", "--depths", "--num_heads",
               "--window_size", "--mlp_ratio", "--n_sequence")


def width_args(extra):
    """The WIDTH_FLAGS of an argument list, each with its values."""
    out, keep = [], False
    for tok in extra:
        if tok.startswith("--"):
            keep = tok.split("=")[0] in WIDTH_FLAGS
        if keep:
            out.append(tok)
    return out


def run_stage(name: str, cmd) -> float:
    """Run one stage from the repository's root; its seconds, or exit with
    its code when it fails (train.sh:7-10, 18-21)."""
    print(f"\n=== pipeline stage: {name} ===\n  {' '.join(cmd)}", flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.time()
    rc = subprocess.call(cmd, env=env, cwd=REPO)
    seconds = time.time() - t0
    if rc != 0:
        print(f"{name} encountered an error (exit {rc}).", flush=True)
        sys.exit(rc)
    print(f"=== pipeline stage {name}: exit 0 in {seconds:.1f} s ===", flush=True)
    return seconds


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="SPEINet pipeline on PyTorch")
    p.add_argument("--work", default=os.path.join(tempfile.gettempdir(),
                                                  "speinet_pipeline"))
    p.add_argument("--data", default="",
                   help="existing GoProRS tree (blur/gt/label); when unset "
                        "a synthetic tree is generated under --work")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--patch_size", type=int, default=200)
    p.add_argument("--ratio", type=float, default=0.5)
    p.add_argument("--n_videos", type=int, default=2)
    p.add_argument("--n_frames", type=int, default=30)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, for every stage")
    p.add_argument("--dp_devices", type=int, default=0,
                   help="training processes, one per card; 0 = every visible card")
    p.add_argument("--skip", default="",
                   help="comma-separated stages to skip: gen,detector,train,infer")
    p.add_argument("--extra_train", nargs=argparse.REMAINDER, default=[],
                   help="extra args forwarded to main_train (width flags to "
                        "infer too)")
    a = p.parse_args(argv)
    skip = {s for s in a.skip.split(",") if s}
    py = sys.executable
    cpu = a.device == "cpu"
    if not cpu:
        import torch

        from speinet_tpu_torch.utils.device import resolve_device

        resolve_device(a.device)
        n_proc = a.dp_devices or torch.cuda.device_count()
    seconds = {}

    tree = a.data or os.path.join(a.work, "rs")
    if not a.data and "gen" not in skip:
        # sharp videos -> windowed-mean blur + per-frame labels
        sharp = os.path.join(a.work, "sharp")
        code = ("from speinet_tpu_torch.data.gopro_rs import generate_dataset, "
                "make_sharp_videos\n"
                f"make_sharp_videos({sharp!r}, n_videos={a.n_videos}, "
                f"n_frames={a.n_frames}, style='natural')\n"
                f"generate_dataset({sharp!r}, {tree!r}, ratios=({a.ratio},), "
                "mixed=False, seed=3)\n")
        seconds["generate"] = run_stage("generate", [py, "-c", code])

    det_dir = os.path.join(a.work, "detector")
    if "detector" not in skip:
        # train.sh:4, choice_dataset_train.py
        seconds["detector"] = run_stage("detector", [
            py, "-m", "speinet_tpu_torch.detector.train", "--dir-path", tree,
            "--pregenerated", "--out-dir", det_dir,
            "--csv", os.path.join(det_dir, "output.csv"), "--device", a.device])

    exp = os.path.join(a.work, "experiment")
    if "train" not in skip:
        # train.sh:15, main_SPEINet.py --template SPEINet
        train = ["-m", "speinet_tpu_torch.main_train", "--template", "SPEINet",
                 "--dir_data", tree, "--dir_data_test", tree,
                 "--experiment_dir", exp + "/", "--save", "run",
                 "--epochs", str(a.epochs), "--batch_size", str(a.batch_size),
                 "--patch_size", str(a.patch_size), "--process", "true",
                 "--save_images", "false", "--device", a.device]
        if cpu:
            cmd = [py] + train
        else:
            cmd = [py, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node", str(n_proc)] + train + ["--dp_devices",
                                                               str(n_proc)]
        seconds["train"] = run_stage("train", cmd + a.extra_train)

    if "infer" not in skip:
        lr_pkls = sorted(f for f in (os.listdir(det_dir) if os.path.isdir(det_dir)
                                     else [])
                         if f.startswith("LogisticRegression") and f.endswith(".pkl"))
        det = ["--detector_pickle", os.path.join(det_dir, lr_pkls[0])] if lr_pkls else []
        seconds["infer"] = run_stage("infer", [
            py, "-m", "speinet_tpu_torch.infer", "--data_path", tree,
            "--model_path", os.path.join(exp, "run", "model", "model_best"),
            "--result_path", os.path.join(a.work, "results"),
            "--save_image", "false", "--device", a.device]
            + det + width_args(a.extra_train))

    print("\npipeline complete:", a.work, flush=True)
    print("pipeline stage seconds: "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()), flush=True)


if __name__ == "__main__":
    main()
