"""The command lines' new flags on the CPU.

- `python -m speinet_tpu_torch.infer --profile DIR`: the run restores every
  frame as without the flag and leaves one torch.profiler trace in DIR,
  which holds the model's operators (on the card also its kernels:
  chip_smoke.py's profile phase) and the engine's spans, which the program
  no longer keeps once the session has ended.
- `python -m speinet_tpu_torch.main_train` with --n_sequence 5 and a loss
  spec with VGG and GAN terms.
"""

import json

import numpy as np
import torch

from speinet_tpu_torch.infer import main
from speinet_tpu_torch.utils.spans import recorded
from test_torch_engine import _tree
from test_torch_train import _one_torch_thread  # noqa: F401


def test_profile_writes_a_trace(tmp_path):
    labels = np.zeros(4, np.int64)
    labels[0] = 1
    root = _tree(tmp_path / "ds", 4, labels, h=40, w=40)
    trace_dir = tmp_path / "trace"
    main(["--data_path", str(root), "--result_path", str(tmp_path / "res"),
          "--device", "cpu", "--batch_windows", "2", "--cache_pyramids",
          "--save_image", "false", "--n_feat", "8", "--embed_dim", "32",
          "--depths", "2", "--num_heads", "4", "--profile", str(trace_dir)])
    traces = list(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name", "") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert "aten::conv2d" in names and "aten::bmm" in names
    assert {"engine.restore", "engine.score", "restore.fusion"} <= names
    assert recorded() == []
    log = next((tmp_path / "res").glob("inference_log_*.txt")).read_text()
    assert log.count("> video00-") == 4


def test_main_train_with_plugins_and_five_frame_windows(tmp_path):
    """The CLI on the CPU with --n_sequence 5 and a VGG + GAN spec: one epoch
    logs the DIS column and checkpoints the discriminator; a resume restores
    it and trains on from there."""
    from speinet_tpu_torch.main_train import main
    from test_end_to_end import TINY_ARGS, make_tree

    root = make_tree(tmp_path / "ds")
    exp = tmp_path / "exp"
    argv = ["--device", "cpu", "--template", "SPEINet", "--dir_data", str(root),
            "--dir_data_test", str(root), "--experiment_dir", str(exp) + "/",
            "--save", "run1", "--n_sequence", "5",
            "--loss", "1*L1+0.1*VGG22+0.01*GAN"] + TINY_ARGS
    main(argv + ["--epochs", "1"])
    d = exp / "run1"
    names = (d / "loss_components_names.txt").read_text().split()
    assert names == ["L1", "VGG22", "GAN", "DIS", "Total"]
    comp = np.load(d / "loss_components.npy")
    assert comp.shape == (1, 5) and np.isfinite(comp).all() and comp[0, 3] > 0
    ckpt = torch.load(d / "model" / "model_latest", weights_only=True)
    assert ckpt["model"]["fusion.weight"].shape[1] == 4 * 8 * 5
    dis = ckpt["gan"]["dis"]
    assert ckpt["gan"]["opt"]["state"]
    main(argv + ["--load", "run1", "--resume", "true", "--epochs", "2"])
    assert "Restored checkpoint" in (d / "log.txt").read_text()
    after = torch.load(d / "model" / "model_latest", weights_only=True)["gan"]["dis"]
    assert not torch.equal(after["convs.0.weight"], dis["convs.0.weight"])
