"""The port's pipeline (`python -m speinet_tpu_torch.pipeline`) on the CPU,
its copy of the sharp-video generator, and `--model_path` taking a trainer
checkpoint."""

import glob
import os

import numpy as np
import pytest
import torch

from speinet_tpu_torch.config import Config, set_template
from test_torch_train import _one_torch_thread  # noqa: F401

WIDTHS = ["--n_feat", "8", "--embed_dim", "32", "--depths", "2", "--num_heads", "4"]


def test_make_sharp_videos_matches_the_scripts_copy(tmp_path):
    """The port's make_sharp_videos writes the frames that
    scripts/quality_evidence.py's writes from the same arguments."""
    import importlib.util

    import imageio.v2 as imageio
    from speinet_tpu_torch.data.gopro_rs import make_sharp_videos

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "quality_evidence.py")
    spec = importlib.util.spec_from_file_location("quality_evidence", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    j_make = mod.make_sharp_videos

    kw = dict(n_videos=2, n_frames=3, h=24, w=32, seed=5)
    for style in ("natural", "lowpass"):
        j_make(str(tmp_path / f"j_{style}"), style=style, **kw)
        make_sharp_videos(str(tmp_path / f"p_{style}"), style=style, **kw)
        want = sorted(glob.glob(str(tmp_path / f"j_{style}" / "*" / "*.png")))
        got = sorted(glob.glob(str(tmp_path / f"p_{style}" / "*" / "*.png")))
        assert len(want) == len(got) == 6
        for a, b in zip(want, got):
            assert os.path.relpath(a, tmp_path / f"j_{style}") == \
                os.path.relpath(b, tmp_path / f"p_{style}")
            np.testing.assert_array_equal(imageio.imread(a), imageio.imread(b))


def test_width_args_reach_inference():
    from speinet_tpu_torch.pipeline import width_args

    extra = ["--n_feat", "8", "--lr", "1e-3", "--depths", "2", "2", "--num_heads=4",
             "--print_every", "1"]
    assert width_args(extra) == ["--n_feat", "8", "--depths", "2", "2",
                                 "--num_heads=4"]


def test_model_path_takes_a_trainer_checkpoint(tmp_path):
    """infer.py's --model_path loads the `model` entry of a trainer
    checkpoint, and still a bare state_dict."""
    from speinet_tpu_torch.infer import Inference
    from speinet_tpu_torch.models.speinet import SPEINet, init_weights
    from speinet_tpu_torch.training.train_state import make_optimizer
    from speinet_tpu_torch.utils.checkpoint import CheckpointManager

    cfg = set_template(Config(template="SPEINet")).replace(
        n_feat=8, embed_dim=32, depths=[2], num_heads=[4])
    model = init_weights(SPEINet.from_config(cfg), seed=6)
    CheckpointManager(str(tmp_path / "model")).save(
        model, make_optimizer(cfg, model), 3, 1, is_best=True)
    bare = tmp_path / "bare.pt"
    torch.save(model.state_dict(), bare)
    want = model.state_dict()
    for path in (tmp_path / "model" / "model_best", bare):
        inf = Inference(cfg, str(tmp_path), str(path), str(tmp_path / "r"),
                        device="cpu")
        got = inf.model.state_dict()
        inf.close()
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_pipeline_end_to_end_on_the_cpu(tmp_path, capsys, monkeypatch):
    """generate -> detector -> train (one plain process) -> infer on a
    synthetic GoProRS tree at tiny widths: each stage exits 0 and the
    inference stage restores the trained model_best at those widths. The
    stages run torch on one thread each (OMP_NUM_THREADS, which they
    inherit), as the test processes do: on cores other test workers share,
    torch's default pool made this test ten times slower."""
    from speinet_tpu_torch.pipeline import main

    monkeypatch.setenv("OMP_NUM_THREADS", "1")

    work = tmp_path / "work"
    main(["--device", "cpu", "--work", str(work), "--n_videos", "1",
          "--n_frames", "12", "--batch_size", "2", "--patch_size", "40",
          "--extra_train"] + WIDTHS + ["--n_threads", "2", "--print_every", "2",
                                       "--n_frames_per_video", "12"])
    out = capsys.readouterr().out
    for stage in ("generate", "detector", "train", "infer"):
        assert f"=== pipeline stage {stage}: exit 0 in" in out, stage
    assert "pipeline complete" in out
    best = work / "experiment" / "run" / "model" / "model_best"
    assert best.exists()
    assert glob.glob(str(work / "detector" / "LogisticRegression*.pkl"))
    logs = glob.glob(str(work / "results" / "inference_log_*.txt"))
    assert len(logs) == 1
    log = open(logs[0]).read()
    assert f"Loading model from {best}" in log
    assert "# Total AVG-PSNR=" in log


def test_pipeline_stops_at_a_failing_stage(tmp_path, capsys):
    """A stage that fails ends the chain with its exit code (train.sh)."""
    from speinet_tpu_torch.pipeline import main

    with pytest.raises(SystemExit) as e:
        main(["--device", "cpu", "--work", str(tmp_path), "--data",
              str(tmp_path / "missing"), "--skip", "detector,train"])
    assert e.value.code != 0
    assert "infer encountered an error" in capsys.readouterr().out
