"""The port's inference engines against speinet_tpu.infer.Inference on
synthetic PNG trees, on the CPU.

Same weights on both sides (a seeded port init carried to the flax tree,
BatchNorm statistics perturbed with numpy). The 14-frame video with sharp
labels at frames 0 and 13 gives, at 2 windows per chunk, all-sharp chunks,
all-self chunks (has_sharp=False: the pre-sharp frame is >7 frames away)
and one mixed chunk. Per-frame PSNR must agree within 0.01 dB and SSIM
within 1e-4, for the cached engine, the direct engine, --self_ensemble and
--chop; a tree without label/ is labelled by the detector on both sides.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from speinet_tpu.config import Config as JConfig
from speinet_tpu.config import set_template as j_set_template
from speinet_tpu.infer import Inference as JInference
from speinet_tpu.models.speinet import SPEINet as JSPEINet
from speinet_tpu.utils.convert import convert_state_dict
from speinet_tpu_torch.config import Config, set_template
from speinet_tpu_torch.infer import Inference, main
from speinet_tpu_torch.models.speinet import SPEINet, init_weights
from speinet_tpu_torch.utils.convert import from_flax_params

SMALL = dict(n_feat=8, embed_dim=32, depths=[2], num_heads=[4], n_threads=2)


def _tree(root, n, labels=None, h=48, w=64):
    import imageio.v2 as imageio

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    os.makedirs(root / "blur" / "video00")
    os.makedirs(root / "gt" / "video00")
    for i in range(n):
        img = (127 + 90 * np.sin(xx / 5.0 + i) * np.cos(yy / 4.0)
               + 8 * rng.standard_normal((h, w)))
        img = np.stack([img] * 3, -1).clip(0, 255).astype(np.uint8)
        gt = np.clip(img.astype(np.int32) + 3, 0, 255).astype(np.uint8)
        imageio.imwrite(root / "blur" / "video00" / f"{i:08d}.png", img)
        imageio.imwrite(root / "gt" / "video00" / f"{i:08d}.png", gt)
    if labels is not None:
        os.makedirs(root / "label")
        np.save(root / "label" / "video00.npy", labels)
    return root


def _shared_weights():
    jm = JSPEINet(n_feat=8, embed_dim=32, depths=(2,), num_heads=(4,),
                  drop_path_rate=0.0)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 5, 3, 48, 64))))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    port = init_weights(SPEINet(n_feat=8, embed_dim=32, depths=(2,),
                                num_heads=(4,)), seed=5)
    params, bstats = convert_state_dict(port.state_dict(), template, depths=(2,))
    rng = np.random.default_rng(9)
    bstats = jax.tree_util.tree_map_with_path(
        lambda p, a: ((0.1 * rng.standard_normal(a.shape)) if "mean" in
                      jax.tree_util.keystr(p) else 0.5 + rng.random(a.shape)
                      ).astype(a.dtype), bstats)
    return params, bstats


def _both_engines(tmp_path, monkeypatch, root, chop=False, **kw):
    """(JAX engine, port engine) on the same tree and weights; neither has
    run yet."""
    params, bstats = _shared_weights()
    monkeypatch.setattr(JInference, "_load_weights",
                        lambda self, path: (params, bstats))
    cfg_j = j_set_template(JConfig(template="SPEINet")).replace(
        dp_devices=1, chop=chop, chop_shave=8, **SMALL)
    inf_j = JInference(cfg_j, str(root), model_path="",
                       result_path=str(tmp_path / "res_jax"), save_image=False,
                       batch_windows=2, **kw)
    pt = tmp_path / "port.pt"
    torch.save(from_flax_params(params, bstats, depths=(2,)), pt)
    cfg = set_template(Config(template="SPEINet")).replace(chop=chop, chop_shave=8,
                                                           **SMALL)
    inf = Inference(cfg, str(root), model_path=str(pt),
                    result_path=str(tmp_path / "res_port"), save_image=False,
                    batch_windows=2, device="cpu", **kw)
    return inf_j, inf


def _assert_same_metrics(inf, inf_j, n):
    assert len(inf.total_psnr["video00"]) == n
    np.testing.assert_allclose(inf.total_psnr["video00"], inf_j.total_psnr["video00"],
                               rtol=0, atol=0.01)
    np.testing.assert_allclose(inf.total_ssim["video00"], inf_j.total_ssim["video00"],
                               rtol=0, atol=1e-4)


def _mixed_labels():
    labels = np.zeros(14, np.int64)
    labels[[0, 13]] = 1
    return labels


def test_cached_engine_matches_jax_engine(tmp_path, monkeypatch):
    root = _tree(tmp_path / "ds", 14, _mixed_labels())
    inf_j, inf = _both_engines(tmp_path, monkeypatch, root, cache_pyramids=True)
    inf_j.infer()
    calls = []
    orig = inf.model.restore_from_features

    def spy(*args):
        calls.append((args[5], args[0].shape[0]))
        return orig(*args)

    inf.model.restore_from_features = spy
    inf.infer()
    inf.close()

    # sharp chunks, self chunks, and the mixed chunk as one 'mixed' call
    assert ("sharp", 2) in calls and ("self", 2) in calls
    assert ("mixed", 2) in calls
    assert all(r != "mixed" for r, _ in calls[:3] + calls[4:]), calls
    _assert_same_metrics(inf, inf_j, 14)


@pytest.mark.parametrize("mode", ["direct", "self_ensemble", "chop"])
def test_direct_engine_matches_jax_engine(tmp_path, monkeypatch, mode):
    """The direct engine (SPEINet.forward with per-sample routing), with
    --self_ensemble or --chop (shave 8: four 32x40 tiles of each 48x64
    frame, one batched forward). 10 frames keep the 8x ensemble short; the
    sharp labels at 0 and 9 still give sharp, self and mixed chunks."""
    n = 14 if mode == "direct" else 10
    labels = np.zeros(n, np.int64)
    labels[[0, n - 1]] = 1
    root = _tree(tmp_path / "ds", n, labels)
    inf_j, inf = _both_engines(tmp_path, monkeypatch, root, chop=mode == "chop",
                               self_ensemble=mode == "self_ensemble")
    inf_j.infer()
    inf.infer()
    inf.close()
    _assert_same_metrics(inf, inf_j, n)


def test_cli_runs_cached_engine_and_writes_the_log(tmp_path, capsys):
    labels = np.zeros(4, np.int64)
    labels[0] = 1
    root = _tree(tmp_path / "ds", 4, labels, h=40, w=40)
    res = tmp_path / "res"
    args = ["--data_path", str(root), "--result_path", str(res), "--device", "cpu",
            "--batch_windows", "2", "--n_feat", "8", "--embed_dim", "32",
            "--depths", "2", "--num_heads", "4"]
    main(args + ["--cache_pyramids"])
    logs = list(res.glob("inference_log_*.txt"))
    assert len(logs) == 1
    text = logs[0].read_text()
    assert text.count("> video00-") == 4
    assert "# Total AVG-PSNR=" in text
    assert len(list((res / "video00").glob("*.png"))) == 4
    # the direct engine, alone and with each option, writes a log of its own
    for extra in ([], ["--self_ensemble"], ["--chop", "--chop_shave", "8"]):
        main(args + extra)
    logs = list(res.glob("inference_log_*.txt"))
    assert sum(p.read_text().count("> video00-") for p in logs) == 16
    with pytest.raises(ValueError, match="direct engine"):
        main(args + ["--cache_pyramids", "--chop"])


def test_missing_labels_name_the_detector(tmp_path, monkeypatch):
    """A tree without label/ is labelled by the packaged detector, as the
    JAX engine labels it (speinet_tpu/infer.py:219-226)."""
    root = _tree(tmp_path / "ds", 6, labels=None, h=40, w=40)
    inf_j, inf = _both_engines(tmp_path, monkeypatch, root)
    got = {}
    orig = inf.infer_video

    def spy(v, input_frames, gt_frames, labels, *args):
        got["labels"] = labels
        return orig(v, input_frames, gt_frames, labels, *args)

    inf.infer_video = spy
    inf.infer()
    inf.close()
    frames = [str(root / "blur" / "video00" / f"{i:08d}.png") for i in range(6)]
    want = inf_j._labels_for_video("video00", frames)
    np.testing.assert_array_equal(got["labels"], want)
