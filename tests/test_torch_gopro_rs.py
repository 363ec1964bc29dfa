"""The port's GoProRS generator against speinet_tpu's, on the CPU: for one
seed the same labels, blurry frames and ground truths (within 1e-5), the
same blur/ gt/ label/ tree and manifest, and the same video split."""

import json
import os

import imageio.v2 as imageio
import numpy as np
import pytest

import speinet_tpu.data.gopro_rs as jrs
from speinet_tpu_torch.data import gopro_rs as rs


def _sharp_videos(root, n_videos=3, n_frames=23, h=8, w=10):
    rng = np.random.default_rng(4)
    for v in range(n_videos):
        os.makedirs(root / f"clip{v}")
        for i in range(n_frames - 3 * v):
            imageio.imwrite(root / f"clip{v}" / f"{i:05d}.png",
                            rng.integers(0, 256, (h, w, 3), np.uint8))
    return root


@pytest.mark.parametrize("ratio", [0.1, 0.5, 0.9])
def test_blurry_sequence_matches_jax(ratio):
    frames = list(np.random.default_rng(1).integers(0, 256, (40, 6, 7, 3)).astype(
        np.uint8))
    want = jrs.generate_blurry_sequence(frames, ratio, np.random.default_rng(7))
    got = rs.generate_blurry_sequence(frames, ratio, np.random.default_rng(7))
    np.testing.assert_array_equal(got[2], want[2])
    assert got[2].dtype == np.int64 and got[0].dtype == got[1].dtype == np.float32
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_same_tree(got_root, want_root):
    files = _tree_files(want_root)
    assert files == _tree_files(got_root) and files
    for rel in files:
        a, b = os.path.join(got_root, rel), os.path.join(want_root, rel)
        if rel.endswith(".png"):
            np.testing.assert_array_equal(imageio.imread(a), imageio.imread(b))
        elif rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))


def test_dataset_tree_and_split_match_jax(tmp_path):
    src = _sharp_videos(tmp_path / "sharp")
    want = jrs.generate_dataset(str(src), str(tmp_path / "jax"), seed=3)
    got = rs.generate_dataset(str(src), str(tmp_path / "port"), seed=3)
    assert got == want == ["clip0", "clip1", "clip2"]
    assert sorted(os.listdir(tmp_path / "port")) == ["blur", "gt", "label"]
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    for pkg, name in ((jrs, "jax"), (rs, "port")):
        pkg.split_dataset(str(tmp_path / name), str(tmp_path / f"{name}_train"),
                          str(tmp_path / f"{name}_val"), val_fraction=0.34, seed=1)
    for part in ("train", "val"):
        _assert_same_tree(tmp_path / f"port_{part}", tmp_path / f"jax_{part}")


def test_splits_and_manifest_match_jax(tmp_path):
    srcs = {"train": str(_sharp_videos(tmp_path / "a", 2)),
            "val": str(_sharp_videos(tmp_path / "b", 1))}
    want = jrs.generate_splits(srcs, str(tmp_path / "jax"), seed=5)
    got = rs.generate_splits(srcs, str(tmp_path / "port"), seed=5)
    assert got == want
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    manifests = [json.loads((tmp_path / name / "dataset_manifest.json").read_text())
                 for name in ("jax", "port")]
    rel = lambda m, name: json.loads(json.dumps(m).replace(str(tmp_path / name), ""))
    assert rel(manifests[1], "port") == rel(manifests[0], "jax")
