"""The port's detector training (speinet_tpu_torch.detector.classifier and
.train) against speinet_tpu's, on the CPU.

The fits are host numpy in both packages: on tests/test_detector.py's
seeded data the logistic coefficients agree within 1e-6 relative and the
trees and forests are the same, node for node. Pickles cross between the
packages: the JAX package's trees and forests load through the port's own
unpickler, which refuses any other class, and the port's logistic pickle
loads in the JAX package. The collation, fitting and evaluation functions
run on a tiny generated tree with device="cpu": the port's features agree
with the JAX package's at rtol 1e-4 (tests/test_torch_detector.py), and
the fits, CSV rows and evaluations on them are the JAX functions'.
"""

import csv
import os
import pickle

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

import speinet_tpu.detector.classifier as jcls
import speinet_tpu.detector.train as jtrain
import speinet_tpu_torch.detector.classifier as cls
import speinet_tpu_torch.detector.train as train
from speinet_tpu.data.gopro_rs import generate_dataset


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _logistic_data(rng):
    """tests/test_detector.py::test_logistic_regression_fit's data."""
    n = 400
    x = rng.standard_normal((n, 6)) * np.array([1e3, 10, 1e6, 1, 1e-3, 100.0])
    w_true = np.array([1e-3, 0.5, 1e-6, 2.0, 50.0, 0.0])
    y = ((x @ w_true + 0.3 * rng.standard_normal(n)) > 0).astype(int)
    return x, y


def _forest_data(rng):
    """tests/test_detector.py::test_random_forest's data: noisy labels and a
    held-out set."""
    n = 400
    x = rng.standard_normal((n, 6))
    clean = ((x[:, 0] > 0.2) & (x[:, 2] < 0.5)).astype(int)
    y = np.where(rng.random(n) < 0.1, 1 - clean, clean)
    return x, y, rng.standard_normal((500, 6))


def _nodes(node):
    """A tree's nodes in preorder as (feature, threshold, value)."""
    if node is None:
        return []
    return [(int(node.feature), float(node.threshold), int(node.value))] + \
        _nodes(node.left) + _nodes(node.right)


def test_logistic_fit_matches_jax(rng):
    x, y = _logistic_data(rng)
    want = jcls.fit_logistic_regression(x, y)
    got = cls.fit_logistic_regression(x, y)
    for a, b in ((got.coef, want.coef), (got.mean, want.mean), (got.scale, want.scale)):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    np.testing.assert_allclose(got.intercept, want.intercept, rtol=1e-6)
    np.testing.assert_array_equal(got.predict(x), np.asarray(want.predict(x)))
    np.testing.assert_allclose(got.predict_proba(x), np.asarray(want.predict_proba(x)),
                               rtol=1e-6, atol=1e-7)
    assert cls.binary_metrics(y, got.predict(x)) == jcls.binary_metrics(
        y, np.asarray(want.predict(x)))


@pytest.mark.parametrize("kind", ["tree", "forest"])
def test_tree_fits_match_jax(rng, kind):
    """The same nodes (features, thresholds, leaf values) and predictions;
    the forest (10 trees) draws its bootstraps and feature subsets from the
    same generator in the same order."""
    x, y, x2 = _forest_data(rng)
    if kind == "tree":
        want, got = jcls.DecisionTree().fit(x, y), cls.DecisionTree().fit(x, y)
        pairs = [(got.root, want.root)]
    else:
        want = jcls.RandomForest(n_estimators=10, seed=1).fit(x, y)
        got = cls.RandomForest(n_estimators=10, seed=1).fit(x, y)
        pairs = [(g.root, w.root) for g, w in zip(got.trees, want.trees)]
        assert len(pairs) == 10
        np.testing.assert_array_equal(got.predict_proba(x2), want.predict_proba(x2))
    for g, w in pairs:
        assert _nodes(g) == _nodes(w) and len(_nodes(g)) > 3
    np.testing.assert_array_equal(got.predict(x2), want.predict(x2))


def test_pickles_cross_packages(rng, tmp_path):
    """The JAX package's pickled tree and forest load in the port (no JAX
    package import needed) and predict alike; the port's logistic pickle
    loads in the JAX package and the JAX one in the port; a pickle naming
    any other class is refused."""
    x, y, x2 = _forest_data(rng)
    for jmodel, port_cls in ((jcls.DecisionTree().fit(x, y), cls.DecisionTree),
                             (jcls.RandomForest(n_estimators=10, seed=2).fit(x, y),
                              cls.RandomForest)):
        path = str(tmp_path / f"{port_cls.__name__}.pkl")
        jmodel.save(path)
        loaded = port_cls.load(path)
        assert type(loaded) is port_cls
        np.testing.assert_array_equal(loaded.predict(x2), jmodel.predict(x2))
        loaded.save(path)                        # and the port's own pickle
        np.testing.assert_array_equal(port_cls.load(path).predict(x2), jmodel.predict(x2))
    with pytest.raises(TypeError, match="not a RandomForest"):
        cls.RandomForest.load(str(tmp_path / "DecisionTree.pkl"))

    xl, yl = _logistic_data(rng)
    mine = cls.fit_logistic_regression(xl, yl)
    mine.save(str(tmp_path / "lr.pkl"))
    theirs = jcls.LogisticRegressionJAX.load(str(tmp_path / "lr.pkl"))
    np.testing.assert_array_equal(np.asarray(theirs.predict(xl)), mine.predict(xl))
    jcls.fit_logistic_regression(xl, yl).save(str(tmp_path / "jlr.pkl"))
    back = cls.LogisticRegression.load(str(tmp_path / "jlr.pkl"))
    np.testing.assert_array_equal(back.coef, mine.coef)

    evil = tmp_path / "evil.pkl"
    evil.write_bytes(pickle.dumps(os.getcwd))
    with pytest.raises(pickle.UnpicklingError, match="may not name"):
        cls.DecisionTree.load(str(evil))


@pytest.fixture(scope="module")
def sharp_tree(tmp_path_factory):
    """Two sharp videos of 48 32x32 frames, and the GoProRS tree the JAX
    package generates from them (ratio 0.4)."""
    root = tmp_path_factory.mktemp("detector")
    src = root / "sharp"
    yy, xx = np.mgrid[0:32, 0:32]
    for v in range(2):
        os.makedirs(src / f"v{v}")
        for i in range(48):
            img = 127 + 120 * np.sin(xx / 2.5 + i * 0.7 + v) * np.cos(yy / 3.0)
            img = np.stack([img] * 3, -1).clip(0, 255).astype(np.uint8)
            imageio.imwrite(str(src / f"v{v}" / f"{i:04d}.png"), img)
    generate_dataset(str(src), str(root / "rs"), ratios=(0.4,), mixed=False, seed=3)
    return root


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_collate_fit_evaluate_match_jax(sharp_tree, tmp_path):
    """collate_pregenerated and collate_synthetic give the JAX features
    (rtol 1e-4) and labels (equal); train_detectors on them writes the
    same pickles' predictions and CSV rows; evaluate_videos gives the same
    per-video accuracies."""
    rs, src = str(sharp_tree / "rs"), str(sharp_tree / "sharp")
    for got, want in ((train.collate_pregenerated(rs, 7, device="cpu"),
                       jtrain.collate_pregenerated(rs, 7)),
                      (train.collate_synthetic(src, 0.4, 7, seed=5, device="cpu"),
                       jtrain.collate_synthetic(src, 0.4, 7, seed=5))):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
        np.testing.assert_array_equal(got[1], want[1])
        assert 0 < got[1].mean() < 1
    x, y = want
    res = {}
    for name, mod in (("port", train), ("jax", jtrain)):
        res[name] = mod.train_detectors(x, y, str(tmp_path / name), ratio=0.4,
                                        kernel_size=7, n_forest_trees=10,
                                        csv_path=str(tmp_path / f"{name}.csv"))
    assert res["port"] == res["jax"]
    assert _rows(tmp_path / "port.csv") == _rows(tmp_path / "jax.csv")
    assert _rows(tmp_path / "port.csv")[0] == ["model", "ratio", "kernel_size", "accuracy",
                                               "recall", "precision", "f1"]
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "DecisionTree_0.4_7.pkl", "LogisticRegression_0.4_7.pkl", "RandomForest_0.4_7.pkl"]
    forest = cls.RandomForest.load(str(tmp_path / "port" / "RandomForest_0.4_7.pkl"))
    jforest = jcls.RandomForest.load(str(tmp_path / "jax" / "RandomForest_0.4_7.pkl"))
    np.testing.assert_array_equal(forest.predict(x), jforest.predict(x))

    lr = cls.LogisticRegression.load(str(tmp_path / "port" / "LogisticRegression_0.4_7.pkl"))
    got = train.evaluate_videos(rs, lr, 7, device="cpu")
    want = jtrain.evaluate_videos(rs, jcls.LogisticRegressionJAX.load(
        str(tmp_path / "jax" / "LogisticRegression_0.4_7.pkl")), 7)
    assert set(got) == set(want) == {"v0", "v1", "__total__"}
    for v in want:
        assert got[v]["accuracy"] == want[v]["accuracy"]
        assert got[v]["n_frames"] == want[v]["n_frames"]


def test_cli_and_grid(sharp_tree, tmp_path, monkeypatch, capsys):
    """The CLI once on the sharp videos (--device cpu): the pickles and the
    CSV rows of the JAX CLI on the same arguments. --grid's (ratio, kernel)
    list, recorded with the collation and fits stubbed in both packages,
    is the JAX one: 8 ratios x 7 kernel sizes."""
    src = str(sharp_tree / "sharp")
    for name, mod, extra in (("port", train, ["--device", "cpu"]), ("jax", jtrain, [])):
        mod.main(["--dir-path", src, "--kernel-size", "5", "--ratio", "0.5",
                  "--out-dir", str(tmp_path / name), "--csv",
                  str(tmp_path / f"{name}.csv")] + extra)
    out = capsys.readouterr().out
    assert out.count("[ratio=0.5 k=5] RandomForest: acc=") == 2
    assert _rows(tmp_path / "port.csv") == _rows(tmp_path / "jax.csv")
    assert len(_rows(tmp_path / "port.csv")) == 4

    combos = {}
    for name, mod in (("port", train), ("jax", jtrain)):
        seen = combos.setdefault(name, [])
        monkeypatch.setattr(mod, "collate_synthetic",
                            lambda d, r, k, *a, _s=seen, **kw: _s.append((r, k)) or (0, 0))
        monkeypatch.setattr(mod, "train_detectors", lambda *a, **kw: {})
    train.main(["--dir-path", src, "--grid", "--device", "cpu"])
    jtrain.main(["--dir-path", src, "--grid"])
    assert combos["port"] == combos["jax"] and len(combos["port"]) == 56

