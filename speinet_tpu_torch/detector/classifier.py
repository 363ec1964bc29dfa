"""Sharp / blurry classifiers on the six focus features (port of
`speinet_tpu/detector/classifier.py`; parity: the reference's sklearn
models, LD_detector/sharp_detector_params_estimation_parallel.py:239-250):

- `LogisticRegression` (the JAX package's `LogisticRegressionJAX`), fitted
  by `fit_logistic_regression` (IRLS, L2 with C = 1, the intercept not
  regularised, features standardised internally);
- `DecisionTree`, a numpy CART (gini, midpoint thresholds), and
  `RandomForest`, bagged trees with sqrt feature subsampling;
- `binary_metrics`: accuracy, recall, precision and F1.

All host numpy: the same `default_rng` draws in the same order give
bit-identical fits in both packages. The logistic model pickles as a dict
of arrays, which both packages read. Trees and forests pickle as objects;
`DecisionTree.load` and `RandomForest.load` read the port's pickles and the
JAX package's (whose classes live in `speinet_tpu.detector.classifier`)
through an unpickler that maps those classes to the port's and refuses
every other class but numpy's array and scalar types.

The packaged default is `default_logreg.npz` beside this file: the
coefficients of the JAX package's `default_logreg.pkl`, kept as plain
arrays so that no pickle of another numpy major version is needed.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Optional

import numpy as np


def default_detector_path() -> str:
    """The packaged default logistic detector."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "default_logreg.npz")


@dataclass
class LogisticRegression:
    coef: np.ndarray                     # [F]
    intercept: float
    mean: Optional[np.ndarray] = None    # optional feature standardization
    scale: Optional[np.ndarray] = None

    def decision_function(self, x) -> np.ndarray:
        """Margins [N] of features x [N, F], in float32."""
        x = np.asarray(x, np.float32)
        if self.mean is not None:
            x = (x - np.asarray(self.mean, np.float32)) / np.asarray(self.scale,
                                                                     np.float32)
        return x @ np.asarray(self.coef, np.float32) + np.float32(self.intercept)

    def predict(self, x) -> np.ndarray:
        """1 = sharp, 0 = blurry, int32 [N]."""
        return (self.decision_function(x) > 0).astype(np.int32)

    def predict_proba(self, x) -> np.ndarray:
        """[N, 2] float32: P(blurry), P(sharp)."""
        p = 1.0 / (1.0 + np.exp(-self.decision_function(x)))
        return np.stack([1 - p, p], axis=-1)

    def save(self, path: str) -> None:
        """A pickled dict of coef / intercept / mean / scale, the JAX
        package's format."""
        opt = lambda a: None if a is None else np.asarray(a)
        with open(path, "wb") as f:
            pickle.dump({"coef": np.asarray(self.coef), "intercept": float(self.intercept),
                         "mean": opt(self.mean), "scale": opt(self.scale)}, f)

    @staticmethod
    def load(path: Optional[str] = None) -> "LogisticRegression":
        """A detector from `path`: an .npz of coef / intercept / mean /
        scale, a pickled dict of the same keys (the JAX package's format),
        or a pickled sklearn LogisticRegression. No path: the packaged
        default."""
        path = path or default_detector_path()
        if path.endswith(".npz"):
            with np.load(path) as z:
                opt = lambda k: z[k] if k in z.files else None
                return LogisticRegression(z["coef"], float(z["intercept"]),
                                          opt("mean"), opt("scale"))
        with open(path, "rb") as f:
            d = pickle.load(f)
        if isinstance(d, dict):
            return LogisticRegression(d["coef"], d["intercept"], d.get("mean"),
                                      d.get("scale"))
        return load_sklearn_pickle_obj(d)


def load_sklearn_pickle_obj(obj) -> LogisticRegression:
    """Adapt a fitted sklearn LogisticRegression (e.g. the reference's
    shipped LD_detector/pickle/*.pkl)."""
    return LogisticRegression(coef=np.asarray(obj.coef_).reshape(-1),
                              intercept=float(np.asarray(obj.intercept_).reshape(-1)[0]))


def fit_logistic_regression(x: np.ndarray, y: np.ndarray, c: float = 1.0,
                            max_iter: int = 100, tol: float = 1e-8,
                            standardize: bool = True) -> LogisticRegression:
    """IRLS fit of min_w sum log(1 + exp(-y w.x)) + ||w||^2 / (2c), in
    float64. The focus features span ~10 orders of magnitude, so they are
    standardised internally by default (kept as the model's mean / scale,
    so a prediction stays one dot product)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64).reshape(-1)
    if standardize:
        mean = x.mean(axis=0)
        scale = x.std(axis=0)
        scale[scale == 0] = 1.0
        xs = (x - mean) / scale
    else:
        mean = scale = None
        xs = x
    n, f = xs.shape
    xb = np.concatenate([xs, np.ones((n, 1))], axis=1)
    w = np.zeros(f + 1)
    lam = np.ones(f + 1) / c
    lam[-1] = 0.0   # the intercept is not regularised (sklearn)
    for _ in range(max_iter):
        p = 1.0 / (1.0 + np.exp(-(xb @ w)))
        g = xb.T @ (p - y) + lam * w
        r = np.clip(p * (1 - p), 1e-10, None)
        h = (xb * r[:, None]).T @ xb + np.diag(lam)
        step = np.linalg.solve(h, g)
        w = w - step
        if np.abs(step).max() < tol:
            break
    as32 = lambda a: None if a is None else a.astype(np.float32)
    return LogisticRegression(coef=w[:f].astype(np.float32), intercept=float(w[f]),
                              mean=as32(mean), scale=as32(scale))


# --- CART decision tree (gini) and random forest, numpy ----------------------

@dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    left: Optional["_Node"] = None
    right: Optional["_Node"] = None
    value: int = 0


def _majority(y: np.ndarray) -> _Node:
    return _Node(value=int(np.bincount(y, minlength=2).argmax()))


class DecisionTree:
    """Binary CART classifier, gini impurity, midpoint thresholds.
    `max_features` subsamples the features at each split (drawn from `rng`,
    as a forest needs); None considers every feature (sklearn's
    DecisionTreeClassifier default)."""

    def __init__(self, max_depth: Optional[int] = None,
                 min_samples_split: int = 2,
                 max_features: Optional[int] = None,
                 rng: Optional[np.random.Generator] = None):
        self.max_depth = max_depth
        self.min_samples_split = min_samples_split
        self.max_features = max_features
        self._rng = rng
        self.root: Optional[_Node] = None

    def fit(self, x: np.ndarray, y: np.ndarray) -> "DecisionTree":
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.int64).reshape(-1)
        self.root = self._build(x, y, 0)
        self._rng = None   # only fit draws; a generator does not pickle portably
        return self

    def _split_candidates(self, n_features: int):
        if self.max_features is None or self.max_features >= n_features:
            return range(n_features)
        return self._rng.choice(n_features, self.max_features, replace=False)

    def _build(self, x, y, depth) -> _Node:
        if (len(np.unique(y)) == 1 or len(y) < self.min_samples_split
                or (self.max_depth is not None and depth >= self.max_depth)):
            return _majority(y)
        best = (None, None, 1e18)
        n = len(y)
        for f in self._split_candidates(x.shape[1]):
            order = np.argsort(x[:, f], kind="mergesort")
            xv, yv = x[order, f], y[order]
            valid = xv[1:] != xv[:-1]
            if not valid.any():
                continue
            ones_left = np.cumsum(yv)[:-1]
            n_left = np.arange(1, n)
            n_right = n - n_left
            ones_right = ones_left[-1] + yv[-1] - ones_left
            p_l = ones_left / n_left
            p_r = ones_right / n_right
            gini = (n_left * 2 * p_l * (1 - p_l) + n_right * 2 * p_r * (1 - p_r)) / n
            gini = np.where(valid, gini, 1e18)
            i = int(np.argmin(gini))
            if gini[i] < best[2]:
                best = (f, (xv[i] + xv[i + 1]) / 2.0, float(gini[i]))
        if best[0] is None:
            return _majority(y)
        f, thr, _ = best
        mask = x[:, f] <= thr
        if mask.all() or (~mask).all():
            return _majority(y)
        return _Node(feature=f, threshold=thr,
                     left=self._build(x[mask], y[mask], depth + 1),
                     right=self._build(x[~mask], y[~mask], depth + 1))

    def predict(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        out = np.zeros(len(x), np.int64)
        for i, row in enumerate(x):
            node = self.root
            while node.left is not None:
                node = node.left if row[node.feature] <= node.threshold else node.right
            out[i] = node.value
        return out

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(path: str) -> "DecisionTree":
        return _load_trees(path, DecisionTree)


class RandomForest:
    """Bagged CART ensemble (parity: the reference's RandomForestClassifier
    defaults, sharp_detector_params_estimation_parallel.py:21,247,280: 100
    trees, bootstrap samples, sqrt features per split, unlimited depth,
    majority vote)."""

    def __init__(self, n_estimators: int = 100,
                 max_features: Optional[str | int] = "sqrt",
                 max_depth: Optional[int] = None, seed: int = 0):
        self.n_estimators = n_estimators
        self.max_features = max_features
        self.max_depth = max_depth
        self.seed = seed
        self.trees: list[DecisionTree] = []

    def fit(self, x: np.ndarray, y: np.ndarray) -> "RandomForest":
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.int64).reshape(-1)
        n, nf = x.shape
        mf = max(1, int(np.sqrt(nf))) if self.max_features == "sqrt" else self.max_features
        rng = np.random.default_rng(self.seed)
        self.trees = []
        for _ in range(self.n_estimators):
            idx = rng.integers(0, n, n)            # bootstrap sample
            t = DecisionTree(max_depth=self.max_depth, max_features=mf, rng=rng)
            self.trees.append(t.fit(x[idx], y[idx]))
        return self

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        p1 = np.stack([t.predict(x) for t in self.trees]).mean(axis=0)
        return np.stack([1 - p1, p1], axis=-1)

    def predict(self, x: np.ndarray) -> np.ndarray:
        return (self.predict_proba(x)[:, 1] >= 0.5).astype(np.int64)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(path: str) -> "RandomForest":
        return _load_trees(path, RandomForest)


# the classes a tree or forest pickle may name: this module's, the JAX
# package's (mapped to this module's), and numpy's array and scalar types
_TREE_MODULES = ("speinet_tpu_torch.detector.classifier",
                 "speinet_tpu.detector.classifier")
_NUMPY_NAMES = {("numpy", "dtype"), ("numpy", "ndarray"),
                ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
                ("numpy.core.multiarray", "_reconstruct"),
                ("numpy._core.multiarray", "_reconstruct")}


class _TreeUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module in _TREE_MODULES and name in ("DecisionTree", "RandomForest", "_Node"):
            return globals()[name]
        if (module, name) in _NUMPY_NAMES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"a detector pickle may not name {module}.{name}")


def _load_trees(path: str, cls):
    with open(path, "rb") as f:
        obj = _TreeUnpickler(f).load()
    if not isinstance(obj, cls):
        raise TypeError(f"{path} holds a {type(obj).__name__}, not a {cls.__name__}")
    return obj


def binary_metrics(y_true, y_pred) -> dict:
    """accuracy / recall / precision / F1 (the detector CSVs' columns)."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    tp = int(((y_true == 1) & (y_pred == 1)).sum())
    fp = int(((y_true == 0) & (y_pred == 1)).sum())
    fn = int(((y_true == 1) & (y_pred == 0)).sum())
    acc = float((y_true == y_pred).mean())
    rec = tp / (tp + fn) if tp + fn else 0.0
    prec = tp / (tp + fp) if tp + fp else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    return {"accuracy": acc, "recall": rec, "precision": prec, "f1": f1}
