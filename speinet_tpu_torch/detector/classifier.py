"""Logistic sharp / blurry classifier on the six focus features (port of
`speinet_tpu/detector/classifier.py`: `LogisticRegressionJAX` as
`LogisticRegression`, its `decision_function`, `predict` and `load`, and
`load_sklearn_pickle_obj`). Fitting comes with the detector-training slice.

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
