"""The port's sharpness detector (speinet_tpu_torch.detector, ops.wavelet)
against speinet_tpu's on the CPU: same numpy inputs from a seed, float32,
rtol 1e-4."""

import pickle

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from speinet_tpu.detector.classifier import LogisticRegressionJAX, default_detector_path
from speinet_tpu.detector.features import focus_features as j_focus_features
from speinet_tpu.detector.train import video_features as j_video_features
from speinet_tpu.ops.wavelet import dwt2_db6_detail as j_dwt2
from speinet_tpu_torch.detector.classifier import LogisticRegression
from speinet_tpu_torch.detector.features import focus_features
from speinet_tpu_torch.detector.train import video_features
from speinet_tpu_torch.ops.wavelet import dwt2_db6_detail


def _frames(n, h, w, seed):
    """Textured RGB frames in 0..255, some of them box-blurred."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        img = 127 + 80 * np.sin(xx / (3.0 + i)) * np.cos(yy / 4.0)
        img = img[..., None] + 20 * rng.standard_normal((h, w, 3))
        if i % 2:
            k = np.ones(5) / 5
            img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
        out.append(np.clip(img, 0, 255))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("h,w", [(37, 50), (48, 64)])
def test_dwt2_db6_detail_matches_jax(h, w):
    x = np.random.default_rng(40).random((2, h, w)).astype(np.float32)
    for got, want in zip(dwt2_db6_detail(torch.from_numpy(x)), j_dwt2(jnp.asarray(x))):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("k", [11, 7])
def test_focus_features_matches_jax(k):
    x = _frames(4, 48, 64, seed=41).transpose(0, 3, 1, 2)
    got = focus_features(torch.from_numpy(np.ascontiguousarray(x)), k)
    want = j_focus_features(jnp.asarray(x), k)
    assert got.shape == (4, 6) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


def test_video_features_matches_jax():
    frames = _frames(5, 40, 56, seed=42).astype(np.uint8)
    got = video_features(frames, kernel_size=11, batch=2, device="cpu")
    want = j_video_features(frames, kernel_size=11, batch=2)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_packaged_coefficients_equal_the_pickle():
    """default_logreg.npz carries the JAX package's default_logreg.pkl."""
    with open(default_detector_path(), "rb") as f:
        d = pickle.load(f)
    m = LogisticRegression.load()
    for key in ("coef", "mean", "scale"):
        np.testing.assert_array_equal(getattr(m, key), d[key])
        assert getattr(m, key).dtype == d[key].dtype
    assert m.intercept == d["intercept"]


def test_logistic_regression_matches_jax(tmp_path):
    """Margins and labels against LogisticRegressionJAX, for the packaged
    default and for a dict pickled by the JAX package's save()."""
    rng = np.random.default_rng(43)
    x = rng.standard_normal((64, 6)).astype(np.float32) * 3 + 5
    fitted = LogisticRegressionJAX(rng.standard_normal(6).astype(np.float32), 0.3)
    fitted.save(str(tmp_path / "m.pkl"))
    for path in (None, str(tmp_path / "m.pkl")):
        j = LogisticRegressionJAX.load(path or default_detector_path())
        m = LogisticRegression.load(path)
        margin = m.decision_function(x)
        want = np.asarray(j.decision_function(x))
        np.testing.assert_allclose(margin, want, rtol=1e-5, atol=1e-5)
        sure = np.abs(want) > 1e-4
        np.testing.assert_array_equal(m.predict(x)[sure], np.asarray(j.predict(x))[sure])
        assert m.predict(x).dtype == np.int32
