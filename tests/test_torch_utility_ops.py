"""The port's classical smoothing and utility ops (ops.smoothing, the
utility filters of ops.filters, utils.image_utils, ops.metrics.psnr_uint8)
against speinet_tpu's, on the CPU: the same numpy inputs from a seed at
32-48 px, float32 within rtol / atol 1e-5, and the host numpy functions
(rtv_smooth, the YCbCr conversions, the crops, AverageMeter) exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import speinet_tpu.ops.filters as jfilters
import speinet_tpu.ops.smoothing as jsmoothing
import speinet_tpu.utils.image_utils as jimage
from speinet_tpu.ops.metrics import psnr_uint8 as j_psnr_uint8
from speinet_tpu_torch.ops import filters, smoothing
from speinet_tpu_torch.ops.metrics import psnr_uint8, psnr_uint8_host
from speinet_tpu_torch.utils import image_utils

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(shape, seed):
    """A smooth pattern with edges and noise, in [0, 1], float32."""
    rng = np.random.default_rng(seed)
    h, w = shape[-2:] if len(shape) == 4 else shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.5 + 0.3 * np.sin(xx / 4.0) * np.cos(yy / 5.0) + 0.15 * (xx > w // 2)
    img = base.reshape((1,) * (len(shape) - 2) + (h, w)) if len(shape) == 4 else \
        base.reshape((h, w) + (1,) * (len(shape) - 2))
    img = img + 0.05 * rng.standard_normal(shape)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


PSF = np.outer([1.0, 2.0, 3.0, 2.0, 1.0], [1.0, 2.0, 1.0]).astype(np.float32)
PSF /= PSF.sum()
PSF_EVEN = np.full((4, 4), 1 / 16, np.float32)


@pytest.mark.parametrize("shape", [(32, 40), (33, 48)])
def test_psf2otf(shape):
    got = filters.psf2otf(torch.from_numpy(PSF), shape)
    want = jsmoothing._psf2otf(jnp.asarray(PSF), shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_l0_smoothing():
    img = _image((40, 48, 3), seed=1)
    got = smoothing.l0_smoothing(torch.from_numpy(img))
    want = jsmoothing.l0_smoothing(jnp.asarray(img))
    _close(got, want)


@pytest.mark.parametrize("shape", [(40, 48), (32, 40, 3)])
def test_ftvd(shape):
    img = _image(shape, seed=2)
    got = smoothing.ftvd(torch.from_numpy(img), torch.from_numpy(PSF))
    want = jsmoothing.ftvd(jnp.asarray(img), jnp.asarray(PSF))
    assert got.shape == shape
    _close(got, want)


@pytest.mark.parametrize("psf", [PSF, PSF_EVEN], ids=["5x3", "4x4"])
def test_rl_deconv(psf):
    img = _image((2, 3, 32, 40), seed=3)
    got = smoothing.rl_deconv(torch.from_numpy(img), torch.from_numpy(psf), n_iter=5)
    want = jsmoothing.rl_deconv(jnp.asarray(img), jnp.asarray(psf), n_iter=5)
    _close(got, want)


def test_rtv_smooth_exact():
    img = _image((32, 40, 3), seed=4)
    np.testing.assert_array_equal(smoothing.rtv_smooth(img, n_iter=2),
                                  jsmoothing.rtv_smooth(img, n_iter=2))


@pytest.mark.parametrize("name", ["sobel_magnitude", "laplacian_filter", "mean_filter"])
def test_filters(name):
    x = _image((2, 3, 32, 40), seed=5)
    _close(getattr(filters, name)(torch.from_numpy(x)),
           getattr(jfilters, name)(jnp.asarray(x)))


@pytest.mark.parametrize("psf", [PSF, PSF_EVEN], ids=["5x3", "4x4"])
def test_wiener_deconv(psf):
    x = _image((2, 3, 32, 40), seed=6)
    got = filters.wiener_deconv(torch.from_numpy(x), torch.from_numpy(psf), snr=0.02)
    want = jfilters.wiener_deconv(jnp.asarray(x), jnp.asarray(psf), snr=0.02)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("fn", ["rgb2ycbcr", "bgr2ycbcr"])
@pytest.mark.parametrize("only_y", [True, False])
def test_ycbcr_exact(fn, only_y):
    rng = np.random.default_rng(7)
    u8 = rng.integers(0, 256, (32, 40, 3), np.uint8)
    f32 = rng.random((32, 40, 3)).astype(np.float32)
    for img in (u8, f32):
        got = getattr(image_utils, fn)(img, only_y)
        want = getattr(jimage, fn)(img, only_y)
        assert got.dtype == img.dtype
        np.testing.assert_array_equal(got, want)


def test_adaptive_instance_normalization():
    rng = np.random.default_rng(8)
    center = rng.standard_normal((2, 3, 4, 36)).astype(np.float32)
    knn = (2.0 + 3.0 * rng.standard_normal((2, 3, 4, 9, 5))).astype(np.float32)
    got = image_utils.adaptive_instance_normalization(torch.from_numpy(center),
                                                      torch.from_numpy(knn))
    want = jimage.adaptive_instance_normalization(center, knn)
    _close(got, want)


def test_meter_and_crops_exact():
    mine, theirs = image_utils.AverageMeter(), jimage.AverageMeter()
    for v, n in ((1.5, 2), (0.25, 3), (4.0, 1)):
        mine.update(v, n)
        theirs.update(v, n)
    assert (mine.val, mine.sum, mine.count, mine.avg) == (
        theirs.val, theirs.sum, theirs.count, theirs.avg)
    assert repr(mine) == repr(theirs)
    img = np.arange(48 * 40 * 3).reshape(48, 40, 3)
    for border in (0, 4):
        np.testing.assert_array_equal(image_utils.crop_border(img, border),
                                      jimage.crop_border(img, border))
        for a, b in zip(image_utils.crop_border([img, img + 1], border),
                        jimage.crop_border([img, img + 1], border)):
            np.testing.assert_array_equal(a, b)
    x, target = torch.zeros((1, 3, 40, 48)), torch.zeros((1, 3, 32, 36))
    assert image_utils.crop_like(x, target).shape == jimage.crop_like(
        x.numpy(), target.numpy()).shape == (1, 3, 32, 36)
    assert image_utils.crop_like(x, x) is x


def test_psnr_uint8():
    rng = np.random.default_rng(9)
    a = rng.integers(0, 256, (40, 48, 3), np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-6, 7, a.shape), 0, 255).astype(np.uint8)
    got = psnr_uint8(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float64 and got.ndim == 0
    np.testing.assert_allclose(got.item(), float(j_psnr_uint8(jnp.asarray(a),
                                                              jnp.asarray(b))), **TOL)
    assert got.item() == psnr_uint8_host(a, b)
    assert psnr_uint8(torch.from_numpy(a), torch.from_numpy(a)).item() == float("inf")
