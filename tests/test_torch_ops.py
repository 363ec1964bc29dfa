"""The port's ops (speinet_tpu_torch.ops) against speinet_tpu.ops on the CPU.

Same numpy inputs from a seed through both; float32 throughout, tolerance
rtol/atol 1e-5 unless a case says why it needs more.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from speinet_tpu.ops import filters as jf
from speinet_tpu.ops import metrics as jm
from speinet_tpu.ops import patch_ops as jp
from speinet_tpu.ops import resize as jr
from speinet_tpu_torch.ops import filters as tf
from speinet_tpu_torch.ops import metrics as tm
from speinet_tpu_torch.ops import patch_ops as tp
from speinet_tpu_torch.ops import resize as tr


@pytest.mark.parametrize("iters", [1, 5])
def test_richardson_lucy_box(iters):
    rng = np.random.default_rng(1)
    x = rng.random((2, 3, 20, 24)).astype(np.float32)
    x[0, 0, :3, :3] = 0.0           # 0/0 -> NaN -> 0 in the ratio
    want = jf.richardson_lucy(jnp.asarray(x), jf.box_kernel(5), iters, 0.01,
                              box_size=5)
    got = tf.richardson_lucy(torch.from_numpy(x), tf.box_kernel(5), iters,
                             0.01, box_size=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_richardson_lucy_conv_form_matches_box_form():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random((1, 3, 16, 16)).astype(np.float32))
    a = tf.richardson_lucy(x, tf.box_kernel(5), 2, 0.01, box_size=5)
    b = tf.richardson_lucy(x, tf.box_kernel(5), 2, 0.01)
    want = jf.richardson_lucy(jnp.asarray(x.numpy()), jf.box_kernel(5), 2, 0.01)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scale", [2, 4])
def test_bicubic_upsample_nhwc(scale):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 9, 5)).astype(np.float32)
    want = jr.bicubic_upsample_nhwc(jnp.asarray(x), scale)
    got = tr.bicubic_upsample_nhwc(torch.from_numpy(x), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # and torch's own bicubic, which the JAX function reproduces
    ref = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=scale,
        mode="bicubic", align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)


def test_unfold():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 4, 6, 7)).astype(np.float32)
    want = jp.unfold(jnp.asarray(x), 3, 1, 1)
    got = tp.unfold(torch.from_numpy(x), 3, 1, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("h,w", [(5, 6), (8, 8)])
def test_gather_fold3_strides_1_2_4(h, w):
    """One combined gather serves the three scales (strides 1, 2, 4)."""
    rng = np.random.default_rng(5)
    b, c = 2, 4
    ref3 = rng.standard_normal((b, h, w, 4 * c)).astype(np.float32)
    ref2 = rng.standard_normal((b, 2 * h, 2 * w, 2 * c)).astype(np.float32)
    ref1 = rng.standard_normal((b, 4 * h, 4 * w, c)).astype(np.float32)
    idx = rng.integers(0, h * w, size=(b, h * w)).astype(np.int32)
    want = jp.gather_fold3_nhwc(jnp.asarray(ref1), jnp.asarray(ref2),
                                jnp.asarray(ref3), jnp.asarray(idx))
    got = tp.gather_fold3_nhwc(torch.from_numpy(ref1), torch.from_numpy(ref2),
                               torch.from_numpy(ref3), torch.from_numpy(idx))
    for g, wnt, s in zip(got, want, (1, 2, 4)):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-5,
                                   atol=1e-5, err_msg=f"stride {s}")
        # and the per-scale tiles form of the JAX package
        one = jp.gather_fold_nhwc_tiles(jnp.asarray({1: ref3, 2: ref2, 4: ref1}[s]),
                                        jnp.asarray(idx), s)
        np.testing.assert_allclose(g.numpy(), np.asarray(one), rtol=1e-5,
                                   atol=1e-5, err_msg=f"stride {s} tiles")


def test_gather_fold3_rejects_wrong_index_length():
    z = torch.zeros((1, 4, 4, 2))
    with pytest.raises(ValueError):
        tp.gather_fold3_nhwc(torch.zeros((1, 16, 16, 2)), torch.zeros((1, 8, 8, 2)),
                             z, torch.zeros((1, 15), dtype=torch.int32))


def test_psnr_and_ssim():
    rng = np.random.default_rng(6)
    a = rng.integers(0, 256, (40, 48, 3)).astype(np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-9, 10, a.shape), 0, 255
                ).astype(np.uint8)
    assert tm.psnr_uint8_host(a, b) == jm.psnr_uint8_host(a, b)
    assert tm.psnr_uint8_host(a, a) == float("inf")
    want = float(jm.ssim_matlab(jnp.asarray(a), jnp.asarray(b)))
    got = float(tm.ssim_matlab(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - want) < 1e-5
    gray = float(tm.ssim_matlab(torch.from_numpy(a[..., 0]), torch.from_numpy(b[..., 0])))
    want_g = float(jm.ssim_matlab(jnp.asarray(a[..., 0]), jnp.asarray(b[..., 0])))
    assert abs(gray - want_g) < 1e-5
