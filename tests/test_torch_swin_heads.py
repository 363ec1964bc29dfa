"""K2 / K8 at head dims below the kernels' 32 (`kernels/swin.py::
widen_heads`), on the CPU: the widened operands (channels copied, each head
zero-padded to 32 features) through the kernels' plain arithmetic give the
block of the narrow heads, held to the plain version on the original
operands and to the JAX package's fused_swin_block (Pallas, interpret
mode) at the head-to-head model's 64 channels over 4 heads."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speinet_tpu_torch.kernels.swin import (head_replicas, swin_block_plain,
                                            widen_heads,
                                            window_cross_attention_plain)
from test_torch_kernels import _flax_block, _port_weights, _t, interpret  # noqa: F401


@pytest.mark.parametrize("c,heads,r", [(256, 8, 1), (64, 4, 2), (32, 4, 4),
                                       (128, 8, 2), (256, 16, 0), (96, 4, 0),
                                       (128, 2, 0)])
def test_head_replicas(c, heads, r):
    assert head_replicas(c, heads) == r


@pytest.mark.parametrize("c,heads,shift,pad_h,pad_w", [
    (64, 4, 0, 0, 0), (64, 4, 2, 0, 0), (64, 4, 2, 1, 2), (32, 4, 2, 3, 0)])
def test_widened_block_is_the_narrow_heads_block(c, heads, shift, pad_h, pad_w):
    _, v, _, _ = _flax_block(c, heads, shift, 10, 10, seed=21)
    wts = _port_weights(v["params"], heads)
    rng = np.random.default_rng(22)
    x, y = (_t(rng.standard_normal((2, 10, 15, c)).astype(np.float32))
            for _ in range(2))
    xw, yw, ww = widen_heads(x, y, wts, heads)
    r = head_replicas(c, heads)
    assert xw.shape == (2, 10, 15, r * c) and ww.wq.shape == (r * c, r * c)
    assert ww.wkv.shape == (2 * r * c, r * c) and ww.w1.shape == (2 * c, r * c)
    scale = (c // heads) ** -0.5
    for plain in (swin_block_plain, window_cross_attention_plain):
        want = plain(x, y, wts, 5, shift, pad_h, pad_w, heads)
        got = plain(xw, yw, ww, 5, shift, pad_h, pad_w, heads, scale=scale)
        # LayerNorm sums r copies in another order: float32 rounding only
        torch.testing.assert_close(got[..., :c], want, rtol=1e-5, atol=1e-5)
        for k in range(1, r):
            torch.testing.assert_close(got[..., k * c:(k + 1) * c], got[..., :c],
                                       rtol=0, atol=0)


def test_head_dim_32_is_left_alone():
    _, v, _, _ = _flax_block(64, 2, 0, 10, 10, seed=23)
    wts = _port_weights(v["params"], 2)
    x = torch.zeros((1, 10, 10, 64))
    assert widen_heads(x, x, wts, 2) == (x, x, wts)


def test_widened_block_matches_pallas_at_16_feature_heads(interpret):
    from speinet_tpu.ops.pallas_swin import fused_swin_block

    c, heads, shift = 64, 4, 2
    _, v, _, _ = _flax_block(c, heads, shift, 10, 10, seed=24)
    p, a = v["params"], v["params"]["attn"]
    wts = _port_weights(p, heads)
    rng = np.random.default_rng(25)
    x, y = (rng.standard_normal((1, 10, 15, c)).astype(np.float32) for _ in range(2))
    xw, yw, ww = widen_heads(_t(x), _t(y), wts, heads)
    got = swin_block_plain(xw, yw, ww, 5, shift, 0, 0, heads,
                           scale=(c // heads) ** -0.5)[..., :c].numpy()
    want = fused_swin_block(
        jnp.asarray(x), jnp.asarray(y), p["norm1"]["scale"], p["norm1"]["bias"],
        a["qkv_x"]["kernel"], a["qkv_x"]["bias"], a["qkv_y"]["kernel"],
        a["qkv_y"]["bias"], a["proj"]["kernel"], a["proj"]["bias"],
        jnp.asarray(wts.relbias.numpy()), p["norm2"]["scale"], p["norm2"]["bias"],
        p["mlp_fc1"]["kernel"], p["mlp_fc1"]["bias"], p["mlp_fc2"]["kernel"],
        p["mlp_fc2"]["bias"], ws=5, shift=shift, pad_h=0, pad_w=0, heads=heads)
    # the Pallas kernel's erf is a 1.5e-7 polynomial (pallas_swin.py:96)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
