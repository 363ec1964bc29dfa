"""The port's chopped forward (speinet_tpu_torch.parallel.chop) and 8-way
self-ensemble (infer.forward_x8) against speinet_tpu's on the CPU, with toy
forwards that are neither local nor flip-equivariant, so a tile or a
transform put back in the wrong place shows."""

import numpy as np
import jax.numpy as jnp
import torch

from speinet_tpu.infer import forward_x8 as j_forward_x8
from speinet_tpu.parallel.chop import chop_batch as j_chop_batch
from speinet_tpu.parallel.chop import chop_forward as j_chop_forward
from speinet_tpu.parallel.chop import chop_merge as j_chop_merge
from speinet_tpu_torch.infer import forward_x8
from speinet_tpu_torch.parallel.chop import chop_batch, chop_forward, chop_merge


def _x(seed, b=2, h=64, w=96):
    return np.random.default_rng(seed).random((b, 5, 3, h, w)).astype(np.float32)


def _toy(xp):
    """[B, 5, 3, h, w] -> [B, 3, h, w]: the centre frame, a ramp along W,
    plus each sample's global mean of frame 0 (a non-local term)."""
    def fwd(t):
        ramp = xp.arange(t.shape[-1], dtype=t.dtype) / t.shape[-1]
        return t[:, 1] * (1.0 + ramp) + t[:, 0].mean(axis=(1, 2, 3))[:, None, None, None]
    return fwd


def _torch_toy(t):
    ramp = torch.arange(t.shape[-1], dtype=t.dtype) / t.shape[-1]
    return t[:, 1] * (1.0 + ramp) + t[:, 0].mean(dim=(1, 2, 3))[:, None, None, None]


def test_chop_batch_and_merge_match_jax():
    x = _x(50)
    tiles = chop_batch(torch.from_numpy(x), shave=8)
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(j_chop_batch(jnp.asarray(x), 8)))
    y = np.random.default_rng(51).random((8, 3, 40, 56)).astype(np.float32)
    np.testing.assert_array_equal(chop_merge(torch.from_numpy(y), 64, 96).numpy(),
                                  np.asarray(j_chop_merge(jnp.asarray(y), 64, 96)))


def test_chop_forward_matches_jax_with_one_recursion():
    """64 x 96 = 6144 px >= 6 * 1000: each quadrant (40 x 56) recurses once
    into four 28 x 36 tiles."""
    x = _x(52)
    calls = []

    def fwd(t):
        calls.append(tuple(t.shape))
        return _torch_toy(t)

    got = chop_forward(fwd, torch.from_numpy(x), shave=8, min_size=1000)
    want = j_chop_forward(_toy(jnp), jnp.asarray(x), shave=8, min_size=1000)
    assert calls == [(8, 5, 3, 28, 36)] * 4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_forward_x8_matches_jax():
    x = _x(53, h=24, w=40)
    got = forward_x8(torch.from_numpy(x), _torch_toy)
    want = j_forward_x8(jnp.asarray(x), _toy(jnp))
    assert got.shape == (2, 3, 24, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
