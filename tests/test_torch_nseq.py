"""The port at window lengths other than 3 against speinet_tpu, on the CPU.

Same weights on both sides (a seeded port init carried to the flax tree by
the JAX package's converter, BatchNorm statistics perturbed, back through
`from_flax_params`). Tiny model (n_feat 8, embed_dim 32, one depth-2 RSTB,
4 heads), float32, rtol/atol 1e-4.

`SPEINet.forward` and the cached methods at n_sequence 1 and 5. The
routing flag is frame 3 in JAX, which XLA clamps to the window's last
frame at n_sequence 1 (quirk 1): the port reads frame min(3, n + 1). The
engines at n_sequence 5: tests/test_torch_nseq_engine.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from speinet_tpu.models.speinet import SPEINet as JSPEINet
from speinet_tpu.utils.convert import convert_state_dict
from speinet_tpu_torch.models.speinet import SPEINet, init_weights
from speinet_tpu_torch.utils.convert import flax_model_shape, from_flax_params
from test_torch_models import TINY, _frames

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(ns: int, seed: int = 3):
    """(flax variables, port model) for window length `ns`, same weights."""
    jm = JSPEINet(n_sequence=ns, **TINY, drop_path_rate=0.0)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, ns + 2, 3, 40, 40))))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    port = init_weights(SPEINet(n_sequence=ns, **TINY), seed=seed)
    params, bstats = convert_state_dict(port.state_dict(), template,
                                        depths=TINY["depths"], n_resblock=3)
    rng = np.random.default_rng(seed)
    bstats = jax.tree_util.tree_map_with_path(
        lambda p, a: ((0.1 * rng.standard_normal(a.shape)) if "mean" in
                      jax.tree_util.keystr(p) else 0.5 + rng.random(a.shape)
                      ).astype(a.dtype), bstats)
    port.load_state_dict(from_flax_params(params, bstats, depths=TINY["depths"]),
                         strict=True)
    return {"params": params, "batch_stats": bstats}, jm, port.eval()


@pytest.mark.parametrize("ns", [1, 5])
def test_forward_matches_jax(ns):
    """A 3-sample batch: every frame present; frame min(3, n + 1) zeroed
    (routed to the self reference: at n_sequence 1 that is the sub-sharp
    frame, which JAX's clamped x[:, 3] reads; at 5 a blurry neighbour); the
    sub-sharp frame zeroed (the sharp search of an all-zero pyramid where
    frame 3 is not that frame)."""
    variables, jm, port = _weights(ns)
    assert flax_model_shape(variables["params"]) == dict(
        n_feat=8, n_sequence=ns, embed_dim=32, depths=[2], n_resblock=3)
    assert jnp.zeros((1, 3, 3, 4, 4))[:, 3].shape == (1, 3, 4, 4)   # XLA clamps
    x = np.stack([_frames(ns + 2, 40, 40, seed=30 + k) for k in range(3)])
    x[1, min(3, ns + 1)] = 0.0
    x[2, ns + 1] = 0.0
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    got = port(torch.from_numpy(x))
    assert got.shape == (3, 3, 40, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ns", [1, 5])
def test_cached_methods_match_jax(ns):
    """encode_window_legs and anchor_pyramid, then restore_from_features
    from the centre's features and the n - 1 neighbour streams (none at
    n_sequence 1), in one host routing each: the window length changes the
    fusion, which every routing shares (the routings themselves:
    tests/test_torch_models.py; per-sample ones: the forward above)."""
    variables, jm, port = _weights(ns)
    fr = _frames(ns + 1, 40, 40, seed=24)
    legs = jax.jit(lambda v, f: jm.apply(v, f, method=JSPEINet.encode_window_legs))(
        variables, jnp.asarray(fr[:ns]))
    t_legs = port.encode_window_legs(torch.from_numpy(fr[:ns]))
    for g, w in zip(t_legs, legs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    anchor = [np.asarray(a) for a in jax.jit(lambda v, f: jm.apply(
        v, f, method=JSPEINet.anchor_pyramid))(variables, jnp.asarray(fr[ns:]))]
    m, n = (np.asarray(a) for a in legs)
    mid = ns // 2
    nbs = [n[i:i + 1] for i in range(ns) if i != mid]
    routing = "self" if ns == 1 else "sharp"
    hs = np.array([routing != "self"])
    want = jax.jit(lambda v, *a: jm.apply(
        v, *a, routing=routing, method=JSPEINet.restore_from_features))(
        variables, jnp.asarray(m[mid:mid + 1]), tuple(map(jnp.asarray, nbs)),
        *map(jnp.asarray, anchor), jnp.asarray(hs))
    got = port.restore_from_features(_t(m[mid:mid + 1]), [_t(a) for a in nbs],
                                     *map(_t, anchor), routing, torch.from_numpy(hs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
