"""The port's modules (speinet_tpu_torch.models) against speinet_tpu's on the
CPU, with the same weights on both sides.

The weights start as a seeded port init, go to the flax tree through the JAX
package's own converter (`convert_state_dict`), get their BatchNorm running
statistics and gate affines perturbed with numpy, and come back to the port
through `from_flax_params`, so every comparison also carries the BatchNorm
state across. Tiny model (n_feat 8, embed_dim 32, one depth-2 RSTB, 4 heads),
float32, rtol/atol 1e-4 unless a case says why it needs more.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from speinet_tpu.models.blocks import ResBlock as JResBlock
from speinet_tpu.models.recons_video import ReconsVideo as JRecons
from speinet_tpu.models.search_transfer import TransferUnit as JTransfer
from speinet_tpu.models.speinet import SPEINet as JSPEINet
from speinet_tpu.models.swinir import SwinIRCross as JSwin
from speinet_tpu.utils.convert import convert_state_dict
from speinet_tpu_torch.models.search_transfer import transfer
from speinet_tpu_torch.models.speinet import SPEINet, init_weights
from speinet_tpu_torch.utils.convert import from_flax_params

TINY = dict(n_feat=8, embed_dim=32, depths=(2,), num_heads=(4,),
            window_size=5, mlp_ratio=2.0)
TOL = dict(rtol=1e-4, atol=1e-4)
F32 = torch.float32


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(t):
    return jax.tree_util.tree_map(lambda a: np.array(a), t)


@pytest.fixture(scope="module")
def shared():
    """(flax variables, port model) holding the same weights."""
    jm = JSPEINet(**TINY, drop_path_rate=0.0)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 5, 3, 40, 40))))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    port = init_weights(SPEINet(**TINY), seed=3).eval()
    params, bstats = convert_state_dict(port.state_dict(), template,
                                        depths=TINY["depths"], n_resblock=3)
    rng = np.random.default_rng(7)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if "mean" in name:
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if "var" in name:
            return (0.5 + rng.random(a.shape)).astype(a.dtype)
        return a

    bstats = jax.tree_util.tree_map_with_path(perturb, bstats)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: ((1 + 0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
                      if "BatchNorm_0" in jax.tree_util.keystr(p) else a), params)
    port.load_state_dict(from_flax_params(params, bstats, depths=TINY["depths"]),
                         strict=True)
    return {"params": params, "batch_stats": bstats}, port


def _sub(variables, *path):
    out = {}
    for col in ("params", "batch_stats"):
        node = variables[col]
        for k in path:
            node = node.get(k, {}) if isinstance(node, dict) else {}
        if node:
            out[col] = node
    return out


def _frames(n, h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.5 + 0.25 * np.sin(xx / 6.0) * np.cos(yy / 5.0)
    f = np.stack([base + 0.03 * rng.standard_normal((h, w)) + 0.04 * k
                  for k in range(n)])[:, None] * np.array([1.0, 0.9, 0.8])[None, :, None, None]
    return np.clip(f, 0.05, 1.0).astype(np.float32)


def test_from_flax_round_trip(shared):
    """from_flax_params -> port state_dict -> convert_state_dict gives back
    the flax tree exactly (BatchNorm running stats and ConvTranspose layout
    included)."""
    variables, port = shared
    back_p, back_b = convert_state_dict(port.state_dict(),
                                        _np_tree(variables),
                                        depths=TINY["depths"], n_resblock=3)
    flat = lambda t: jax.tree_util.tree_leaves_with_path(t)
    for (pa, a), (pb, b) in zip(flat(variables["params"]), flat(back_p)):
        assert pa == pb
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(pa))
    for (pa, a), (pb, b) in zip(flat(variables["batch_stats"]), flat(back_b)):
        assert pa == pb
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(pa))
    # search23 is unused by the flax model and comes back as zeros
    assert not port.search23.weight.any()


def test_resblock(shared):
    variables, port = shared
    rng = np.random.default_rng(20)
    x = rng.standard_normal((2, 12, 16, 16)).astype(np.float32)
    want = JResBlock(16).apply(_sub(variables, "recons_net", "enc1_res", "res1"),
                               jnp.asarray(x))
    got = port.recons_net.encoder_first[2](torch.from_numpy(x), F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_recons_video_stages(shared):
    variables, port = shared
    r = port.recons_net
    jr = JRecons(n_feat=8, n_resblock=3)
    v = _sub(variables, "recons_net")
    x = _frames(2, 24, 32, seed=21).transpose(0, 2, 3, 1)
    want = jr.apply(v, jnp.asarray(x), method=JRecons.encode_pyramid)
    got = r.encode_pyramid(torch.from_numpy(np.ascontiguousarray(x)), F32)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **TOL)
    lv3 = np.asarray(want[2])
    d2 = jr.apply(v, jnp.asarray(lv3), method=JRecons.decoder_second)
    np.testing.assert_allclose(r.decode_second(_t(lv3), F32).numpy(),
                               np.asarray(d2), **TOL)
    d1 = jr.apply(v, d2, method=JRecons.decoder_first)
    np.testing.assert_allclose(
        r.decode_first(_t(d2), F32).numpy(),
        np.asarray(d1), **TOL)
    out = jr.apply(v, d1, method=JRecons.out_block)
    np.testing.assert_allclose(
        r.out_block(_t(d1), F32).numpy(),
        np.asarray(out), **TOL)


@pytest.mark.parametrize("h,w", [(10, 10), (12, 16)])
def test_swinir_cross(shared, h, w):
    """Window-aligned (Q stream pre-rolled once) and padded + masked sizes."""
    variables, port = shared
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, h, w, 32)).astype(np.float32)
    y = rng.standard_normal((2, h, w, 32)).astype(np.float32)
    js = JSwin(embed_dim=32, depths=(2,), num_heads=(4,), window_size=5,
               mlp_ratio=2.0, drop_path_rate=0.0)
    want = js.apply(_sub(variables, "swin"), jnp.asarray(x), jnp.asarray(y))
    got = port.swin(torch.from_numpy(x), torch.from_numpy(y), F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("routing", ["sharp", "self", "mixed"])
def test_transfer_unit(shared, routing):
    """'sharp' / 'self' through K4's plain version, 'mixed' (sample 0 sharp,
    sample 1 self) through K5's on unfolds, against TransferUnit."""
    variables, port = shared
    rng = np.random.default_rng(23)
    b, h, w, f = 2, 6, 8, 8
    ff = rng.standard_normal((b, h, w, 4 * f)).astype(np.float32)
    lv1 = rng.standard_normal((b, 4 * h, 4 * w, f)).astype(np.float32)
    lv2 = rng.standard_normal((b, 2 * h, 2 * w, 2 * f)).astype(np.float32)
    lv3 = rng.standard_normal((b, h, w, 4 * f)).astype(np.float32)
    hs = np.array([True, False]) if routing == "mixed" else np.array(
        [routing == "sharp"] * b)
    want = JTransfer(n_feat=f).apply(_sub(variables, "transfer"), *map(
        jnp.asarray, (ff, lv1, lv2, lv3)), jnp.asarray(hs), routing=routing)
    got = transfer(port.SelfTransfer, *map(_t, (ff, lv1, lv2, lv3)),
                   routing, F32, has_sharp=torch.from_numpy(hs))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **TOL)


def test_transfer_rejects_mixed(shared):
    """Routing 'mixed' needs its per-sample has_sharp flags."""
    _, port = shared
    z = torch.zeros((1, 4, 4, 32))
    with pytest.raises(ValueError, match="has_sharp"):
        transfer(port.SelfTransfer, z, torch.zeros((1, 16, 16, 8)),
                 torch.zeros((1, 8, 8, 16)), z, "mixed", F32)


@pytest.mark.parametrize("h,w", [(40, 40), (48, 64)])
def test_speinet_cached_methods(shared, h, w):
    """encode_window_legs, anchor_pyramid and restore_from_features in both
    routings; 48x64 gives a 12x16 lv3 map, padded and masked in the Swin."""
    variables, port = shared
    jm = JSPEINet(**TINY, drop_path_rate=0.0)
    fr = _frames(4, h, w, seed=24)
    jm_legs = jm.apply(variables, jnp.asarray(fr[:3]),
                       method=JSPEINet.encode_window_legs)
    t_legs = port.encode_window_legs(torch.from_numpy(fr[:3]))
    for g, wnt in zip(t_legs, jm_legs):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **TOL)
    j_anchor = jm.apply(variables, jnp.asarray(fr[3:4]),
                        method=JSPEINet.anchor_pyramid)
    t_anchor = port.anchor_pyramid(torch.from_numpy(fr[3:4]))
    for g, wnt in zip(t_anchor, j_anchor):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **TOL)
    m, n = (np.asarray(a) for a in jm_legs)
    p = [np.asarray(a) for a in j_anchor]
    for routing in ("sharp", "self", "mixed"):
        hs = np.array([routing != "self"])
        restore = jax.jit(lambda v, *a, r=routing: jm.apply(
            v, *a, routing=r, method=JSPEINet.restore_from_features))
        want = restore(variables, jnp.asarray(m[1:2]),
                       (jnp.asarray(n[0:1]), jnp.asarray(n[2:3])),
                       *map(jnp.asarray, p), jnp.asarray(hs))
        got = port.restore_from_features(
            _t(m[1:2]), (_t(n[0:1]), _t(n[2:3])),
            *map(_t, p), routing, torch.from_numpy(hs))
        assert got.shape == (1, 3, h, w)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=routing)


@pytest.mark.parametrize("h,w", [(40, 40), (48, 64)])
def test_speinet_forward(shared, h, w):
    """SPEINet.forward against SPEINet.__call__ on a 3-sample batch: one
    sample with both sharp frames, one with frame 3 zeroed (routed to the
    self reference although frame 4 is kept), one with only frame 4 zeroed
    (routed to the sharp search of an all-zero pyramid)."""
    variables, port = shared
    jm = JSPEINet(**TINY, drop_path_rate=0.0)
    x = np.stack([_frames(5, h, w, seed=30 + k) for k in range(3)])
    x[1, 3] = 0.0
    x[2, 4] = 0.0
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    got = port(torch.from_numpy(x))
    assert got.shape == (3, 3, h, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


_TRAIN_FORWARD = {}


def _train_forward(dtype):
    """The JAX package's SPEINet training forward (batch statistics, no
    DropPath) in `dtype`, jitted once a dtype."""
    if dtype not in _TRAIN_FORWARD:
        jm = JSPEINet(**TINY, drop_path_rate=0.0, dtype=dtype)
        _TRAIN_FORWARD[dtype] = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"],
            rngs={"droppath": jax.random.PRNGKey(0)})[0])
    return _TRAIN_FORWARD[dtype]


@pytest.mark.parametrize("gain", [1.0, 3.0], ids=["as_drawn", "exploding"])
def test_bf16_departure_at_an_exploding_init_is_bf16s(shared, gain):
    """The training forward at a synthetic init whose decoder explodes (its
    gates' BatchNorm scales times 3: every ResBlock's gated product grows
    its input, the output reaches ~20 where it is ~0.6 as drawn). In
    float32 the port equals the JAX package; in bf16 the port and the JAX
    package both depart from their float32 output by more than a tenth,
    and by ~1.5% as drawn. The float32 port on the input rounded to bf16,
    every operation after that rounding float32, departs by more than a
    twentieth there (under 1% as drawn): the exploding init amplifies any
    rounding, the input's alone included, so no bf16 computation can
    follow the float32 one there, in either package. The init is made
    here, not drawn from a seed, and is not the benchmark's seed
    2147486003's own explosion (ROADMAP, F7), which the benchmark's
    reference reads in the same way on the card."""
    variables, _ = shared
    port = init_weights(SPEINet(**TINY, drop_path_rate=0.0), seed=3)
    for name, mod in port.named_modules():
        if name.startswith(("recons_net.decoder", "recons_net.outBlock")) \
                and name.endswith(".conv.bn"):
            mod.weight.mul_(gain)
    params, bstats = convert_state_dict(port.state_dict(), _np_tree(variables),
                                        depths=TINY["depths"], n_resblock=3)
    x = np.random.default_rng(0).random((3, 5, 3, 40, 40)).astype(np.float32)
    out = {}
    for dt in (jnp.float32, jnp.bfloat16):
        y = _train_forward(dt)({"params": params, "batch_stats": bstats}, jnp.asarray(x))
        out["jax", dt] = torch.from_numpy(np.asarray(y.astype(jnp.float32)))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        m = SPEINet(**TINY, drop_path_rate=0.0, dtype=dt)
        m.load_state_dict(port.state_dict(), strict=True)
        out["port", jdt] = m(torch.from_numpy(x), train=True).float()
    gap = lambda a, b: float(((a - b).flatten(1).norm(dim=1)
                              / b.flatten(1).norm(dim=1)).max())
    f32 = out["port", jnp.float32]
    assert gap(f32, out["jax", jnp.float32]) < 1e-4
    port_bf, jax_bf = (gap(out[k, jnp.bfloat16], out[k, jnp.float32]) for k in ("port", "jax"))
    m = SPEINet(**TINY, drop_path_rate=0.0)
    m.load_state_dict(port.state_dict(), strict=True)
    rounded_in = gap(m(torch.from_numpy(x).bfloat16().float(), train=True), f32)
    if gain == 1.0:
        assert f32.abs().max() < 2 and port_bf < 0.03 and jax_bf < 0.03
        assert rounded_in < 0.01
    else:
        assert f32.abs().max() > 20 and port_bf > 0.1 and jax_bf > 0.1
        assert 0.5 < port_bf / jax_bf < 2
        assert rounded_in > 0.05
