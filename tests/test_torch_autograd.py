"""The port's training pieces against speinet_tpu's, on the CPU.

- The backward of every kernel with one, through its plain version: K3
  against `jax.vjp` of `roll2d`, K4 against `banded_corr_argmax`'s custom
  VJP in both routings, K5 / K6 / K7 against the
  custom VJPs of the three `correlation_argmax_pallas*`, K10 against
  `take_along_axis`'s, and the whole gather-fold; float32, rtol / atol
  1e-5. Pallas runs in interpret mode. The correlation inputs have top-1 /
  top-2 margins far above the tolerance, and their indices must agree
  before the gradients are compared.
- The training forms of a ResBlock (batch-statistics BatchNorm and its
  running-statistics update) and of the Swin fusion (the XLA block),
  forward and input gradients, against the flax modules at rtol / atol
  1e-4.
- HEM's mask on JAX's own uniform draw, the StepLR rule, torch Adam against
  the optax chain, and the wrappers without a backward (K1, K2, K8, K9)
  refusing to run under autograd.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from speinet_tpu.config import Config as JConfig
from speinet_tpu.models.blocks import ResBlock as JResBlock
from speinet_tpu.models.swinir import SwinIRCross as JSwin
from speinet_tpu.training.loss import hem_loss as j_hem_loss
from speinet_tpu.training.loss import hem_mask as j_hem_mask
from speinet_tpu.training.train_state import lr_for_epoch as j_lr_for_epoch
from speinet_tpu.training.train_state import make_optimizer as j_make_optimizer
from speinet_tpu_torch import kernels
from speinet_tpu_torch.config import Config
from speinet_tpu_torch.kernels import SwinBlockWeights
from speinet_tpu_torch.models.swinir import drop_path
from speinet_tpu_torch.ops.patch_ops import gather_fold3_nhwc
from speinet_tpu_torch.training.loss import LossComputer, hem_loss, hem_mask
from speinet_tpu_torch.training.train_state import lr_for_epoch, make_optimizer
from test_torch_kernels import interpret  # noqa: F401
from test_torch_models import _sub, shared  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
F32 = torch.float32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the tests share the machine with other test
    workers, and torch's spinning thread pool slows ~10x when the cores
    are oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _ct(a):
    """A cotangent of the output's shape, from a seed."""
    return np.random.default_rng(a.size).standard_normal(a.shape).astype(np.float32)


def _no_ct(idx):
    return np.zeros(np.shape(idx), dtype=jax.dtypes.float0)


# --- K3 roll2d ---------------------------------------------------------------

@pytest.mark.parametrize("sh,sw", [(2, 2), (-2, 3), (7, -1)])
def test_roll2d_vjp_matches_jax(interpret, sh, sw):  # noqa: F811
    from speinet_tpu.ops.pallas_roll import roll2d as j_roll2d

    x = np.random.default_rng(1).standard_normal((2, 10, 15, 8)).astype(np.float32)
    out, vjp = jax.vjp(lambda a: j_roll2d(a, sh, sw, True), jnp.asarray(x))
    g = _ct(np.asarray(out))
    (want,) = vjp(jnp.asarray(g))
    xt = _t(x, grad=True)
    got = kernels.roll2d(xt, sh, sw)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    got.backward(_t(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **TOL)


# --- K5 / K6 / K7 correlation ------------------------------------------------

def _corr_inputs(seed, b=2, d=36, l=24, lr_len=29):
    """Operands whose winners are clear: each query is a noisy copy of one
    reference column, so top-1 exceeds top-2 by far more than the tolerance."""
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((b, d, lr_len)).astype(np.float32)
    pick = rng.integers(0, lr_len, (b, l))
    lr = (np.take_along_axis(ref, pick[:, None, :], 2)
          + 0.3 * rng.standard_normal((b, d, l))).astype(np.float32)
    inv = (0.5 + rng.random((b, lr_len))).astype(np.float32)
    return lr, ref, inv


def _margin(scores):
    """Smallest top-1 - top-2 gap over queries, scores [B, Lr, L]."""
    top = np.sort(scores, axis=1)
    return (top[:, -1] - top[:, -2]).min()


CORR_MODES = ["lds", "ld", "rows"]


@pytest.mark.parametrize("mode", CORR_MODES)
def test_corr_vjp_matches_jax(interpret, mode):  # noqa: F811
    """d lr, d ref (and d inv for K5) of S's cotangent, K5 on the raw
    reference with its scale, K6 on it pre-scaled, K7 on rows [B, Lr, D]."""
    import speinet_tpu.ops.pallas_corr as pc

    lr, ref, inv = _corr_inputs(seed=CORR_MODES.index(mode) + 3)
    if mode == "lds":
        args = (lr, ref, inv)
        j_fn, fn = pc.correlation_argmax_pallas_lds, kernels.correlation_argmax_lds
        scores = np.einsum("bdk,bdl->bkl", ref * inv[:, None], lr)
    elif mode == "ld":
        args = (lr, ref * inv[:, None])
        j_fn, fn = pc.correlation_argmax_pallas_ld, kernels.correlation_argmax_ld
        scores = np.einsum("bdk,bdl->bkl", args[1], lr)
    else:
        args = (lr, np.ascontiguousarray((ref * inv[:, None]).transpose(0, 2, 1)))
        j_fn, fn = pc.correlation_argmax_pallas, kernels.correlation_argmax
        scores = np.einsum("bkd,bdl->bkl", args[1], lr)
    assert _margin(scores) > 1e-2 * np.abs(scores).max()
    (s, idx), vjp = jax.vjp(j_fn, *map(jnp.asarray, args))
    gs = _ct(np.asarray(s))
    want = vjp((jnp.asarray(gs), _no_ct(idx)))

    ts = [_t(a, grad=True) for a in args]
    s_t, idx_t = fn(*ts)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx))
    np.testing.assert_allclose(s_t.detach().numpy(), np.asarray(s), **TOL)
    assert not idx_t.requires_grad
    s_t.backward(_t(gs))
    assert len(want) == len(ts)
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **TOL)


# --- K4 banded correlation ----------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 6), (6, 9)])
@pytest.mark.parametrize("routing", ["sharp", "self"])
def test_banded_corr_vjp_matches_jax(interpret, routing, shape):  # noqa: F811
    """d lr, d ref and d inv of S's cotangent through K4's plain forward and
    `banded_backward`, against `jax.vjp` of `banded_corr_argmax` (Pallas in
    interpret mode, its custom VJP `_banded_bwd`). 'sharp' searches a
    second map; 'self' the query map transposed and flipped, as
    `transfer` builds it, so both cotangents reach the one map."""
    import speinet_tpu.ops.pallas_corr as pc

    rng = np.random.default_rng(11 + shape[1])
    b, c = 2, 8
    h, w = shape
    f = rng.standard_normal((b, h, w, c)).astype(np.float32)
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    inv = (1.0 / (1.0 + rng.random((b, h * w)))).astype(np.float32)
    if routing == "sharp":
        args = (f, g, inv)
        j_fn = pc.banded_corr_argmax
        fn = kernels.banded_corr_argmax
    else:
        args = (f, inv)
        j_fn = lambda a, i: pc.banded_corr_argmax(
            a, jnp.flip(a.transpose(0, 2, 1, 3), 1), i)
        fn = lambda a, i: kernels.banded_corr_argmax(
            a, torch.flip(a.transpose(1, 2), dims=(1,)).contiguous(), i)
    (s, idx), vjp = jax.vjp(j_fn, *map(jnp.asarray, args))
    gs = _ct(np.asarray(s))
    want = vjp((jnp.asarray(gs), _no_ct(idx)))
    ts = [_t(a, grad=True) for a in args]
    s_t, idx_t = fn(*ts)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx))
    np.testing.assert_allclose(s_t.detach().numpy(), np.asarray(s), **TOL)
    assert not idx_t.requires_grad
    s_t.backward(_t(gs))
    for t, wnt in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wnt), **TOL)


# --- K10 row_gather and the gather-fold ----------------------------------------

def test_row_gather_vjp_matches_take_along_axis():
    """Repeated indices accumulate in the scatter-add."""
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((2, 13, 24)).astype(np.float32)
    idx = rng.integers(0, 5, (2, 40)).astype(np.int32)     # many repeats
    out, vjp = jax.vjp(lambda r: jnp.take_along_axis(r, jnp.asarray(idx)[..., None],
                                                     axis=1), jnp.asarray(rows))
    g = _ct(np.asarray(out))
    (want,) = vjp(jnp.asarray(g))
    rt = _t(rows, grad=True)
    got = kernels.row_gather(rt, _t(idx))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    got.backward(_t(g))
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(want), **TOL)


def test_gather_fold3_vjp_matches_jax():
    """The three texture scales' cotangents into the sharp pyramid, through
    the tile rows, the concatenation, the K10 gather and the 9-row folds."""
    from speinet_tpu.ops.patch_ops import gather_fold3_nhwc as j_gf3

    rng = np.random.default_rng(5)
    b, h, w, c = 2, 5, 6, 4
    refs = [rng.standard_normal((b, s * h, s * w, cc)).astype(np.float32)
            for s, cc in ((4, c), (2, 2 * c), (1, 4 * c))]
    index = rng.integers(0, h * w, (b, h * w)).astype(np.int32)
    outs, vjp = jax.vjp(lambda *r: j_gf3(*r, jnp.asarray(index)),
                        *map(jnp.asarray, refs))
    gs = [_ct(np.asarray(o)) for o in outs]
    want = vjp(tuple(map(jnp.asarray, gs)))
    ts = [_t(r, grad=True) for r in refs]
    got = gather_fold3_nhwc(*ts, _t(index))
    for g, o in zip(got, outs):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(o), **TOL)
    torch.autograd.backward(got, [_t(g) for g in gs])
    for t, wnt in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wnt), **TOL)


# --- training forms of the modules ---------------------------------------------

def test_resblock_train_matches_flax(shared):  # noqa: F811
    """Batch statistics in both gates, the flax update of their running
    statistics (momentum 0.99, biased variance), and the input gradient."""
    variables, port = shared
    x = np.random.default_rng(20).standard_normal((3, 12, 16, 16)).astype(np.float32)
    v = _sub(variables, "recons_net", "enc1_res", "res1")
    jb = JResBlock(16)
    out, vjp, mutated = jax.vjp(
        lambda a: jb.apply(v, a, train=True, mutable=["batch_stats"]),
        jnp.asarray(x), has_aux=True)
    g = _ct(np.asarray(out))
    (want_dx,) = vjp(jnp.asarray(g))
    blk = copy.deepcopy(port.recons_net.encoder_first[2])
    xt = _t(x, grad=True)
    got = blk(xt, F32, train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=1e-4, atol=1e-4)
    got.backward(_t(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), rtol=1e-4, atol=1e-4)
    stats = mutated["batch_stats"]["te"]
    for gate in ("cw", "hc"):
        bn = getattr(blk.te, gate).conv.bn
        want = stats[gate]["BatchNorm_0"]
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(want["mean"]),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(want["var"]),
                                   rtol=1e-5, atol=1e-7)
        assert int(bn.num_batches_tracked) == 1


@pytest.mark.parametrize("h,w", [(10, 10), (12, 16)])
def test_swin_train_matches_flax(shared, h, w):  # noqa: F811
    """The XLA block with drop_path_rate 0 (window-aligned, and padded +
    masked), forward and both input gradients, against the flax module with
    deterministic=False; the rolls go through K3's plain path."""
    variables, port = shared
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, h, w, 32)).astype(np.float32)
    y = rng.standard_normal((2, h, w, 32)).astype(np.float32)
    js = JSwin(embed_dim=32, depths=(2,), num_heads=(4,), window_size=5,
               mlp_ratio=2.0, drop_path_rate=0.0)
    v = _sub(variables, "swin")
    out, vjp = jax.vjp(lambda a, b: js.apply(v, a, b, deterministic=False,
                                             rngs={"droppath": jax.random.PRNGKey(0)}),
                       jnp.asarray(x), jnp.asarray(y))
    g = _ct(np.asarray(out))
    want = vjp(jnp.asarray(g))
    swin = copy.deepcopy(port.swin)
    swin.drop_rates = [0.0] * len(swin.drop_rates)
    xt, yt = _t(x, grad=True), _t(y, grad=True)
    got = swin(xt, yt, F32, train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=1e-4, atol=1e-4)
    got.backward(_t(g))
    for t, wnt in zip((xt, yt), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wnt), rtol=1e-4, atol=1e-4)


def test_drop_path_masks():
    """Per-sample: a dropped sample is zero, a kept one scaled by 1/(1-rate);
    rate-0 blocks draw nothing; the masks come from the generator."""
    x = torch.ones((4, 3, 2))
    keep = torch.tensor([True, False, True, False])
    out = drop_path(x, keep, 0.2)
    assert torch.equal(out[1], torch.zeros((3, 2))) and torch.allclose(out[0], x[0] / 0.8)
    assert drop_path(x, None, 0.2) is x
    from speinet_tpu_torch.models.swinir import SwinIRCross

    swin = SwinIRCross(8, embed_dim=16, depths=(2, 2), num_heads=(2, 2),
                       drop_path_rate=0.3)
    draws = [swin.draw_drops(64, torch.device("cpu"), torch.Generator().manual_seed(s))
             for s in (0, 0, 1)]
    assert draws[0][0][0] is None                       # rate 0 at the first block
    rate, keep = draws[0][1][1]
    assert rate == pytest.approx(0.3) and keep.shape == (2, 64) and keep.dtype == torch.bool
    assert 0.3 < keep.float().mean() < 0.95
    assert torch.equal(draws[0][1][1][1], draws[1][1][1][1])
    assert not torch.equal(draws[0][1][1][1], draws[2][1][1][1])


# --- loss, schedule, optimizer ---------------------------------------------------

def test_hem_takes_the_jax_draw():
    """Fed the uniform draw JAX makes from its key, hem_mask gives the same
    mask (top half of the residual, exactly 10% random) and HEM the same
    loss; an unknown loss type raises, and a GAN spec raises without the
    discriminator state (the plugins: tests/test_torch_loss_plugins.py)."""
    rng = np.random.default_rng(6)
    x = rng.random((2, 3, 10, 12)).astype(np.float32)
    y = rng.random((2, 3, 10, 12)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(j_hem_mask(jnp.asarray(x), jnp.asarray(y), key))
    u = np.asarray(jax.random.uniform(key, (2, 120)))
    got = hem_mask(_t(x), _t(y), _t(u)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.shape == (2, 1, 10, 12)
    np.testing.assert_allclose(
        hem_loss(_t(x), _t(y), _t(u)).item(),
        float(j_hem_loss(jnp.asarray(x), jnp.asarray(y), key)), rtol=1e-6)
    lc = LossComputer("1*L1+2*HEM")
    assert lc.names == ["L1", "HEM", "Total"]
    total, comps = lc(_t(x), _t(y), torch.Generator().manual_seed(0))
    assert torch.allclose(total, comps["L1"] + comps["HEM"])
    with pytest.raises(NotImplementedError, match="not found"):
        LossComputer("1*L1+1*SSIM")
    with pytest.raises(ValueError, match="discriminator state"):
        LossComputer("1*L1+0.1*GAN")(_t(x), _t(y))


def test_lr_for_epoch_matches_jax():
    """StepLR stepped at the top of each epoch: the decay lands one epoch
    early (epoch 150 already trains at half the rate)."""
    for lr, decay, gamma in ((1e-4, 150, 0.5), (5e-5, 200, 0.1)):
        cfg = Config(lr=lr, lr_decay=decay, gamma=gamma)
        jcfg = JConfig(lr=lr, lr_decay=decay, gamma=gamma)
        for e in range(1, 2 * decay + 3):
            assert lr_for_epoch(cfg, e) == j_lr_for_epoch(jcfg, e)
    assert lr_for_epoch(Config(), 149) == 1e-4 and lr_for_epoch(Config(), 150) == 5e-5


def test_adam_matches_optax_chain():
    """torch Adam with weight decay == add_decayed_weights, scale_by_adam,
    scale(-lr): three steps on the same gradients."""
    cfg = Config(lr=1e-3, weight_decay=1e-2)
    jcfg = JConfig(lr=1e-3, weight_decay=1e-2)
    rng = np.random.default_rng(7)
    p0 = rng.standard_normal((5, 6)).astype(np.float32)
    lin = torch.nn.Linear(6, 5, bias=False)
    with torch.no_grad():
        lin.weight.copy_(_t(p0))
    opt = make_optimizer(cfg, lin)
    tx = j_make_optimizer(jcfg)
    jp = jnp.asarray(p0)
    st = tx.init(jp)
    for _ in range(3):
        g = rng.standard_normal(p0.shape).astype(np.float32)
        lin.weight.grad = _t(g)
        opt.step()
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd * jcfg.lr)
    np.testing.assert_allclose(lin.weight.detach().numpy(), np.asarray(jp),
                               rtol=1e-6, atol=1e-7)


# --- kernels without a backward --------------------------------------------------

def _no_backward_calls():
    g = torch.Generator().manual_seed(0)
    x = torch.rand((1, 10, 10, 32), generator=g)
    c, hid = 32, 64
    wts = SwinBlockWeights(*[torch.rand(s, generator=g) for s in (
        (c,), (c,), (2 * c, c), (2 * c,), (c, c), (c,), (c, c), (c,), (4, 25, 25),
        (c,), (c,), (hid, c), (hid,), (c, hid), (c,))])
    w, b = torch.rand((3, 3, 32, 16), generator=g), torch.rand((16,), generator=g)
    return {
        "conv2d": (lambda t: kernels.conv2d(t, w, b), x),
        "swin_block": (lambda t: kernels.swin_block(t, t, wts, 5, 0, 0, 0, 4), x),
        "window_cross_attention": (
            lambda t: kernels.window_cross_attention(t, t, wts, 5, 0, 0, 0, 4), x),
        "ln_mlp": (lambda t: kernels.ln_mlp(t, wts), x.reshape(1, 100, 32)),
    }


@pytest.mark.parametrize("name", sorted(_no_backward_calls()))
def test_wrapper_without_backward_raises_under_grad(name):
    """A launch would return tensors without a gradient function, so the
    gradient would stop there without a word: the wrapper raises instead,
    naming the kernel, and runs as before where no gradient is needed."""
    fn, x = _no_backward_calls()[name]
    with pytest.raises(RuntimeError, match=f"^{name} has no backward"):
        fn(x.clone().requires_grad_(True))
    with torch.no_grad():
        fn(x.clone().requires_grad_(True))
    fn(x)
