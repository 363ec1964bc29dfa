"""The plain versions of the port's kernels K1-K5 against the JAX package's
Pallas kernels (interpret mode) and against its XLA paths, on the CPU.

Same numpy inputs from a seed on both sides, float32; rtol/atol 1e-4
unless a case states why it needs more. The CUDA kernels themselves are
held against these plain versions on the card (chip_smoke.py,
tests/test_torch_cuda.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from speinet_tpu.models.search_transfer import correlation_argmax
from speinet_tpu.ops.patch_ops import unfold
from speinet_tpu_torch.kernels import corr as kc
from speinet_tpu_torch.kernels import (SwinBlockWeights, banded_corr_argmax_plain,
                                       block_errors, block_errors_pass,
                                       conv2d_plain, correlation_argmax_lds_plain,
                                       roll2d_plain, swin_block_plain)
from speinet_tpu_torch.models.swinir import SwinBlock as TSwinBlock
from speinet_tpu_torch.models.swinir import relative_position_index
from speinet_tpu_torch.utils.convert import _swin_block

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def interpret(monkeypatch):
    """Every pallas_call runs in interpret mode (as the JAX tests run them)."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        k.pop("compiler_params", None)
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _t(a):
    return torch.from_numpy(np.array(a))


# --- K1 conv2d --------------------------------------------------------------

@pytest.mark.parametrize("k,relu", [(5, True), (3, False)])
def test_conv_plain_matches_pallas_and_xla(interpret, k, relu):
    from speinet_tpu.ops.pallas_conv import conv2d_mxu

    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 12, 16, 8)).astype(np.float32)
    w = (rng.standard_normal((k, k, 8, 16)) / (k * np.sqrt(8))).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    got = conv2d_plain(_t(x), _t(w), _t(b), relu=relu).numpy()
    pallas = conv2d_mxu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu=relu,
                        kcat=k == 3)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    xla = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), [(k // 2, k // 2)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    xla = jnp.maximum(xla, 0.0) if relu else xla
    np.testing.assert_allclose(got, np.asarray(xla), **TOL)


@pytest.mark.parametrize("cin", [3, 8])
def test_conv_plain_stride2_matches_xla(cin):
    """Stride 2 (the encoder's downsampling convs): the Pallas kernel only
    reaches it through space-to-depth, so the reference is the XLA conv."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 12, 20, cin)).astype(np.float32)
    w = (rng.standard_normal((5, 5, cin, 16)) / 10).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    got = conv2d_plain(_t(x), _t(w), _t(b), relu=True, stride=2).numpy()
    xla = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), [(2, 2)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    assert got.shape == (2, 6, 10, 16)
    np.testing.assert_allclose(got, np.maximum(np.asarray(xla), 0.0), **TOL)


# --- K3 roll2d --------------------------------------------------------------

@pytest.mark.parametrize("sh,sw", [(2, 2), (-2, -2), (3, 0)])
def test_roll_plain_matches_pallas_and_jnp(sh, sw):
    from speinet_tpu.ops.pallas_roll import roll2d

    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 10, 16, 128)).astype(np.float32)
    got = roll2d_plain(_t(x), sh % 10, sw % 16).numpy()
    np.testing.assert_array_equal(got, np.asarray(roll2d(jnp.asarray(x), sh, sw, True)))
    np.testing.assert_array_equal(got, np.asarray(jnp.roll(x, (-sh, -sw), (1, 2))))


# --- K2 swin_block ----------------------------------------------------------

def _flax_block(c, heads, shift, h, w, seed):
    from speinet_tpu.models.swinir import SwinBlock

    block = SwinBlock(dim=c, num_heads=heads, window_size=5, shift_size=shift,
                      mlp_ratio=2.0)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, h * w, c)).astype(np.float32)
    y = rng.standard_normal((2, h * w, c)).astype(np.float32)
    variables = block.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                           jnp.asarray(y), (h, w), True)
    # non-trivial LayerNorm / bias values
    p = jax.tree_util.tree_map(np.asarray, variables["params"])
    for ln in ("norm1", "norm2"):
        p[ln]["scale"] = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
        p[ln]["bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
    for d in (p["attn"]["qkv_x"], p["attn"]["qkv_y"], p["attn"]["proj"],
              p["mlp_fc1"], p["mlp_fc2"]):
        d["bias"] = (0.1 * rng.standard_normal(d["bias"].shape)).astype(np.float32)
    return block, {"params": p}, x, y


def _port_weights(p, heads, ws=5) -> SwinBlockWeights:
    f = lambda a: _t(np.ascontiguousarray(a, dtype=np.float32))
    table = f(p["attn"]["relative_position_bias_table"])
    n = ws * ws
    relbias = table[_t(relative_position_index(ws, ws).reshape(-1))].reshape(
        n, n, heads).permute(2, 0, 1).contiguous()
    return SwinBlockWeights(
        f(p["norm1"]["scale"]), f(p["norm1"]["bias"]),
        f(p["attn"]["qkv_x"]["kernel"].T), f(p["attn"]["qkv_x"]["bias"]),
        f(p["attn"]["qkv_y"]["kernel"].T), f(p["attn"]["qkv_y"]["bias"]),
        f(p["attn"]["proj"]["kernel"].T), f(p["attn"]["proj"]["bias"]), relbias,
        f(p["norm2"]["scale"]), f(p["norm2"]["bias"]),
        f(p["mlp_fc1"]["kernel"].T), f(p["mlp_fc1"]["bias"]),
        f(p["mlp_fc2"]["kernel"].T), f(p["mlp_fc2"]["bias"]))


@pytest.mark.parametrize("hp,wp,shift,pad_h,pad_w", [
    (10, 15, 0, 0, 0), (10, 15, 2, 0, 0), (10, 15, 2, 1, 2), (10, 20, 0, 3, 0)])
def test_swin_plain_matches_pallas_block(interpret, hp, wp, shift, pad_h, pad_w):
    """K2's plain version against fused_swin_block on the same rolled /
    padded images (the mask comes from coordinates on both sides)."""
    from speinet_tpu.ops.pallas_swin import fused_swin_block

    c, heads = 32, 4
    _, v, _, _ = _flax_block(c, heads, shift, 10, 10, seed=13)
    p = v["params"]
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, hp, wp, c)).astype(np.float32)
    y = rng.standard_normal((2, hp, wp, c)).astype(np.float32)
    wts = _port_weights(p, heads)
    got = swin_block_plain(_t(x), _t(y), wts, 5, shift, pad_h, pad_w, heads).numpy()
    a = p["attn"]
    want = fused_swin_block(
        jnp.asarray(x), jnp.asarray(y), p["norm1"]["scale"], p["norm1"]["bias"],
        a["qkv_x"]["kernel"], a["qkv_x"]["bias"], a["qkv_y"]["kernel"],
        a["qkv_y"]["bias"], a["proj"]["kernel"], a["proj"]["bias"],
        jnp.asarray(wts.relbias.numpy()), p["norm2"]["scale"], p["norm2"]["bias"],
        p["mlp_fc1"]["kernel"], p["mlp_fc1"]["bias"], p["mlp_fc2"]["kernel"],
        p["mlp_fc2"]["bias"], ws=5, shift=shift, pad_h=pad_h, pad_w=pad_w,
        heads=heads)
    # the Pallas kernel's erf is a 1.5e-7 polynomial (pallas_swin.py:96)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("h,w,shift", [(10, 15, 0), (10, 15, 2), (9, 13, 2),
                                       (12, 16, 0)])
def test_swin_block_module_matches_xla_path(monkeypatch, h, w, shift):
    """The port's SwinBlock (K3 rolls + K2, plain) against the flax block's
    XLA path, aligned and padded sizes."""
    import speinet_tpu.models.swinir as swinir_mod

    monkeypatch.setattr(swinir_mod, "_fused_enabled", lambda: False)
    c, heads = 32, 4
    block, v, x, y = _flax_block(c, heads, shift, h, w, seed=15)
    want = block.apply(v, jnp.asarray(x), jnp.asarray(y), (h, w), True)
    port = TSwinBlock(c, heads, 5, shift, 2.0)
    sd = {}
    _swin_block(sd, "b", v["params"], None)
    port.load_state_dict({k[2:]: t for k, t in sd.items()}, strict=True)
    with torch.no_grad():     # K2 has no backward: its wrapper refuses grad mode
        got = port(_t(x), _t(y), (h, w), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shift,pad_h,pad_w", [(0, 0, 0), (2, 0, 0), (2, 3, 1)])
def test_swin_block_check_tells_rounding_from_faults(shift, pad_h, pad_w):
    """block_errors_pass, the tolerance K2 is held to on the card, accepts the
    plain block run in another f32 summation order (channels permuted) and
    rejects it with the relative-position bias or the shift / pad mask
    dropped. bf16 at the template's widths, drawn as chip_smoke.py draws."""
    rng = np.random.default_rng(21)
    c, hid, heads = 256, 512, 8
    bf = lambda a: _t(np.asarray(a, np.float32)).to(torch.bfloat16)
    f32 = lambda a: _t(np.asarray(a, np.float32))
    mat = lambda o, i: bf(rng.uniform(-1, 1, (o, i)) * i ** -0.5)
    vec = lambda n, lo, hi: f32(rng.uniform(lo, hi, n))
    table = f32(rng.uniform(-0.1, 0.1, (81, heads)))
    rel = table[_t(relative_position_index(5, 5).reshape(-1))].reshape(
        25, 25, heads).permute(2, 0, 1).contiguous()
    w = SwinBlockWeights(
        vec(c, 0.8, 1.2), vec(c, -0.1, 0.1), mat(2 * c, c), vec(2 * c, -0.1, 0.1),
        mat(c, c), vec(c, -0.1, 0.1), mat(c, c), vec(c, -0.1, 0.1), rel,
        vec(c, 0.8, 1.2), vec(c, -0.1, 0.1), mat(hid, c), vec(hid, -0.1, 0.1),
        mat(c, hid), vec(c, -0.1, 0.1))
    x = bf(rng.standard_normal((1, 20, 30, c)))
    y = bf(rng.standard_normal((1, 20, 30, c)))
    ref = swin_block_plain(x, y, w, 5, shift, pad_h, pad_w, heads)

    p = _t(rng.permutation(c))
    inv = torch.argsort(p)
    wp = SwinBlockWeights(
        w.ln1_w[p], w.ln1_b[p], w.wkv[:, p].contiguous(), w.bkv,
        w.wq[:, p].contiguous(), w.bq, w.wp[p].contiguous(), w.bp[p], w.relbias,
        w.ln2_w[p], w.ln2_b[p], w.w1[:, p].contiguous(), w.b1,
        w.w2[p].contiguous(), w.b2[p])
    reordered = swin_block_plain(x[..., p].contiguous(), y[..., p].contiguous(), wp,
                                 5, shift, pad_h, pad_w, heads)[..., inv]
    e = block_errors(reordered, ref, x)
    assert block_errors_pass(e), e
    no_bias = swin_block_plain(x, y, w._replace(relbias=torch.zeros_like(rel)), 5,
                               shift, pad_h, pad_w, heads)
    e = block_errors(no_bias, ref, x)
    assert not block_errors_pass(e), e
    if shift or pad_h or pad_w:
        e = block_errors(swin_block_plain(x, y, w, 5, 0, 0, 0, heads), ref, x)
        assert not block_errors_pass(e), e


# --- K4 banded_corr_argmax --------------------------------------------------

def _corr_inputs(h, w, hr, wr, seed, c=8, b=2):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((b, h, w, c)).astype(np.float32)
    g = rng.standard_normal((b, hr, wr, c)).astype(np.float32)
    inv = (1.0 / (1.0 + rng.random((b, hr * wr)))).astype(np.float32)
    return f, g, inv


def _assert_idx_close(idx, idx_ref, scores_at, s_ref, tol):
    """Indices agree wherever the winner is unique within tol; elsewhere the
    port's index must attain the max within tol."""
    diff = idx != idx_ref
    if diff.any():
        np.testing.assert_allclose(scores_at[diff], s_ref[diff], rtol=0, atol=tol)


@pytest.mark.parametrize("shape", [((6, 7), (6, 7)), ((5, 9), (9, 5))])
def test_corr_plain_matches_pallas_banded(interpret, shape):
    import speinet_tpu.ops.pallas_corr as pc

    (h, w), (hr, wr) = shape
    f, g, inv = _corr_inputs(h, w, hr, wr, seed=16)
    s, idx = banded_corr_argmax_plain(_t(f), _t(g), _t(inv))
    s2, i2 = pc._corr_impl_banded(jnp.asarray(f), jnp.asarray(g), jnp.asarray(inv),
                                  tl=16, tk=16)
    np.testing.assert_allclose(s.numpy(), np.asarray(s2), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i2))
    assert idx.dtype == torch.int32


def _clipped_rows(x, start, n):
    """Rows start .. start + n - 1 of x [B, L, C] along its second axis,
    zero outside [0, L), as TMA's zero fill reads them."""
    idx = torch.arange(start, start + n)
    ok = ((idx >= 0) & (idx < x.shape[1])).to(x.dtype)
    return x[:, idx.clamp(0, x.shape[1] - 1)] * ok[None, :, None]


@pytest.mark.parametrize("h,w", [(3, 4), (5, 6), (4, 9)])
def test_banded_layout_matches_pallas_windows(h, w):
    """K4's padded flat map read at the slab origins the kernel uses
    (tile start + dy(W + 1) - 1) gives the JAX package's `_banded_windows`
    slabs."""
    import speinet_tpu.ops.pallas_corr as pc

    x = np.random.default_rng(20).standard_normal((2, h, w, 8)).astype(np.float32)
    t = 8
    win = np.asarray(pc._banded_windows(jnp.asarray(x), t, jnp.float32))
    flat = kc.banded_layout(_t(x))
    rows = h + 2 + (h + 2) * (w + 1) % 2      # a second zero row below if odd
    assert flat.shape == (2, rows * (w + 1), 8) and flat.shape[1] % 2 == 0
    for k in range(win.shape[1]):
        for dy in range(3):
            slab = _clipped_rows(flat, k * t + dy * (w + 1) - 1, t + 2)
            np.testing.assert_array_equal(slab.numpy().transpose(0, 2, 1),
                                          win[:, k, dy])


@pytest.mark.parametrize("hr,wr", [(3, 4), (9, 5), (1, 1), (7, 300)])
def test_banded_aux_matches_pallas_aux(hr, wr):
    """K4's (inv, mask) rows against `_banded_aux`'s mask and the inverse
    norms `_corr_impl_banded` scatters into the padded layout; the two
    halo columns of every tile are masked too."""
    import speinet_tpu.ops.pallas_corr as pc

    inv = np.random.default_rng(21).random((2, hr * wr)).astype(np.float32) + 0.5
    n_kt = kc.banded_plan(hr, wr)
    aux = kc.banded_aux(_t(inv), hr, wr, n_kt).numpy()
    assert aux.shape == (2, n_kt, kc.BANDED_TK, 2) and aux.dtype == np.float32
    assert np.isneginf(aux[:, :, kc.BANDED_TKV:, 1]).all()
    kp = n_kt * kc.BANDED_TKV
    mask = pc._banded_aux(hr, wr, kp)[0, :, 0]
    inv_p = np.pad(inv.reshape(2, hr, wr), ((0, 0), (0, 0), (0, 1))).reshape(2, -1)
    inv_p = np.pad(inv_p, ((0, 0), (0, kp - inv_p.shape[1])))
    got = aux[:, :, :kc.BANDED_TKV].reshape(2, kp, 2)
    valid = mask == 0
    np.testing.assert_array_equal(np.isneginf(got[..., 1]), np.broadcast_to(~valid, (2, kp)))
    np.testing.assert_array_equal(got[:, valid, 0], inv_p[:, valid])
    assert (got[:, valid, 1] == 0).all() and (got[:, ~valid, 0] == 0).all()


@pytest.mark.parametrize("h,w,hr,wr", [(1, 1, 1, 1), (180, 320, 320, 180),
                                       (2, 200, 3, 90), (12, 25, 11, 24)])
def test_banded_plan_covers_the_maps(h, w, hr, wr):
    """The fewest reference tiles that cover the reference's flat
    positions, however large the query."""
    n_kt = kc.banded_plan(hr, wr)
    lk = hr * (wr + 1)
    assert (n_kt - 1) * kc.BANDED_TKV < lk <= n_kt * kc.BANDED_TKV
    assert isinstance(n_kt, int)


def _banded_tiled(f, g, inv):
    """K4's tiling and epilogue in plain torch: warps of 16 query rows 14
    apart (as many as cover the query's flat positions), reference tiles of 256 positions 254 apart, each read from
    `banded_layout` at tile start + dy(W + 1) - 1 with zero fill; Csum the
    three dy products, R its three diagonals over the 14 x 254 outputs,
    scaled and masked by `banded_aux`, the first maximum over ascending
    flat positions; then the query's pad column cropped and idx mapped
    back to row-major Hr x Wr."""
    b, h, w, _ = f.shape
    hr, wr = g.shape[1:3]
    n_kt = kc.banded_plan(hr, wr)
    fp, gp = kc.banded_layout(f), kc.banded_layout(g)
    aux = kc.banded_aux(inv, hr, wr, n_kt)
    n_w = -(-h * (w + 1) // 14)
    csum = 0
    for dy in range(3):
        a = torch.stack([_clipped_rows(fp, 14 * i + dy * (w + 1) - 1, 16)
                         for i in range(n_w)], 1)              # [B, n_w, 16, C]
        r = torch.stack([_clipped_rows(gp, kc.BANDED_TKV * k + dy * (wr + 1) - 1,
                                       kc.BANDED_TK) for k in range(n_kt)], 1)
        csum = csum + torch.einsum("bwic,bkjc->bwkij", a, r)   # [B, n_w, n_kt, 16, 256]
    tv = kc.BANDED_TKV
    rr = csum[..., :14, :tv] + csum[..., 1:15, 1:tv + 1] + csum[..., 2:16, 2:tv + 2]
    v = rr * aux[:, None, :, None, :tv, 0] + aux[:, None, :, None, :tv, 1]
    v = v.permute(0, 1, 3, 2, 4).reshape(b, n_w * 14, n_kt * tv)
    s, q = v.max(dim=2)                       # the first maximum
    keep = torch.arange(h * (w + 1)) % (w + 1) < w
    s, q = s[:, :h * (w + 1)][:, keep], q[:, :h * (w + 1)][:, keep]
    return s, (q // (wr + 1) * wr + q % (wr + 1)).to(torch.int32)


@pytest.mark.parametrize("shape", [((6, 7), (6, 7)), ((5, 9), (9, 5)),
                                   ((12, 25), (11, 24)), ((1, 2), (2, 1))])
def test_banded_tiling_matches_pallas_banded(interpret, shape):
    """The kernel's tile plan, layout, (inv, mask) rows, crop and index remap
    (`_banded_tiled`) against `_corr_impl_banded` in interpret mode and the
    plain version: several query tiles and reference tiles at 12 x 25
    against 11 x 24, maps of one or two pixels."""
    import speinet_tpu.ops.pallas_corr as pc

    (h, w), (hr, wr) = shape
    f, g, inv = _corr_inputs(h, w, hr, wr, seed=22)
    s, idx = _banded_tiled(_t(f), _t(g), _t(inv))
    s2, i2 = pc._corr_impl_banded(jnp.asarray(f), jnp.asarray(g), jnp.asarray(inv),
                                  tl=16, tk=16)
    np.testing.assert_allclose(s.numpy(), np.asarray(s2), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i2))
    s3, i3 = banded_corr_argmax_plain(_t(f), _t(g), _t(inv))
    np.testing.assert_allclose(s.numpy(), s3.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(idx.numpy(), i3.numpy())


@pytest.mark.parametrize("routing", ["sharp", "self"])
def test_corr_plain_matches_normalized_unfold_xla(routing):
    """Against the XLA twin, correlation_argmax on L2-normalized unfolds:
    S_xla = inv_lr * S_port, the argmax the same; the self reference is the
    transposed, flipped query map."""
    from speinet_tpu_torch.models.search_transfer import patch_inv_norms

    rng = np.random.default_rng(17)
    f = rng.standard_normal((2, 6, 8, 8)).astype(np.float32)
    g = (rng.standard_normal((2, 6, 8, 8)).astype(np.float32) if routing == "sharp"
         else np.ascontiguousarray(np.flip(f.transpose(0, 2, 1, 3), 1)))
    inv = patch_inv_norms(_t(g))
    s, idx = banded_corr_argmax_plain(_t(f), _t(g), inv)
    s = (s * patch_inv_norms(_t(f))).numpy()
    lr = unfold(jnp.asarray(f).transpose(0, 3, 1, 2), 3, 1, 1)
    rf = unfold(jnp.asarray(g).transpose(0, 3, 1, 2), 3, 1, 1)
    nrm = lambda u: u / jnp.maximum(jnp.linalg.norm(u, axis=1, keepdims=True), 1e-12)
    s_x, i_x = correlation_argmax(nrm(lr), nrm(rf).transpose(0, 2, 1), chunk=16)
    np.testing.assert_allclose(s, np.asarray(s_x), **TOL)
    cos = np.einsum("bdl,bdq->blq", np.asarray(nrm(lr)), np.asarray(nrm(rf)))
    at = np.take_along_axis(cos, idx.numpy()[..., None].astype(np.int64), 2)[..., 0]
    _assert_idx_close(idx.numpy(), np.asarray(i_x), at, np.asarray(s_x), 1e-5)


# --- K5 correlation_argmax_lds ----------------------------------------------

def _lds_inputs(seed, b=2, d=72, l=30, lr_len=37, pow2_inv=False):
    """Raw unfold-shaped operands; Lr = 37 is no multiple of the 16-wide
    reference tiles of the Pallas run, so its masked tail is exercised."""
    rng = np.random.default_rng(seed)
    lr = rng.standard_normal((b, d, l)).astype(np.float32)
    ref = rng.standard_normal((b, d, lr_len)).astype(np.float32)
    if pow2_inv:
        inv = (2.0 ** -rng.integers(0, 4, (b, lr_len))).astype(np.float32)
    else:
        inv = (1.0 / (1.0 + rng.random((b, lr_len)))).astype(np.float32)
    return lr, ref, inv


def _assert_lds_close(s, idx, lr, scaled, s_ref, idx_ref):
    """S to 1e-5 relative; an index may differ from the reference's only
    where it attains the maximum within that tolerance."""
    tol = 1e-5 * max(np.abs(s_ref).max(), 1.0)
    np.testing.assert_allclose(s, s_ref, rtol=0, atol=tol)
    scores = np.einsum("bdk,bdl->blk", scaled, lr)
    at = np.take_along_axis(scores, idx[..., None].astype(np.int64), 2)[..., 0]
    _assert_idx_close(idx, idx_ref, at, s_ref, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corr_lds_plain_matches_pallas(interpret, dtype):
    """Against _corr_impl_lds (the kernel's body in interpret mode). In bf16
    the scales are powers of two, so bf16(ref * inv) is exact: on the CPU,
    XLA drops the kernel's bf16 rounding of the scaled operand (it keeps
    the f32 product), which the TPU's MXU, taking a bf16 operand, cannot;
    the next test holds that rounding to the JAX package's own."""
    import speinet_tpu.ops.pallas_corr as pc

    lr, ref, inv = _lds_inputs(18, pow2_inv=dtype == "bfloat16")
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    lr_j, ref_j = jnp.asarray(lr).astype(jdt), jnp.asarray(ref).astype(jdt)
    s_j, i_j = pc._corr_impl_lds(lr_j, ref_j, jnp.asarray(inv), tl=16, tk=16)
    lr_t, ref_t = _t(lr).to(tdt), _t(ref).to(tdt)
    s, idx = correlation_argmax_lds_plain(lr_t, ref_t, _t(inv))
    assert s.dtype == torch.float32 and idx.dtype == torch.int32
    scaled = np.asarray(ref_j.astype(jnp.float32)) * inv[:, None, :]
    _assert_lds_close(s.numpy(), idx.numpy(), np.asarray(lr_j.astype(jnp.float32)),
                      scaled, np.asarray(s_j), np.asarray(i_j))


def test_corr_lds_plain_rounds_the_scaled_operand_like_the_tpu(interpret):
    """bf16 with general scales: the plain version rounds bf16(ref) *
    bf16(inv) to bf16 before the product, as the TPU kernel does
    (pallas_corr.py:163). The JAX package's twin that scales on the host,
    _corr_impl_ld on `ref * inv.astype(bf16)` (its SPEINET_CORR_SCALED=0
    path, documented bit-identical), is the reference."""
    import speinet_tpu.ops.pallas_corr as pc

    lr, ref, inv = _lds_inputs(19)
    lr_j = jnp.asarray(lr).astype(jnp.bfloat16)
    ref_j = jnp.asarray(ref).astype(jnp.bfloat16)
    scaled_j = ref_j * jnp.asarray(inv).astype(jnp.bfloat16)[:, None, :]
    s_j, i_j = pc._corr_impl_ld(lr_j, scaled_j, tl=16, tk=16)
    s, idx = correlation_argmax_lds_plain(_t(lr).bfloat16(), _t(ref).bfloat16(),
                                          _t(inv))
    _assert_lds_close(s.numpy(), idx.numpy(), np.asarray(lr_j.astype(jnp.float32)),
                      np.asarray(scaled_j.astype(jnp.float32)), np.asarray(s_j),
                      np.asarray(i_j))
