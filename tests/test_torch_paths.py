"""The port's alternative kernel paths against speinet_tpu, on the CPU.

The JAX package chooses among its kernels by environment variable
(SPEINET_SWIN_FUSEBLOCK, SPEINET_CORR_RAW, SPEINET_CORR_BANDED,
SPEINET_CORR_SCALED); the port takes the same choices as arguments. Held
here, with the same numpy inputs from a seed on both sides:
- the plain versions of K6-K10 against the JAX package's Pallas kernels in
  interpret mode (and K7's against its XLA twin), float32, rtol/atol 1e-4;
- the split Swin block (K8 + K9) and the port's `transfer` under each
  switch setting against the flax modules with `_fused_enabled` patched to
  True and the switches set, so that they run those Pallas kernels;
- both new engine configurations against `speinet_tpu.infer.Inference`:
  per-frame PSNR within 0.01 dB and SSIM within 1e-4.
Nothing in the JAX package changes for this.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from speinet_tpu.config import Config as JConfig
from speinet_tpu.config import set_template as j_set_template
from speinet_tpu.infer import Inference as JInference
from speinet_tpu.models.search_transfer import TransferUnit as JTransfer
from speinet_tpu.models.search_transfer import correlation_argmax as j_corr_xla
from speinet_tpu_torch.config import Config, set_template
from speinet_tpu_torch.infer import Inference
from speinet_tpu_torch.kernels import (SwinBlockWeights, block_errors,
                                       block_errors_pass, correlation_argmax,
                                       correlation_argmax_ld_plain,
                                       correlation_argmax_lds_plain,
                                       correlation_argmax_plain, ln_mlp,
                                       ln_mlp_plain, row_gather, row_gather_plain,
                                       window_cross_attention_plain)
from speinet_tpu_torch.kernels.corr import scaled_reference
from speinet_tpu_torch.models.search_transfer import transfer
from speinet_tpu_torch.models.swinir import SwinBlock as TSwinBlock
from speinet_tpu_torch.models.swinir import relative_position_index
from speinet_tpu_torch.utils.convert import _swin_block, from_flax_params
from test_torch_engine import SMALL, _shared_weights, _tree
from test_torch_kernels import (_assert_idx_close, _flax_block,  # noqa: F401
                                _port_weights, interpret)
from test_torch_models import _sub, shared  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
F32 = torch.float32


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_corr_close(s, idx, s_ref, idx_ref, scores):
    """S to 1e-5 of its scale; an index may differ from the reference's only
    where it attains the maximum within that (scores [B, L, Lr])."""
    tol = 1e-5 * max(np.abs(s_ref).max(), 1.0)
    np.testing.assert_allclose(s, s_ref, rtol=0, atol=tol)
    at = np.take_along_axis(scores, idx[..., None].astype(np.int64), 2)[..., 0]
    _assert_idx_close(idx, idx_ref, at, s_ref, tol)


# --- K10 row_gather ---------------------------------------------------------

def test_row_gather_plain_matches_pallas(interpret):
    """Exact copies, int32 and int64 indices, through the wrapper too."""
    from speinet_tpu.ops.pallas_gather import row_gather as j_row_gather

    rng = np.random.default_rng(40)
    rows = rng.standard_normal((2, 21, 256)).astype(np.float32)
    idx = rng.integers(0, 21, (2, 36)).astype(np.int32)
    want = np.asarray(j_row_gather(jnp.asarray(rows), jnp.asarray(idx)))
    np.testing.assert_array_equal(want, np.take_along_axis(rows, idx[..., None], 1))
    for it in (torch.int32, torch.int64):
        got = row_gather_plain(_t(rows), _t(idx).to(it))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(row_gather(_t(rows), _t(idx).to(it)).numpy(), want)


# --- K6 correlation_argmax_ld -----------------------------------------------

def _raw_unfolds(seed, b=2, d=72, l=30, lr_len=37):
    rng = np.random.default_rng(seed)
    lr = rng.standard_normal((b, d, l)).astype(np.float32)
    ref = rng.standard_normal((b, d, lr_len)).astype(np.float32)
    inv = (1.0 / (1.0 + rng.random((b, lr_len)))).astype(np.float32)
    return lr, ref, inv


def test_corr_ld_plain_matches_pallas(interpret):
    """Against _corr_impl_ld on a host-scaled reference; Lr = 37 is no
    multiple of the 16-wide tiles, so the masked tail is exercised."""
    import speinet_tpu.ops.pallas_corr as pc

    lr, ref, inv = _raw_unfolds(41)
    scaled = ref * inv[:, None, :]
    s_j, i_j = pc._corr_impl_ld(jnp.asarray(lr), jnp.asarray(scaled), tl=16, tk=16)
    s, idx = correlation_argmax_ld_plain(_t(lr), _t(scaled))
    assert s.dtype == torch.float32 and idx.dtype == torch.int32
    _assert_corr_close(s.numpy(), idx.numpy(), np.asarray(s_j), np.asarray(i_j),
                       np.einsum("bdk,bdl->blk", scaled, lr))


def test_corr_ld_on_scaled_reference_equals_lds():
    """K6 on `scaled_reference(ref, inv)` is K5 on (ref, inv) bit for bit in
    bf16: the same rounded operands, the same loop."""
    lr, ref, inv = _raw_unfolds(42)
    lr_t, ref_t = _t(lr).bfloat16(), _t(ref).bfloat16()
    s5, i5 = correlation_argmax_lds_plain(lr_t, ref_t, _t(inv))
    s6, i6 = correlation_argmax_ld_plain(lr_t, scaled_reference(ref_t, _t(inv)))
    assert torch.equal(s5, s6) and torch.equal(i5, i6)


# --- K7 correlation_argmax --------------------------------------------------

def test_corr_plain_matches_pallas_and_xla(interpret):
    """Normalized operands, reference [B, Lr, D], against _corr_impl (the
    kernel's body in interpret mode) and the XLA correlation_argmax."""
    import speinet_tpu.ops.pallas_corr as pc

    lr, ref, _ = _raw_unfolds(43)
    lr_n = lr / np.linalg.norm(lr, axis=1, keepdims=True)
    ref_n = np.ascontiguousarray(
        (ref / np.linalg.norm(ref, axis=1, keepdims=True)).transpose(0, 2, 1))
    s, idx = correlation_argmax_plain(_t(lr_n), _t(ref_n))
    scores = np.einsum("bkd,bdl->blk", ref_n, lr_n)
    for s_j, i_j in (pc._corr_impl(jnp.asarray(lr_n), jnp.asarray(ref_n), tl=16, tk=16),
                     j_corr_xla(jnp.asarray(lr_n), jnp.asarray(ref_n), chunk=16)):
        _assert_corr_close(s.numpy(), idx.numpy(), np.asarray(s_j), np.asarray(i_j),
                           scores)
    s2, i2 = correlation_argmax(_t(lr_n), _t(ref_n))      # the wrapper, on the CPU
    assert torch.equal(s, s2) and torch.equal(idx, i2)


# --- K8 window_cross_attention ----------------------------------------------

@pytest.mark.parametrize("hp,wp,shift,pad_h,pad_w", [
    (10, 15, 0, 0, 0), (10, 15, 2, 0, 0), (10, 15, 2, 1, 2), (10, 20, 0, 3, 0)])
def test_window_attention_plain_matches_pallas(interpret, hp, wp, shift, pad_h, pad_w):
    from speinet_tpu.ops.pallas_swin import fused_window_cross_attention

    c, heads = 32, 4
    _, v, _, _ = _flax_block(c, heads, shift, 10, 10, seed=44)
    p = v["params"]
    rng = np.random.default_rng(45)
    x = rng.standard_normal((2, hp, wp, c)).astype(np.float32)
    y = rng.standard_normal((2, hp, wp, c)).astype(np.float32)
    wts = _port_weights(p, heads)
    got = window_cross_attention_plain(_t(x), _t(y), wts, 5, shift, pad_h, pad_w,
                                       heads)
    a = p["attn"]
    want = fused_window_cross_attention(
        jnp.asarray(x), jnp.asarray(y), p["norm1"]["scale"], p["norm1"]["bias"],
        a["qkv_x"]["kernel"], a["qkv_x"]["bias"], a["qkv_y"]["kernel"],
        a["qkv_y"]["bias"], a["proj"]["kernel"], a["proj"]["bias"],
        jnp.asarray(wts.relbias.numpy()), ws=5, shift=shift, pad_h=pad_h,
        pad_w=pad_w, heads=heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_window_attention_check_tells_rounding_from_faults():
    """block_errors_pass on the attention output (x = 0: the output is the
    update), the tolerance K8 is held to on the card, accepts another f32
    summation order and rejects a dropped relative-position bias or shift
    mask. bf16 at the template's widths, drawn as chip_smoke.py draws."""
    rng = np.random.default_rng(46)
    c, heads = 256, 8
    bf = lambda a: _t(np.asarray(a, np.float32)).to(torch.bfloat16)
    f32 = lambda a: _t(np.asarray(a, np.float32))
    mat = lambda o, i: bf(rng.uniform(-1, 1, (o, i)) * i ** -0.5)
    vec = lambda n, lo, hi: f32(rng.uniform(lo, hi, n))
    table = f32(rng.uniform(-0.1, 0.1, (81, heads)))
    rel = table[_t(relative_position_index(5, 5).reshape(-1))].reshape(
        25, 25, heads).permute(2, 0, 1).contiguous()
    none = torch.zeros(1)
    w = SwinBlockWeights(vec(c, 0.8, 1.2), vec(c, -0.1, 0.1), mat(2 * c, c),
                         vec(2 * c, -0.1, 0.1), mat(c, c), vec(c, -0.1, 0.1),
                         mat(c, c), vec(c, -0.1, 0.1), rel, *[none] * 6)
    x = bf(rng.standard_normal((1, 20, 30, c)))
    y = bf(rng.standard_normal((1, 20, 30, c)))
    ref = window_cross_attention_plain(x, y, w, 5, 2, 0, 0, heads)
    zero = torch.zeros_like(ref)
    p = _t(rng.permutation(c))
    inv = torch.argsort(p)
    wp = w._replace(ln1_w=w.ln1_w[p], ln1_b=w.ln1_b[p], wkv=w.wkv[:, p].contiguous(),
                    wq=w.wq[:, p].contiguous(), wp=w.wp[p].contiguous(), bp=w.bp[p])
    reordered = window_cross_attention_plain(x[..., p].contiguous(),
                                             y[..., p].contiguous(), wp, 5, 2, 0, 0,
                                             heads)[..., inv]
    assert block_errors_pass(block_errors(reordered, ref, zero))
    for fault in (window_cross_attention_plain(
            x, y, w._replace(relbias=torch.zeros_like(rel)), 5, 2, 0, 0, heads),
            window_cross_attention_plain(x, y, w, 5, 0, 0, 0, heads)):
        e = block_errors(fault, ref, zero)
        assert not block_errors_pass(e), e


# --- K9 ln_mlp --------------------------------------------------------------

def test_ln_mlp_plain_matches_pallas(interpret):
    """37 rows per sample: no multiple of the Pallas kernel's 16-row tile."""
    from speinet_tpu.ops.pallas_swin import fused_ln_mlp

    c, heads = 32, 4
    _, v, _, _ = _flax_block(c, heads, 0, 10, 10, seed=47)
    p = v["params"]
    x = np.random.default_rng(48).standard_normal((2, 37, c)).astype(np.float32)
    want = fused_ln_mlp(jnp.asarray(x), p["norm2"]["scale"], p["norm2"]["bias"],
                        p["mlp_fc1"]["kernel"], p["mlp_fc1"]["bias"],
                        p["mlp_fc2"]["kernel"], p["mlp_fc2"]["bias"], tl=16)
    wts = _port_weights(p, heads)
    got = ln_mlp_plain(_t(x), wts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(ln_mlp(_t(x), wts), got)


# --- the split Swin block -----------------------------------------------------

@pytest.mark.parametrize("h,w,shift", [(10, 15, 0), (10, 15, 2), (9, 13, 2)])
def test_split_swin_block_matches_flax(monkeypatch, interpret, h, w, shift):
    """SwinBlock(fuse_block=False) (K8, residual add, K9; plain) against the
    flax block's K8 + K9 path (SPEINET_SWIN_FUSEBLOCK=0), aligned and padded."""
    import speinet_tpu.models.swinir as swinir_mod

    c, heads = 32, 4
    block, v, x, y = _flax_block(c, heads, shift, h, w, seed=49)
    monkeypatch.setattr(swinir_mod, "_fused_enabled", lambda: True)
    monkeypatch.setenv("SPEINET_SWIN_FUSEBLOCK", "0")
    want = jax.jit(block.apply, static_argnums=(3, 4))(
        v, jnp.asarray(x), jnp.asarray(y), (h, w), True)
    port = TSwinBlock(c, heads, 5, shift, 2.0, fuse_block=False)
    sd = {}
    _swin_block(sd, "b", v["params"], None)
    port.load_state_dict({k[2:]: t for k, t in sd.items()}, strict=True)
    with torch.no_grad():
        got = port(_t(x), _t(y), (h, w), F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --- the correlation switches -----------------------------------------------

SWITCHES = {
    "raw_banded": dict(corr_raw=True, corr_banded=True, corr_scaled=True),
    "unfold_scaled": dict(corr_raw=True, corr_banded=False, corr_scaled=True),
    "unfold_prescaled": dict(corr_raw=True, corr_banded=False, corr_scaled=False),
    "normalized": dict(corr_raw=False, corr_banded=True, corr_scaled=True),
}


@pytest.mark.parametrize("routing", ["sharp", "self", "mixed"])
@pytest.mark.parametrize("name", list(SWITCHES))
def test_transfer_switches_match_flax(shared, monkeypatch, interpret, name, routing):
    """The port's transfer (K4-K7 plain) against TransferUnit with the same
    switches on its kernel path: K4, K5, K6 or K7 in interpret mode, 16-wide
    tiles so the reference spans several. 'mixed': sample 0 sharp, 1 self."""
    import speinet_tpu.models.swinir as swinir_mod

    paths = SWITCHES[name]
    monkeypatch.setattr(swinir_mod, "_fused_enabled", lambda: True)
    for env, key in (("SPEINET_CORR_RAW", "corr_raw"),
                     ("SPEINET_CORR_BANDED", "corr_banded"),
                     ("SPEINET_CORR_SCALED", "corr_scaled")):
        monkeypatch.setenv(env, "1" if paths[key] else "0")
    for env in ("SPEINET_CORR_TL", "SPEINET_CORR_TK"):
        monkeypatch.setenv(env, "16")
    variables, port = shared
    rng = np.random.default_rng(50)
    b, h, w, f = 2, 6, 8, 8
    ff = rng.standard_normal((b, h, w, 4 * f)).astype(np.float32)
    lv1 = rng.standard_normal((b, 4 * h, 4 * w, f)).astype(np.float32)
    lv2 = rng.standard_normal((b, 2 * h, 2 * w, 2 * f)).astype(np.float32)
    lv3 = rng.standard_normal((b, h, w, 4 * f)).astype(np.float32)
    hs = np.array([True, False]) if routing == "mixed" else np.array(
        [routing == "sharp"] * b)
    apply = jax.jit(lambda v, *a: JTransfer(n_feat=f).apply(v, *a, routing=routing))
    want = apply(_sub(variables, "transfer"), *map(jnp.asarray, (ff, lv1, lv2, lv3)),
                 jnp.asarray(hs))
    with torch.no_grad():
        got = transfer(port.SelfTransfer, *map(_t, (ff, lv1, lv2, lv3)), routing,
                       F32, has_sharp=torch.from_numpy(hs), **paths)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **TOL)


# --- the engines --------------------------------------------------------------

N_FRAMES = 11


def _labels():
    labels = np.zeros(N_FRAMES, np.int64)
    labels[[0, N_FRAMES - 1]] = 1
    return labels


@pytest.fixture(scope="module")
def jax_engine(tmp_path_factory):
    """The JAX cached engine's run of an 11-frame 40x40 tree (sharp labels
    at 0 and 10: sharp, mixed and self chunks at 2 windows per chunk), and
    the port's weights. On the JAX CPU backend the switches do not change the JAX
    program (`_fused_enabled` is False there): its correlation is the
    normalized branch, which corr_raw=False ports directly, and its Swin
    block the unfused one, whose math the split block follows."""
    tmp = tmp_path_factory.mktemp("paths")
    root = _tree(tmp / "ds", N_FRAMES, _labels(), h=40, w=40)
    params, bstats = _shared_weights()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JInference, "_load_weights", lambda self, path: (params, bstats))
        cfg = j_set_template(JConfig(template="SPEINet")).replace(dp_devices=1,
                                                                  **SMALL)
        inf = JInference(cfg, str(root), model_path="",
                         result_path=str(tmp / "res_jax"), save_image=False,
                         batch_windows=2, cache_pyramids=True)
        inf.infer()
    pt = tmp / "port.pt"
    torch.save(from_flax_params(params, bstats, depths=(2,)), pt)
    return root, pt, inf


@pytest.mark.parametrize("paths", [
    dict(swin_fuse_block=False, corr_raw=False),
    dict(corr_banded=False, corr_scaled=False)], ids=["split", "prescaled"])
def test_engine_paths_match_jax_engine(jax_engine, tmp_path, paths):
    """The cached engine with the `split` and `prescaled` configurations of
    chip_smoke.py, through 'sharp', 'self' and 'mixed' restores."""
    root, pt, inf_j = jax_engine
    cfg = set_template(Config(template="SPEINet")).replace(**SMALL)
    inf = Inference(cfg, str(root), model_path=str(pt),
                    result_path=str(tmp_path / "res"), save_image=False,
                    batch_windows=2, cache_pyramids=True, device="cpu", **paths)
    routings = []
    orig = inf.model.restore_from_features
    inf.model.restore_from_features = lambda *a: routings.append(a[5]) or orig(*a)
    inf.infer()
    inf.close()
    assert {"sharp", "self", "mixed"} <= set(routings), routings
    np.testing.assert_allclose(inf.total_psnr["video00"], inf_j.total_psnr["video00"],
                               rtol=0, atol=0.01)
    np.testing.assert_allclose(inf.total_ssim["video00"], inf_j.total_ssim["video00"],
                               rtol=0, atol=1e-4)
