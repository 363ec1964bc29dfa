"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: they skip without a CUDA device (as on a CPU-only test
machine) and run on one with

    python -m pytest tests/test_torch_cuda.py -q -m cuda

bf16 operands at small shapes; each tolerance is stated with its reason.
chip_smoke.py repeats these checks at the 720p main-path shapes.
"""

import pytest
import torch

from speinet_tpu_torch import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _bf16(shape, g, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(torch.bfloat16)


@pytest.mark.parametrize("cin,co,k,stride,hw", [
    (3, 32, 5, 1, (20, 150)), (32, 32, 5, 1, (17, 130)), (32, 64, 5, 2, (20, 260)),
    (64, 32, 3, 1, (9, 40)), (128, 128, 5, 1, (10, 40)), (8, 16, 3, 2, (7, 9)),
    # widths off the 64-pixel tile, heights off the 2- or 4-row tile
    (32, 64, 5, 1, (23, 100)), (64, 128, 5, 2, (19, 131)),
    # Co 16 and 128, k 3 and 5, stride 2 on odd sizes, Cin 3
    (3, 16, 3, 2, (19, 37)), (16, 128, 3, 2, (21, 67)), (128, 128, 3, 1, (13, 70)),
    (3, 128, 5, 2, (11, 29)),
    # input channels in 48-wide slabs, and padded from 24 to 32
    (48, 16, 5, 1, (9, 75)), (24, 32, 3, 1, (6, 66)),
    # rows too wide to stage whole: input channels staged 64 at a time
    (256, 256, 5, 1, (9, 70)), (128, 256, 5, 2, (19, 131)),
    (320, 64, 5, 1, (7, 75)), (256, 128, 5, 2, (11, 67))])
def test_conv2d_kernel(gen, cin, co, k, stride, hw):
    x = _bf16((2, *hw, cin), gen)
    w = _bf16((k, k, cin, co), gen, (k * k * cin) ** -0.5)
    b = torch.randn((co,), generator=gen, device="cuda")
    kernels.reset_launches()
    out = kernels.conv2d(x, w, b, relu=True, stride=stride)
    assert kernels.LAUNCHES["conv2d"] == 1
    ref = kernels.conv2d_plain(x, w, b, relu=True, stride=stride)
    # one f32 sum rounded to bf16 on both sides: at most one bf16 step apart
    tol = 2.0 ** -7 * max(ref.float().abs().max().item(), 1.0)
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_roll2d_kernel(gen):
    x = _bf16((2, 15, 20, 256), gen)
    for sh, sw in ((2, 2), (-2, -2), (0, 3)):
        assert torch.equal(kernels.roll2d(x, sh, sw), kernels.roll2d_plain(
            x, sh % 15, sw % 20))
    odd = torch.randn((1, 5, 7, 3), generator=gen, device="cuda")   # 12-byte rows
    assert torch.equal(kernels.roll2d(odd, 1, 2), kernels.roll2d_plain(odd, 1, 2))


def _banded_score_at(f, g, inv):
    """score_at(bi, p, k) = inv[k] * R[p, k] in f32, from the unfolds."""
    import torch.nn.functional as F

    lu = F.unfold(f.permute(0, 3, 1, 2).float(), 3, padding=1)
    ru = F.unfold(g.permute(0, 3, 1, 2).float(), 3, padding=1)
    return lambda bi, p, k: (lu[bi, :, p] * ru[bi, :, k]).sum(1) * inv[bi, k]


@pytest.mark.parametrize("hw,ref_hw", [((12, 20), (12, 20)), ((9, 21), (21, 9))])
def test_banded_corr_kernel(gen, hw, ref_hw):
    f = _bf16((2, *hw, 128), gen)
    g = _bf16((2, *ref_hw, 128), gen)
    inv = torch.rand((2, ref_hw[0] * ref_hw[1]), generator=gen, device="cuda") + 0.5
    kernels.reset_launches()
    s, idx = kernels.banded_corr_argmax(f, g, inv)
    assert kernels.LAUNCHES["banded_corr_argmax"] == 1
    s_p, idx_p = kernels.banded_corr_argmax_plain(f, g, inv)
    _assert_corr_rule(s, idx, s_p, idx_p, _banded_score_at(f, g, inv))


@pytest.mark.parametrize("b,hw,ref_hw,c", [
    # the 'self' layout with H != W, three samples
    (3, (18, 32), (32, 18), 128),
    # maps of one pixel, one or two rows high or columns wide
    (1, (1, 1), (1, 1), 64), (2, (2, 70), (1, 300), 64), (1, (40, 2), (2, 40), 16),
    # exactly one query tile (112 flat positions) and one reference tile
    # (254), then one position more on each side
    (2, (1, 111), (1, 253), 64), (1, (1, 112), (1, 254), 16),
    # several tiles with ragged ends; C = 16, 64 (one chunk) and 256 (four)
    (1, (13, 17), (17, 13), 16), (2, (23, 40), (19, 45), 64),
    (2, (11, 20), (9, 28), 256), (1, (5, 6), (5, 6), 256)])
def test_banded_corr_kernel_shapes(gen, b, hw, ref_hw, c):
    """Negated queries against a positive reference: every score is
    negative, so the zero-filled pad column, the rows past the map and the
    tiles' halo columns would win if the mask let them."""
    f = -_bf16((b, *hw, c), gen).abs()
    g = _bf16((b, *ref_hw, c), gen).abs()
    inv = torch.rand((b, ref_hw[0] * ref_hw[1]), generator=gen, device="cuda") + 0.5
    kernels.reset_launches()
    s, idx = kernels.banded_corr_argmax(f, g, inv)
    assert kernels.LAUNCHES["banded_corr_argmax"] == 1
    s_p, idx_p = kernels.banded_corr_argmax_plain(f, g, inv)
    assert (s < 0).all() and (idx >= 0).all() and (idx < inv.shape[1]).all()
    _assert_corr_rule(s, idx, s_p, idx_p, _banded_score_at(f, g, inv))


@pytest.mark.parametrize("c", [64, 128, 256])
@pytest.mark.parametrize("routing", ["sharp", "self"])
def test_banded_corr_kernel_exact(gen, routing, c):
    """Integer maps in [-2, 2] repeating a 4 x 5 block, inv a power of two:
    every sum is an integer below 2^24 times a power of two, exact in f32
    in any order, so S equals the plain version's bit for bit; the repeated
    patches tie often, and idx must equal the plain version's first maximum
    in row-major order, across one, two and four 64-channel chunks."""
    b, h, w = 2, 23, 37
    block = torch.randint(-2, 3, (b, 4, 5, c), generator=gen, device="cuda")
    f = block.repeat(1, 6, 8, 1)[:, :h, :w].to(torch.bfloat16).contiguous()
    if routing == "sharp":
        other = torch.randint(-2, 3, (b, 4, 5, c), generator=gen, device="cuda")
        g = other.repeat(1, 5, 6, 1)[:, :19, :29].to(torch.bfloat16).contiguous()
    else:
        g = torch.flip(f.transpose(1, 2), dims=(1,)).contiguous()
    n = g.shape[1] * g.shape[2]
    inv = 2.0 ** -torch.randint(0, 2, (b, n), generator=gen, device="cuda").float()
    s, idx = kernels.banded_corr_argmax(f, g, inv)
    s_p, idx_p = kernels.banded_corr_argmax_plain(f, g, inv)
    assert torch.equal(s, s_p)
    assert torch.equal(idx, idx_p)
    # the case has ties to break: queries whose maximum is attained twice
    import torch.nn.functional as F

    lu = F.unfold(f[:1].permute(0, 3, 1, 2).float(), 3, padding=1)[0]
    ru = F.unfold(g[:1].permute(0, 3, 1, 2).float(), 3, padding=1)[0]
    scores = (ru.t() @ lu) * inv[0, :, None]        # [Lr, L], exact
    assert ((scores == s_p[0]).sum(0) > 1).sum().item() > h * w // 4


@pytest.mark.parametrize("h,w", [(180, 320), (95, 165)])
def test_corr_unfold_kernel(gen, h, w):
    """K5 on a mixed batch (sharp unfold, permuted self reference) at 720p
    lv3 and at a chop tile's lv3 (L = 15,675: padded to a multiple of 8)."""
    from speinet_tpu_torch.kernels.corr import scaled_reference
    from speinet_tpu_torch.models.search_transfer import (unfold_reference,
                                                          patch_inv_norms)

    f = torch.rand((2, h, w, 128), generator=gen, device="cuda").to(torch.bfloat16)
    sharp = torch.rand((2, h, w, 128), generator=gen, device="cuda").to(torch.bfloat16)
    hs = torch.tensor([True, False], device="cuda")
    lr, ref, inv = (t.contiguous() for t in
                    unfold_reference(f, sharp, "mixed", hs, patch_inv_norms(f)))
    kernels.reset_launches()
    s, idx = kernels.correlation_argmax_lds(lr, ref, inv)
    assert kernels.LAUNCHES["correlation_argmax_lds"] == 1
    s_p, idx_p = kernels.correlation_argmax_lds_plain(lr, ref, inv)
    # the same bf16 operands summed in f32 in another order
    tol = 1e-5 * max(s_p.abs().max().item(), 1.0)
    assert (s - s_p).abs().max().item() <= tol
    # an index may differ only where it attains the max within tol
    bi, p = (idx != idx_p).nonzero(as_tuple=True)
    if bi.numel():
        sc = scaled_reference(ref, inv)
        at_k = (lr[bi, :, p].float() * sc[bi, :, idx[bi, p].long()].float()).sum(1)
        assert (at_k - s_p[bi, p]).abs().max().item() <= tol


@pytest.mark.parametrize("shift,pad_h,pad_w", [(0, 0, 0), (2, 0, 0), (2, 3, 1)])
def test_swin_block_kernel(gen, shift, pad_h, pad_w):
    from speinet_tpu_torch.models.swinir import relative_position_index

    c, hid, heads = 256, 512, 8
    mat = lambda o, i: _bf16((o, i), gen, i ** -0.5)
    vec = lambda n, s: torch.randn((n,), generator=gen, device="cuda") * s
    table = vec(81 * heads, 0.1).reshape(81, heads)
    idx = torch.from_numpy(relative_position_index(5, 5).reshape(-1)).cuda()
    rel = table[idx].reshape(25, 25, heads).permute(2, 0, 1).contiguous()
    wts = kernels.SwinBlockWeights(
        1 + vec(c, 0.1), vec(c, 0.1), mat(2 * c, c), vec(2 * c, 0.1), mat(c, c),
        vec(c, 0.1), mat(c, c), vec(c, 0.1), rel, 1 + vec(c, 0.1), vec(c, 0.1),
        mat(hid, c), vec(hid, 0.1), mat(c, hid), vec(c, 0.1))
    x = _bf16((3, 10, 15, c), gen)        # 3 x 6 windows: a ragged last CTA
    y = _bf16((3, 10, 15, c), gen)
    out = kernels.swin_block(x, y, wts, 5, shift, pad_h, pad_w, heads)
    ref = kernels.swin_block_plain(x, y, wts, 5, shift, pad_h, pad_w, heads)
    # held to the block's update, not its output (kernels/swin.py)
    e = kernels.block_errors(out, ref, x)
    assert kernels.block_errors_pass(e), e


@pytest.mark.parametrize("c,heads,hid,shape", [
    (256, 8, 512, (1, 5, 35)),      # 7 windows: one full CTA and one of 2
    (64, 2, 128, (2, 10, 15)),      # C = 64: the 64-column layout
    (96, 3, 192, (1, 15, 10)),      # C = 96, padded to 128 columns
    (64, 2, 128, (1, 5, 5))])       # a single window
def test_swin_block_kernel_widths(gen, c, heads, hid, shape):
    wts = _swin_weights(gen, c, hid, heads)
    for shift, pad in ((0, 0), (2, 1)):
        x = _bf16((*shape, c), gen)
        y = _bf16((*shape, c), gen)
        kernels.reset_launches()
        out = kernels.swin_block(x, y, wts, 5, shift, pad, pad, heads)
        assert kernels.LAUNCHES["swin_block"] == 1
        ref = kernels.swin_block_plain(x, y, wts, 5, shift, pad, pad, heads)
        # held to the block's update, not its output (kernels/swin.py)
        e = kernels.block_errors(out, ref, x)
        assert kernels.block_errors_pass(e), (shift, e)


def _swin_weights(gen, c=256, hid=512, heads=8):
    from speinet_tpu_torch.models.swinir import relative_position_index

    mat = lambda o, i: _bf16((o, i), gen, i ** -0.5)
    vec = lambda n, s: torch.randn((n,), generator=gen, device="cuda") * s
    table = vec(81 * heads, 0.1).reshape(81, heads)
    idx = torch.from_numpy(relative_position_index(5, 5).reshape(-1)).cuda()
    rel = table[idx].reshape(25, 25, heads).permute(2, 0, 1).contiguous()
    return kernels.SwinBlockWeights(
        1 + vec(c, 0.1), vec(c, 0.1), mat(2 * c, c), vec(2 * c, 0.1), mat(c, c),
        vec(c, 0.1), mat(c, c), vec(c, 0.1), rel, 1 + vec(c, 0.1), vec(c, 0.1),
        mat(hid, c), vec(hid, 0.1), mat(c, hid), vec(c, 0.1))


@pytest.mark.parametrize("shift,pad_h,pad_w", [(0, 0, 0), (2, 0, 0), (2, 3, 1)])
def test_window_cross_attention_kernel(gen, shift, pad_h, pad_w):
    wts = _swin_weights(gen)
    x = _bf16((3, 10, 15, 256), gen)      # 3 x 6 windows: a ragged last CTA
    y = _bf16((3, 10, 15, 256), gen)
    kernels.reset_launches()
    out = kernels.window_cross_attention(x, y, wts, 5, shift, pad_h, pad_w, 8)
    assert kernels.LAUNCHES["window_cross_attention"] == 1
    ref = kernels.window_cross_attention_plain(x, y, wts, 5, shift, pad_h, pad_w, 8)
    # the output is all update: held as K2 is, with x = 0
    e = kernels.block_errors(out, ref, torch.zeros_like(ref))
    assert kernels.block_errors_pass(e), e


@pytest.mark.parametrize("c,heads,hid,shape", [
    (64, 2, 128, (2, 10, 15)),      # C = 64: the 64-column layout
    (96, 3, 192, (1, 15, 10)),      # C = 96, padded to 128 columns
    (64, 2, 128, (1, 5, 5))])       # a single window
def test_window_cross_attention_kernel_widths(gen, c, heads, hid, shape):
    wts = _swin_weights(gen, c, hid, heads)
    for shift, pad in ((0, 0), (2, 1)):
        x = _bf16((*shape, c), gen)
        y = _bf16((*shape, c), gen)
        kernels.reset_launches()
        out = kernels.window_cross_attention(x, y, wts, 5, shift, pad, pad, heads)
        assert kernels.LAUNCHES["window_cross_attention"] == 1
        ref = kernels.window_cross_attention_plain(x, y, wts, 5, shift, pad, pad,
                                                   heads)
        # the output is all update: held as K2 is, with x = 0
        e = kernels.block_errors(out, ref, torch.zeros_like(ref))
        assert kernels.block_errors_pass(e), (shift, e)


@pytest.mark.parametrize("c,heads,hid,rows", [
    (64, 2, 128, 300),       # C = 64: the 64-column layout
    (96, 3, 192, 300),       # C = 96 padded to 128; hidden 192: half a chunk
    (256, 8, 512, 44),       # fewer rows than one CTA
    (96, 3, 192, 44)])
def test_ln_mlp_kernel_widths(gen, c, heads, hid, rows):
    wts = _swin_weights(gen, c, hid, heads)
    x = _bf16((1, rows, c), gen)
    kernels.reset_launches()
    out = kernels.ln_mlp(x, wts)
    assert kernels.LAUNCHES["ln_mlp"] == 1
    ref = kernels.ln_mlp_plain(x, wts)
    # held to the update (out - x), which the residual x would hide
    e = kernels.block_errors(out, ref, x)
    assert kernels.block_errors_pass(e), e


@pytest.mark.parametrize("rows", [300, 128])
def test_ln_mlp_kernel(gen, rows):
    """300 rows: a ragged last CTA of 44."""
    wts = _swin_weights(gen)
    x = _bf16((2, rows // 2, 256), gen)
    kernels.reset_launches()
    out = kernels.ln_mlp(x, wts)
    assert kernels.LAUNCHES["ln_mlp"] == 1
    ref = kernels.ln_mlp_plain(x, wts)
    # held to the update (out - x), which the residual x would hide
    e = kernels.block_errors(out, ref, x)
    assert kernels.block_errors_pass(e), e


@pytest.mark.parametrize("t,l,r", [(58, 90, 896), (7, 33, 8)])
def test_row_gather_kernel(gen, t, l, r):
    rows = _bf16((2, t, r), gen)
    idx = torch.randint(0, t, (2, l), generator=gen, device="cuda")
    for it in (torch.int64, torch.int32):
        out = kernels.row_gather(rows, idx.to(it))
        assert torch.equal(out, kernels.row_gather_plain(rows, idx.to(it)))


def _assert_corr_rule(s, idx, s_p, idx_p, score_at):
    """S within 1e-5 of its scale; an index may differ only where it attains
    the max within that (the same bf16 products summed in another order)."""
    tol = 1e-5 * max(s_p.abs().max().item(), 1.0)
    assert (s - s_p).abs().max().item() <= tol
    bi, p = (idx != idx_p).nonzero(as_tuple=True)
    if bi.numel():
        assert (score_at(bi, p, idx[bi, p].long()) - s_p[bi, p]).abs().max().item() <= tol


@pytest.mark.parametrize("h,w", [(20, 36), (19, 33)])
def test_corr_unfold_ld_kernel(gen, h, w):
    """K6 on the host-scaled reference equals K5 on the raw one, bit for bit,
    and follows its plain version; 19 x 33 = 627 positions: padded to 8."""
    from speinet_tpu_torch.kernels.corr import scaled_reference
    from speinet_tpu_torch.models.search_transfer import (patch_inv_norms,
                                                          unfold_reference)

    f = torch.rand((2, h, w, 128), generator=gen, device="cuda").to(torch.bfloat16)
    sharp = torch.rand((2, h, w, 128), generator=gen, device="cuda").to(torch.bfloat16)
    hs = torch.tensor([True, False], device="cuda")
    lr, ref, inv = (t.contiguous() for t in
                    unfold_reference(f, sharp, "mixed", hs, patch_inv_norms(f)))
    sc = scaled_reference(ref, inv)
    kernels.reset_launches()
    s, idx = kernels.correlation_argmax_ld(lr, sc)
    assert kernels.LAUNCHES["correlation_argmax_ld"] == 1
    s5, idx5 = kernels.correlation_argmax_lds(lr, ref, inv)
    assert torch.equal(s, s5) and torch.equal(idx, idx5)
    s_p, idx_p = kernels.correlation_argmax_ld_plain(lr, sc)
    _assert_corr_rule(s, idx, s_p, idx_p, lambda bi, p, k: (
        lr[bi, :, p].float() * sc[bi, :, k].float()).sum(1))


@pytest.mark.parametrize("h,w", [(20, 36), (19, 33)])
def test_corr_rows_kernel(gen, h, w):
    """K7 on L2-normalized operands, the reference as [B, Lr, D] rows."""
    from speinet_tpu_torch.models.search_transfer import normalized_reference

    f = torch.rand((2, h, w, 128), generator=gen, device="cuda").to(torch.bfloat16)
    sharp = torch.rand((2, h, w, 128), generator=gen, device="cuda").to(torch.bfloat16)
    hs = torch.tensor([True, False], device="cuda")
    lr_n, ref_n = normalized_reference(f, sharp, "mixed", hs)
    lr_n = lr_n.to(torch.bfloat16).contiguous()
    ref_n = ref_n.to(torch.bfloat16).contiguous()
    kernels.reset_launches()
    s, idx = kernels.correlation_argmax(lr_n, ref_n)
    assert kernels.LAUNCHES["correlation_argmax"] == 1
    s_p, idx_p = kernels.correlation_argmax_plain(lr_n, ref_n)
    _assert_corr_rule(s, idx, s_p, idx_p, lambda bi, p, k: (
        lr_n[bi, :, p].float() * ref_n[bi, k].float()).sum(1))


def _corr_case(gen, mode, b, d, l, lr_len):
    """Signed operands, with every score of query columns 0-39 negative (a
    positive reference against negated queries), so a zero-filled
    reference position past Lr would win those rows if it were not
    masked."""
    lr = torch.randn((b, d, l), generator=gen, device="cuda")
    lr[:, :, :40] = -lr[:, :, :40].abs()
    ref = torch.randn((b, d, lr_len), generator=gen, device="cuda").abs()
    lr, ref = lr.to(torch.bfloat16), ref.to(torch.bfloat16)
    if mode == "rows":
        ref = ref.transpose(1, 2).contiguous()
    inv = torch.rand((b, lr_len), generator=gen, device="cuda") + 0.5
    return lr, ref, inv


_CORR_KERNELS = {
    "lds": ("correlation_argmax_lds", lambda lr, ref, inv: kernels.correlation_argmax_lds(
        lr, ref, inv), lambda lr, ref, inv: kernels.correlation_argmax_lds_plain(lr, ref, inv)),
    "ld": ("correlation_argmax_ld", lambda lr, ref, inv: kernels.correlation_argmax_ld(
        lr, ref), lambda lr, ref, inv: kernels.correlation_argmax_ld_plain(lr, ref)),
    "rows": ("correlation_argmax", lambda lr, ref, inv: kernels.correlation_argmax(
        lr, ref), lambda lr, ref, inv: kernels.correlation_argmax_plain(lr, ref)),
}


@pytest.mark.parametrize("mode,b,d,l,lr_len", [
    # 3 query tiles of 128 (a cluster of two padded with an empty CTA) and
    # a reference off the 256-wide tile
    ("lds", 2, 144, 293, 300), ("ld", 2, 144, 293, 300), ("rows", 2, 144, 293, 300),
    # depth tails: 72 and 144 rows (64-row chunks), 2304 (9 x 256 channels)
    ("ld", 1, 72, 130, 257), ("rows", 3, 72, 421, 511),
    ("lds", 3, 2304, 200, 300), ("ld", 1, 2304, 129, 700),
    ("rows", 1, 2304, 293, 300), ("rows", 3, 2304, 64, 1030),
    # lengths off 8 (padded rows) and a single query tile
    ("lds", 1, 144, 45, 13)])
def test_corr_unfold_edges(gen, mode, b, d, l, lr_len):
    from speinet_tpu_torch.kernels.corr import scaled_reference

    what, kernel, plain = _CORR_KERNELS[mode]
    lr, ref, inv = _corr_case(gen, mode, b, d, l, lr_len)
    kernels.reset_launches()
    s, idx = kernel(lr, ref, inv)
    assert kernels.LAUNCHES[what] == 1
    s_p, idx_p = plain(lr, ref, inv)
    assert (s[:, :40] < 0).all() and (idx >= 0).all() and (idx < lr_len).all()
    ref_rows = {"lds": lambda: scaled_reference(ref, inv).transpose(1, 2),
                "ld": lambda: ref.transpose(1, 2), "rows": lambda: ref}[mode]()
    _assert_corr_rule(s, idx, s_p, idx_p, lambda bi, p, k: (
        lr[bi, :, p].float() * ref_rows[bi, k].float()).sum(1))


# ---- shape limits of the kernels that the JAX package does not have: the
# largest shape each kernel takes, and the first one its wrapper refuses

def test_conv2d_limits(gen):
    x = _bf16((1, 8, 8, 32), gen)
    b = torch.zeros((24,), device="cuda")
    out = kernels.conv2d(x, _bf16((3, 3, 32, 16), gen, 0.1), b[:16])
    assert out.shape == (1, 8, 8, 16)
    with pytest.raises(ValueError, match="multiple of 16"):
        kernels.conv2d(x, _bf16((3, 3, 32, 24), gen, 0.1), b)
    # Co a multiple of 64 stages wide inputs in channel groups; a narrower
    # Co stages whole rows, which at 5x5 fit up to 256 input channels
    x = _bf16((1, 6, 70, 256), gen)
    out = kernels.conv2d(x, _bf16((5, 5, 256, 32), gen, 0.01), b[:16].repeat(2))
    assert out.shape == (1, 6, 70, 32)
    with pytest.raises(ValueError, match="no shared-memory plan"):
        kernels.conv2d(_bf16((1, 6, 70, 320), gen), _bf16((5, 5, 320, 32), gen, 0.01),
                       b[:16].repeat(2))


@pytest.mark.parametrize("fn", ["swin_block", "window_cross_attention"])
def test_window_kernel_limits(gen, fn):
    call = getattr(kernels, fn)
    wts = _swin_weights(gen, 256, 512, 8)
    x = _bf16((1, 5, 5, 256), gen)
    assert call(x, x, wts, 5, 0, 0, 0, 8).shape == x.shape
    wide = _swin_weights(gen, 288, 576, 9)
    x = _bf16((1, 5, 5, 288), gen)
    with pytest.raises(ValueError, match="C <= 256"):
        call(x, x, wide, 5, 0, 0, 0, 9)
    narrow = _swin_weights(gen, 128, 256, 2)      # head dim 64
    x = _bf16((1, 5, 5, 128), gen)
    with pytest.raises(ValueError, match="head dim 32"):
        call(x, x, narrow, 5, 0, 0, 0, 2)


def test_ln_mlp_limits(gen):
    x = _bf16((1, 10, 256), gen)
    assert kernels.ln_mlp(x, _swin_weights(gen, 256, 512, 8)).shape == x.shape
    with pytest.raises(ValueError, match="up to 256"):
        kernels.ln_mlp(_bf16((1, 10, 272), gen), _swin_weights(gen, 272, 512, 8))
    with pytest.raises(ValueError, match="divisible by 64"):
        kernels.ln_mlp(x, _swin_weights(gen, 256, 544, 8))


def test_banded_corr_limits(gen):
    inv = torch.ones((1, 30), device="cuda")
    f = _bf16((1, 5, 6, 256), gen)
    assert kernels.banded_corr_argmax(f, f, inv)[0].shape == (1, 30)
    f = _bf16((1, 5, 6, 272), gen)
    with pytest.raises(ValueError, match="up to 256"):
        kernels.banded_corr_argmax(f, f, inv)
    from speinet_tpu_torch.kernels.corr import MAX_BATCH

    for n, ok in ((MAX_BATCH, True), (MAX_BATCH + 1, False)):
        f = _bf16((n, 1, 1, 16), gen)
        inv = torch.ones((n, 1), device="cuda")
        if ok:
            s, idx = kernels.banded_corr_argmax(f, f, inv)
            assert torch.equal(idx, torch.zeros_like(idx))
        else:
            with pytest.raises(ValueError, match="at most"):
                kernels.banded_corr_argmax(f, f, inv)


def test_row_gather_limits(gen):
    idx = torch.zeros((1, 3), dtype=torch.int64, device="cuda")
    assert kernels.row_gather(_bf16((1, 4, 8), gen), idx).shape == (1, 3, 8)
    with pytest.raises(ValueError, match="multiple of 8"):
        kernels.row_gather(_bf16((1, 4, 12), gen), idx)


def test_corr_unfold_limits(gen):
    from speinet_tpu_torch.kernels.corr import MAX_BATCH

    for n, ok in ((MAX_BATCH, True), (MAX_BATCH + 1, False)):
        lr = _bf16((n, 8, 1), gen)
        inv = torch.ones((n, 1), device="cuda")
        calls = (lambda: kernels.correlation_argmax_lds(lr, lr, inv),
                 lambda: kernels.correlation_argmax_ld(lr, lr),
                 lambda: kernels.correlation_argmax(lr, lr.transpose(1, 2).contiguous()))
        for call in calls:
            if ok:
                s, idx = call()
                assert torch.equal(idx, torch.zeros_like(idx))
            else:
                with pytest.raises(ValueError, match="at most"):
                    call()
    lr = _bf16((1, 2304, 20), gen)
    assert kernels.correlation_argmax(lr, lr.transpose(1, 2).contiguous())[0].shape == (1, 20)
    lr = _bf16((1, 2300, 20), gen)
    with pytest.raises(ValueError, match="multiple of 8"):
        kernels.correlation_argmax(lr, lr.transpose(1, 2).contiguous())


# --- backward passes of the training path --------------------------------------

def test_roll2d_backward_kernel(gen):
    """K3's VJP is K3 with the shifts negated: the gradient equals
    torch.roll's bit for bit, the backward launching K3 once."""
    x = _bf16((2, 15, 20, 256), gen).requires_grad_(True)
    xr = x.detach().clone().requires_grad_(True)
    g = _bf16((2, 15, 20, 256), gen)
    for sh, sw in ((2, 2), (-2, 3)):
        kernels.reset_launches()
        kernels.roll2d(x, sh, sw).backward(g)
        assert kernels.LAUNCHES["roll2d"] == 2
        assert kernels.BACKWARD_LAUNCHES["roll2d"] == 1
        torch.roll(xr, (-sh, -sw), dims=(1, 2)).backward(g)
        assert torch.equal(x.grad, xr.grad)
        x.grad = xr.grad = None


def _leaves(*ts):
    return [t.detach().clone().requires_grad_(True) for t in ts]


def test_corr_lds_backward_kernel(gen):
    """K5 under autograd on the card (its forward launches the kernel) against
    the CPU plain version on the same bf16 operands: equal indices (each query
    is a noisy copy of one reference column, so winners are clear), then the
    gradients. d lr is the same elementwise product on both devices; d ref
    and d inv are f32 scatter-adds in another order, d ref then rounded to
    bf16: one bf16 step of the largest apart at most."""
    b, d, l, lr_len = 2, 1152, 700, 900
    ref = torch.randn((b, d, lr_len), generator=gen, device="cuda")
    pick = torch.randint(0, lr_len, (b, l), generator=gen, device="cuda")
    lr = (torch.gather(ref, 2, pick[:, None].expand(-1, d, -1))
          + 0.3 * torch.randn((b, d, l), generator=gen, device="cuda")).to(torch.bfloat16)
    ref = ref.to(torch.bfloat16)
    inv = 0.5 + torch.rand((b, lr_len), generator=gen, device="cuda")
    gs = torch.randn((b, l), generator=gen, device="cuda")
    card = _leaves(lr, ref, inv)
    kernels.reset_launches()
    s, idx = kernels.correlation_argmax_lds(*card)
    s.backward(gs)
    assert kernels.LAUNCHES["correlation_argmax_lds"] == 1
    cpu = _leaves(*(t.cpu() for t in (lr, ref, inv)))
    s_c, idx_c = kernels.correlation_argmax_lds(*cpu)
    s_c.backward(gs.cpu())
    assert torch.equal(idx.cpu(), idx_c)
    assert torch.equal(card[0].grad.cpu(), cpu[0].grad)
    for a, c in zip(card[1:], cpu[1:]):
        tol = 2.0 ** -8 * c.grad.float().abs().max().item()
        assert (a.grad.cpu().float() - c.grad.float()).abs().max().item() <= tol


def test_row_gather_backward_kernel(gen):
    """K10 under autograd on the card: the scatter-add of the output gradient
    (many repeated indices) against the CPU's, f32 sums in another order
    rounded to bf16."""
    rows = _bf16((2, 58, 896), gen)
    idx = torch.randint(0, 9, (2, 300), generator=gen, device="cuda")
    g = _bf16((2, 300, 896), gen)
    card, = _leaves(rows)
    kernels.reset_launches()
    kernels.row_gather(card, idx).backward(g)
    assert kernels.LAUNCHES["row_gather"] == 1
    cpu, = _leaves(rows.cpu())
    kernels.row_gather(cpu, idx.cpu()).backward(g.cpu())
    tol = 2.0 ** -8 * cpu.grad.float().abs().max().item()
    assert (card.grad.cpu().float() - cpu.grad.float()).abs().max().item() <= tol


@pytest.mark.parametrize("routing", ["sharp", "self"])
def test_banded_corr_backward_kernel(gen, routing):
    """K4 under autograd on the card (the forward launches K4; the backward,
    `banded_backward`, runs on the card) against the CPU's plain forward and
    the same backward on the same bf16 maps. The cotangent is zeroed where
    the two argmaxes differ (a near tie may flip under another summation
    order), so both backwards see the same winners. d lr sums 9 gathered
    products in one order on both devices; d ref is an f32 scatter-add in
    another order, rounded to bf16, and d inv carries the card's S: each
    within one bf16 step of its largest element."""
    f = _bf16((2, 13, 22, 64), gen)
    g = _bf16((2, 13, 22, 64), gen)
    inv = 0.5 + torch.rand((2, 13 * 22), generator=gen, device="cuda")
    gs = torch.randn((2, 13 * 22), generator=gen, device="cuda")

    def run(f_, g_, inv_, gs_):
        leaves = _leaves(f_, g_, inv_)
        ref = leaves[1] if routing == "sharp" else torch.flip(
            leaves[0].transpose(1, 2), dims=(1,)).contiguous()
        s, idx = kernels.banded_corr_argmax(leaves[0], ref, leaves[2])
        return s, idx, leaves, gs_

    kernels.reset_launches()
    s, idx, card, _ = run(f, g, inv, gs)
    assert kernels.LAUNCHES["banded_corr_argmax"] == 1
    s_c, idx_c, cpu, _ = run(f.cpu(), g.cpu(), inv.cpu(), gs.cpu())
    agree = idx.cpu() == idx_c
    assert agree.float().mean() > 0.99
    s.backward(gs * agree.cuda())
    s_c.backward(gs.cpu() * agree)
    assert kernels.LAUNCHES["banded_corr_argmax"] == 1     # the backward is plain
    pairs = list(zip(card, cpu))[: 2 if routing == "sharp" else 1] + [(card[2], cpu[2])]
    for a, c in pairs:
        tol = 2.0 ** -8 * c.grad.float().abs().max().item()
        assert (a.grad.cpu().float() - c.grad.float()).abs().max().item() <= tol


def test_world1_nccl_group_matches_no_group(gen, tmp_path):
    """A TripletAttention's training forward and backward, its gradients
    averaged over the group, in a world-size-1 nccl group against the same
    without a group: the gate statistics' all-reduce (and its backward) and
    the gradient all-reduce run, and change nothing: each is the identity
    with one rank, and the statistics are sum / count with or without a
    group (atomic adds in cuDNN's backwards may still reorder sums)."""
    import torch.distributed as dist
    from speinet_tpu_torch.models.blocks import TripletAttention
    from speinet_tpu_torch.parallel.mesh import (average_gradients,
                                                 maybe_init_distributed, world)

    x = _bf16((4, 20, 24, 32), gen)

    def run():
        torch.manual_seed(0)
        te = TripletAttention().cuda()
        xx = x.clone().requires_grad_(True)
        y = te(xx, train=True)
        y.float().square().mean().backward()
        average_gradients(te.parameters())
        return dict(y=y.float(), x_grad=xx.grad.float(),
                    **{f"grad {n}": p.grad for n, p in te.named_parameters()},
                    **{k: v.float() for k, v in te.state_dict().items()})

    want = run()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdzv", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        assert maybe_init_distributed("cuda") == torch.device("cuda", 0)
        assert world() == 1
        got = run()
    finally:
        dist.destroy_process_group()
    assert set(got) == set(want)
    for k, w in want.items():
        # bf16 outputs: one bf16 step; f32 statistics and gradients: 1e-4
        tol = (2.0 ** -7 if k in ("y", "x_grad") else 1e-4) * max(
            w.abs().max().item(), 1e-6)
        assert (got[k] - w).abs().max().item() <= tol, k
