"""K2, K8 and K9 wrappers: the cross-attention Swin block, whole or split.

    K2 swin_block              `csrc/swin_block.cu`, replaces
                               `speinet_tpu/ops/pallas_swin.py::fused_swin_block`
    K8 window_cross_attention  `csrc/swin_attn.cu`, replaces
                               `fused_window_cross_attention`
    K9 ln_mlp                  `csrc/swin_mlp.cu`, replaces `fused_ln_mlp`

x (K/V stream) and y (Q stream) arrive rolled and padded. K2 returns the
whole block (x + attention + MLP), still rolled and padded; K8 only the
attention branch (LN1, attention, projection), still rolled; K9 takes the
block's residual stream after the attention, x + K8's output un-rolled,
and adds the MLP. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. None of the three has a backward (training
runs the XLA-style block in `models/swinir.py`, as the JAX package does),
so each refuses inputs that need a gradient. K2 and K8 compute heads of
32 features; a narrower head dim that divides 32 (the 64-wide, 4-head
fusion of the head-to-head model) runs through `widen_heads`, which
copies the channels and zero-pads each head to 32.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from speinet_tpu_torch.kernels import _lib


class SwinBlockWeights(NamedTuple):
    """One block's parameters: matrices in torch Linear layout [out, in]
    and in the compute dtype, everything else float32."""

    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    wkv: torch.Tensor       # [2C, C]
    bkv: torch.Tensor
    wq: torch.Tensor        # [C, C]
    bq: torch.Tensor
    wp: torch.Tensor        # [C, C]
    bp: torch.Tensor
    relbias: torch.Tensor   # [heads, N, N]
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    w1: torch.Tensor        # [hidden, C]
    b1: torch.Tensor
    w2: torch.Tensor        # [C, hidden]
    b2: torch.Tensor


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in float32 with the one-pass clamped
    variance of the JAX package; returns float32."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return (xf - mu) * torch.rsqrt(var + eps) * w + b


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, ws*ws, C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(win: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """[B*nW, ws*ws, C] -> [B, H, W, C]."""
    c = win.shape[-1]
    b = win.shape[0] // (h * w // ws // ws)
    x = win.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


@functools.lru_cache(maxsize=None)
def shift_attn_mask(h: int, w: int, window_size: int, shift_size: int) -> np.ndarray:
    """SW-MSA mask [nW, N, N] of 0 / -100 (parity: swinir.py:215-236)."""
    img_mask = np.zeros((h, w))
    slices = (slice(0, -window_size), slice(-window_size, -shift_size),
              slice(-shift_size, None))
    cnt = 0
    for hs in slices:
        for wsl in slices:
            img_mask[hs, wsl] = cnt
            cnt += 1
    m = img_mask.reshape(h // window_size, window_size, w // window_size,
                         window_size)
    m = m.transpose(0, 2, 1, 3).reshape(-1, window_size * window_size)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def window_mask(hp: int, wp: int, ws: int, shift: int, pad_h: int,
                pad_w: int) -> np.ndarray | None:
    """Shift mask plus the pad mask of keys that are padding after the roll
    ([nW, N, N], -100 per violated rule), or None when neither applies."""
    mask = shift_attn_mask(hp, wp, ws, shift) if shift > 0 else None
    if pad_h or pad_w:
        pad = np.zeros((hp, wp), np.float32)
        pad[hp - pad_h:, :] = 1.0
        pad[:, wp - pad_w:] = 1.0
        if shift > 0:
            pad = np.roll(pad, (-shift, -shift), axis=(0, 1))
        pm = pad.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3)
        pm = pm.reshape(-1, ws * ws)
        pmask = np.where(pm[:, None, :] > 0, -100.0, 0.0).astype(np.float32)
        mask = pmask if mask is None else mask + pmask
    return mask


def _attention_plain(x: torch.Tensor, y: torch.Tensor, wts: SwinBlockWeights,
                     ws: int, shift: int, pad_h: int, pad_w: int, heads: int,
                     scale: float | None = None):
    """The window kernels' attention arithmetic in float32, rounding to
    x.dtype where they store (LN'd rows, Q/K/V, softmax probabilities, the
    attention output): (raw x windows, O Wp^T + bp) as [B*nW, N, C] f32.
    Q is scaled by `scale`, the head dim's -1/2 power unless given."""
    hp, wp, c = x.shape[1:]
    n = ws * ws
    hd = c // heads
    scale = hd ** -0.5 if scale is None else scale
    rnd = lambda t: t.to(x.dtype).float()
    xw_raw = window_partition(x, ws).float()
    yw_raw = window_partition(y, ws).float()
    bw = xw_raw.shape[0]
    xw = rnd(layer_norm(xw_raw, wts.ln1_w, wts.ln1_b))
    yw = rnd(layer_norm(yw_raw, wts.ln1_w, wts.ln1_b))
    kv = rnd(xw @ wts.wkv.float().T + wts.bkv)
    q = rnd((yw @ wts.wq.float().T + wts.bq) * scale)
    k, v = kv[..., :c], kv[..., c:]
    q = q.reshape(bw, n, heads, hd).transpose(1, 2)
    k = k.reshape(bw, n, heads, hd).transpose(1, 2)
    v = v.reshape(bw, n, heads, hd).transpose(1, 2)
    s = q @ k.transpose(-1, -2) + wts.relbias[None]
    mask = window_mask(hp, wp, ws, shift, pad_h, pad_w)
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(bw // nw, nw, heads, n, n)
             + torch.from_numpy(mask).to(s.device)[None, :, None]).reshape(
                 bw, heads, n, n)
    p = rnd(torch.softmax(s, dim=-1))
    o = rnd((p @ v).transpose(1, 2).reshape(bw, n, c))
    return xw_raw, o @ wts.wp.float().T + wts.bp


def _mlp_plain(xf: torch.Tensor, wts: SwinBlockWeights,
               dt: torch.dtype) -> torch.Tensor:
    """fc2(gelu(fc1(LN2(xf)))) in float32 with the LN'd rows and the GELU
    output rounded to dt, as the kernels store them."""
    rnd = lambda t: t.to(dt).float()
    xn2 = rnd(layer_norm(xf, wts.ln2_w, wts.ln2_b))
    hmid = rnd(F.gelu(xn2 @ wts.w1.float().T + wts.b1))
    return hmid @ wts.w2.float().T + wts.b2


def swin_block_plain(x: torch.Tensor, y: torch.Tensor, wts: SwinBlockWeights,
                     ws: int, shift: int, pad_h: int, pad_w: int,
                     heads: int, scale: float | None = None) -> torch.Tensor:
    """K2's arithmetic in float32, rounding to x.dtype where the kernel
    stores: the attention's (`_attention_plain`), LN2 and the GELU output;
    residual stream in f32."""
    hp, wp = x.shape[1:3]
    xw_raw, res = _attention_plain(x, y, wts, ws, shift, pad_h, pad_w, heads,
                                   scale)
    x2 = xw_raw + res
    out = (x2 + _mlp_plain(x2, wts, x.dtype)).to(x.dtype)
    return window_reverse(out, ws, hp, wp)


def window_cross_attention_plain(x: torch.Tensor, y: torch.Tensor,
                                 wts: SwinBlockWeights, ws: int, shift: int,
                                 pad_h: int, pad_w: int, heads: int,
                                 scale: float | None = None) -> torch.Tensor:
    """K8's arithmetic: K2's attention, its projection rounded to x.dtype."""
    hp, wp = x.shape[1:3]
    _, res = _attention_plain(x, y, wts, ws, shift, pad_h, pad_w, heads, scale)
    return window_reverse(res.to(x.dtype), ws, hp, wp)


def ln_mlp_plain(x: torch.Tensor, wts: SwinBlockWeights) -> torch.Tensor:
    """K9's arithmetic: x + bf16(MLP(LN2(x))), the MLP's result rounded to
    x.dtype before the residual add, as fused_ln_mlp rounds it."""
    y = _mlp_plain(x.float(), wts, x.dtype).to(x.dtype)
    return (x.float() + y.float()).to(x.dtype)


def block_errors(out: torch.Tensor, ref: torch.Tensor, x: torch.Tensor) -> dict:
    """How far a block output `out` lies from the plain version's `ref`,
    measured against the block's update (ref - x), which a relative error of
    the output would hide under the residual x (K2, K9). K8's output has no
    residual: it is all update, and is measured with x = 0. Both round one
    float32 sum to bf16, so they may differ by one bf16 step of the output
    where that rounding flips; `max_excess` is what lies beyond that step."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    mag = torch.maximum(o.abs(), r.abs()).clamp(min=2.0 ** -126)
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)     # bf16 spacing
    upd = (r - x.float()).abs()
    return dict(max_abs_err=err.max().item(), mean_abs_err=err.mean().item(),
                max_excess=(err - step).clamp(min=0).max().item(),
                max_update=upd.max().item(), mean_update=upd.mean().item())


def block_errors_pass(e: dict) -> bool:
    """The tolerance the kernel is held to against `swin_block_plain`: beyond
    the output's bf16 step, at most 2^-7 of the largest update, and a mean
    error of at most 2^-10 of the mean update. Another f32 summation order
    stays far inside both; a dropped relative-position bias or shift mask
    does not (tests/test_torch_kernels.py shows both on the CPU)."""
    return (e["max_excess"] <= 2.0 ** -7 * e["max_update"]
            and e["mean_abs_err"] <= 2.0 ** -10 * e["mean_update"])


def _check_window_args(what: str, x: torch.Tensor, y: torch.Tensor, ws: int,
                       heads: int) -> None:
    if x.shape != y.shape or x.ndim != 4:
        raise ValueError(f"{what} takes two equal [B, Hp, Wp, C] images, "
                         f"got {tuple(x.shape)} and {tuple(y.shape)}")
    b, hp, wp, c = x.shape
    if hp % ws or wp % ws or c % heads:
        raise ValueError(f"[{hp}, {wp}] is not a multiple of window {ws} or "
                         f"{c} channels do not split over {heads} heads")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError(f"{what}: x and y must be contiguous")


def _require_weights(wts: SwinBlockWeights, dev: torch.device, mats, vecs) -> None:
    for name in mats:
        _lib.require_cuda_tensor(getattr(wts, name), name, torch.bfloat16, dev)
    for name in vecs:
        _lib.require_cuda_tensor(getattr(wts, name), name, torch.float32, dev)


KERNEL_HEAD_DIM = 32     # the window kernels' head dim (csrc/swin_wgmma.cuh HD)


def head_replicas(c: int, heads: int) -> int:
    """How many copies of the C channels the window kernels run on: 1 at
    head dim 32; at a head dim d that divides 32, r = 32 / d copies, so
    that each head can be zero-padded to 32 (`widen_heads`). 0 where the
    kernels cannot take the shape (r C over 256)."""
    d = c // heads
    if d > KERNEL_HEAD_DIM or KERNEL_HEAD_DIM % d:
        return 0
    r = KERNEL_HEAD_DIM // d
    return r if r * c <= 256 else 0


def _require_window_kernel(what: str, ws: int, c: int, heads: int) -> None:
    if ws != 5 or not head_replicas(c, heads):
        raise ValueError(f"{what} kernel takes window 5, head dim 32 and "
                         f"C <= 256, or a head dim d that divides 32 with "
                         f"(32 / d) C <= 256; got window {ws}, C {c}, "
                         f"{heads} heads")


def widen_heads(x: torch.Tensor, y: torch.Tensor, wts: SwinBlockWeights,
                heads: int):
    """The window kernels' operands for a head dim d below 32: (x, y, wts)
    over r = 32 / d copies of the C channels, each head's Q, K, V zero-padded
    from d to 32 features. LayerNorm over r identical copies has the same
    statistics; zero features add nothing to q.k and give zero outputs,
    which the projection's zero columns drop; the projection, the
    residual and the MLP's output are copied r times, fc1 reads the first
    copy. The kernel's output over r C channels holds the block's output
    r times; the first C channels are it. The caller passes the scale of
    the head dim d. At head dim 32 the operands are returned unchanged."""
    c = x.shape[-1]
    r = head_replicas(c, heads)
    if r == 1:
        return x, y, wts
    d = c // heads

    def pad_heads(t):      # leading axis heads * d -> heads * 32, zeros after d
        t = t.reshape(heads, d, *t.shape[1:])
        t = F.pad(t, (0, 0) * (t.ndim - 2) + (0, KERNEL_HEAD_DIM - d))
        return t.reshape(heads * KERNEL_HEAD_DIM, *t.shape[2:])

    pad_in = lambda w: F.pad(w, (0, (r - 1) * c)).contiguous()   # reads copy 0
    copies = lambda t: t.repeat(r, *([1] * (t.ndim - 1))).contiguous()
    kw, vw = wts.wkv[:c], wts.wkv[c:]
    kb, vb = wts.bkv[:c], wts.bkv[c:]
    wide = SwinBlockWeights(
        copies(wts.ln1_w), copies(wts.ln1_b),
        torch.cat([pad_in(pad_heads(kw)), pad_in(pad_heads(vw))]).contiguous(),
        torch.cat([pad_heads(kb), pad_heads(vb)]).contiguous(),
        pad_in(pad_heads(wts.wq)), pad_heads(wts.bq).contiguous(),
        copies(pad_heads(wts.wp.t()).t()), copies(wts.bp), wts.relbias,
        copies(wts.ln2_w), copies(wts.ln2_b), pad_in(wts.w1), wts.b1,
        copies(wts.w2), copies(wts.b2))
    return x.repeat(1, 1, 1, r), y.repeat(1, 1, 1, r), wide


def _require_mlp_kernel(what: str, c: int, hidden: int) -> None:
    if c % 16 or c > 256 or hidden % 64:
        raise ValueError(f"{what} kernel takes C a multiple of 16 up to 256 and "
                         f"a hidden width divisible by 64; got C {c}, hidden "
                         f"{hidden}")


_ATTN_MATS = ("wkv", "wq", "wp")
_ATTN_VECS = ("ln1_w", "ln1_b", "bkv", "bq", "bp", "relbias")
_MLP_MATS = ("w1", "w2")
_MLP_VECS = ("ln2_w", "ln2_b", "b1", "b2")


def swin_block(x: torch.Tensor, y: torch.Tensor, wts: SwinBlockWeights,
               ws: int, shift: int, pad_h: int, pad_w: int,
               heads: int) -> torch.Tensor:
    """x, y [B, Hp, Wp, C] raw (un-normalized), rolled and padded ->
    the block output [B, Hp, Wp, C], rolled and padded."""
    _check_window_args("swin_block", x, y, ws, heads)
    _lib.refuse_grad("swin_block", x, y, *wts)
    if _lib.dispatch_device(x, "swin_block") == "cpu":
        return swin_block_plain(x, y, wts, ws, shift, pad_h, pad_w, heads)
    dev = x.device
    b, hp, wp, c = x.shape
    hidden = wts.w1.shape[0]
    _require_window_kernel("swin_block", ws, c, heads)
    _require_mlp_kernel("swin_block", c, hidden)
    _lib.require_cuda_tensor(x, "x", torch.bfloat16, dev)
    _lib.require_cuda_tensor(y, "y", torch.bfloat16, dev)
    _require_weights(wts, dev, _ATTN_MATS + _MLP_MATS, _ATTN_VECS + _MLP_VECS)
    scale = float((c // heads) ** -0.5)
    x, y, wts = widen_heads(x, y, wts, heads)
    out = torch.empty_like(x)
    ptr = lambda t: t.data_ptr()
    lib = _lib.library()
    _lib.check(lib.speinet_swin_block(
        ptr(x), ptr(y), ptr(out), ptr(wts.ln1_w), ptr(wts.ln1_b), ptr(wts.wkv),
        ptr(wts.bkv), ptr(wts.wq), ptr(wts.bq), ptr(wts.wp), ptr(wts.bp),
        ptr(wts.relbias), ptr(wts.ln2_w), ptr(wts.ln2_b), ptr(wts.w1),
        ptr(wts.b1), ptr(wts.w2), ptr(wts.b2), b, hp, wp, x.shape[-1], hidden,
        heads, ws, shift, hp - pad_h, wp - pad_w, scale,
        _lib.stream_ptr(x)), "swin_block")
    _lib.LAUNCHES["swin_block"] += 1
    return out[..., :c].contiguous() if out.shape[-1] != c else out


def window_cross_attention(x: torch.Tensor, y: torch.Tensor,
                           wts: SwinBlockWeights, ws: int, shift: int,
                           pad_h: int, pad_w: int, heads: int) -> torch.Tensor:
    """x, y [B, Hp, Wp, C] raw (un-normalized), rolled and padded -> the
    attention branch [B, Hp, Wp, C] (LN1, attention, projection; before the
    residual), rolled and padded. Only the LN1 / attention / projection
    fields of `wts` are read."""
    _check_window_args("window_cross_attention", x, y, ws, heads)
    _lib.refuse_grad("window_cross_attention", x, y, *wts)
    if _lib.dispatch_device(x, "window_cross_attention") == "cpu":
        return window_cross_attention_plain(x, y, wts, ws, shift, pad_h, pad_w,
                                            heads)
    dev = x.device
    b, hp, wp, c = x.shape
    _require_window_kernel("window_cross_attention", ws, c, heads)
    _lib.require_cuda_tensor(x, "x", torch.bfloat16, dev)
    _lib.require_cuda_tensor(y, "y", torch.bfloat16, dev)
    _require_weights(wts, dev, _ATTN_MATS, _ATTN_VECS)
    scale = float((c // heads) ** -0.5)
    x, y, wts = widen_heads(x, y, wts, heads)
    out = torch.empty_like(x)
    ptr = lambda t: t.data_ptr()
    lib = _lib.library()
    _lib.check(lib.speinet_swin_attn(
        ptr(x), ptr(y), ptr(out), ptr(wts.ln1_w), ptr(wts.ln1_b), ptr(wts.wkv),
        ptr(wts.bkv), ptr(wts.wq), ptr(wts.bq), ptr(wts.wp), ptr(wts.bp),
        ptr(wts.relbias), b, hp, wp, x.shape[-1], heads, ws, shift, hp - pad_h,
        wp - pad_w, scale, _lib.stream_ptr(x)), "window_cross_attention")
    _lib.LAUNCHES["window_cross_attention"] += 1
    return out[..., :c].contiguous() if out.shape[-1] != c else out


def ln_mlp(x: torch.Tensor, wts: SwinBlockWeights) -> torch.Tensor:
    """x [..., C] token rows -> x + MLP(LN2(x)), same shape. Only the LN2 /
    MLP fields of `wts` are read."""
    if x.ndim < 2 or not x.is_contiguous():
        raise ValueError(f"ln_mlp takes contiguous [..., C] rows, got "
                         f"{tuple(x.shape)}")
    _lib.refuse_grad("ln_mlp", x, *wts)
    if _lib.dispatch_device(x, "ln_mlp") == "cpu":
        return ln_mlp_plain(x, wts)
    dev = x.device
    c = x.shape[-1]
    hidden = wts.w1.shape[0]
    _require_mlp_kernel("ln_mlp", c, hidden)
    _lib.require_cuda_tensor(x, "x", torch.bfloat16, dev)
    _require_weights(wts, dev, _MLP_MATS, _MLP_VECS)
    out = torch.empty_like(x)
    ptr = lambda t: t.data_ptr()
    lib = _lib.library()
    _lib.check(lib.speinet_swin_mlp(
        ptr(x), ptr(out), ptr(wts.ln2_w), ptr(wts.ln2_b), ptr(wts.w1),
        ptr(wts.b1), ptr(wts.w2), ptr(wts.b2), x.numel() // c, c, hidden,
        _lib.stream_ptr(x)), "ln_mlp")
    _lib.LAUNCHES["ln_mlp"] += 1
    return out
