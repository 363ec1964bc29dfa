"""K4-K7 wrappers: 3x3-patch correlation max / argmax.

K4 `banded_corr_argmax` (`csrc/corr_banded.cu`) replaces
`speinet_tpu/ops/pallas_corr.py::banded_corr_argmax` and works on the
feature maps, which its wrapper lays out for the banded form
(`banded_layout`), with each reference tile's scale and mask
(`banded_aux`) for each of its reference tiles (`banded_plan`). The other
three work on explicit [B, 9C, L] unfolds, so a batch may mix reference
layouts sample by sample, and are three modes of one kernel,
`csrc/corr_unfold.cu`:
    K5 correlation_argmax_lds  raw reference [B, D, Lr], scaled in the kernel
                               (`correlation_argmax_pallas_lds`)
    K6 correlation_argmax_ld   reference [B, D, Lr] scaled on the host
                               (`correlation_argmax_pallas_ld`)
    K7 correlation_argmax      L2-normalized operands, reference [B, Lr, D]
                               (`correlation_argmax_pallas`)
A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. K5-K7 run under autograd functions whose backward ports the JAX
package's custom VJPs (`_corr_lds_bwd`, `_corr_ld_bwd`, `_corr_bwd`,
pallas_corr.py:310-392), XLA code there and plain PyTorch here on either
device: torch.max's subgradient through the winning reference column, the
reference cotangents scatter-added in float32 and cast to the operand dtype
at the end. K4 runs under one too, whose backward ports `_banded_bwd`
(pallas_corr.py:588-630) alike: the same subgradient in map space, one
shifted gather and scatter-add per patch offset. `idx` carries no gradient.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from speinet_tpu_torch.kernels import _lib


def _check_args(lr_map: torch.Tensor, ref_map: torch.Tensor,
                inv_ref: torch.Tensor) -> None:
    if lr_map.ndim != 4 or ref_map.ndim != 4:
        raise ValueError("banded_corr_argmax takes [B, H, W, C] maps")
    b, _, _, c = lr_map.shape
    if ref_map.shape[0] != b or ref_map.shape[3] != c:
        raise ValueError(f"reference {tuple(ref_map.shape)} does not match "
                         f"query {tuple(lr_map.shape)}")
    if inv_ref.shape != (b, ref_map.shape[1] * ref_map.shape[2]):
        raise ValueError(f"inv_ref {tuple(inv_ref.shape)} should be "
                         f"[B, Hr*Wr]")
    for name, t in (("lr_map", lr_map), ("ref_map", ref_map),
                    ("inv_ref", inv_ref)):
        if not t.is_contiguous():
            raise ValueError(f"banded_corr_argmax: {name} must be contiguous")


CHUNK = 2048   # reference positions per [chunk, L] product of the plain version


def banded_corr_argmax_plain(lr_map: torch.Tensor, ref_map: torch.Tensor,
                             inv_ref: torch.Tensor):
    """S[p] = max_q inv[q] * <unfold(F)[:, p], unfold(G)[:, q]> and its first
    argmax, with the [L, Lr] product taken CHUNK reference positions at a
    time in float32."""
    b, h, w, c = lr_map.shape
    lu = F.unfold(lr_map.permute(0, 3, 1, 2).float(), 3, padding=1)   # [B, D, L]
    ru = F.unfold(ref_map.permute(0, 3, 1, 2).float(), 3, padding=1)  # [B, D, Lr]
    inv = inv_ref.float()
    lr_len = ru.shape[2]
    best = torch.full((b, h * w), float("-inf"), device=lr_map.device)
    best_idx = torch.zeros((b, h * w), dtype=torch.int64, device=lr_map.device)
    for q0 in range(0, lr_len, CHUNK):
        q1 = min(q0 + CHUNK, lr_len)
        r = torch.bmm(ru[:, :, q0:q1].transpose(1, 2), lu)   # [B, chunk, L]
        r = r * inv[:, q0:q1, None]
        cmax, carg = r.max(dim=1)
        upd = cmax > best
        best = torch.where(upd, cmax, best)
        best_idx = torch.where(upd, carg + q0, best_idx)
    return best, best_idx.to(torch.int32)


# K4's reference tiles (csrc/corr_banded.cu, which tiles the query itself):
# 256 positions 254 apart over the padded flat index space of width Wr + 1,
# the last two columns being the next tile's diagonal halo
BANDED_TK = 256
BANDED_TKV = 254
MAX_POSITIONS = 1 << 30   # padded positions per map (int32 TMA coordinates)


def banded_plan(hr: int, wr: int) -> int:
    """K4's reference tiles for an hr x wr reference of hr(wr + 1) flat
    positions, its pad column included; the kernel checks the count."""
    return -(-hr * (wr + 1) // BANDED_TKV)


def banded_layout(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] map -> [B, Lp, C], the layout K4 reads: one zero row
    above and below, one zero column on the right, flattened row-major
    (pixel (r, c) at (r + 1)(W + 1) + c), and a second zero row below where
    (H + 2)(W + 1) is odd, since the kernel reads the query's even and odd
    positions through two tensor maps of 2-position pitch. The JAX
    package's `_banded_windows` slabs are runs of this array."""
    b, h, w, c = x.shape
    odd = (h + 2) * (w + 1) % 2
    return F.pad(x, (0, 0, 0, 1, 1, 1 + odd)).view(b, -1, c)


@functools.lru_cache(maxsize=16)
def _banded_columns(hr: int, wr: int, n_kt: int, device: torch.device):
    """For column j of reference tile k, flat position q = 254k + j: its
    row-major index in Hr x Wr (0 where it is none), 1 where q is a pixel
    of the map and j < 254 (else 0), and the additive mask, 0 there and
    -inf elsewhere. [n_kt, 256] each, built once per shape and device."""
    wp = wr + 1
    j = torch.arange(BANDED_TK, device=device)
    q = torch.arange(n_kt, device=device)[:, None] * BANDED_TKV + j
    valid = (j < BANDED_TKV) & (q < hr * wp) & (q % wp < wr)
    src = torch.where(valid, q // wp * wr + q % wp, 0)
    return src, valid.float(), torch.where(valid, 0.0, float("-inf"))


def banded_aux(inv_ref: torch.Tensor, hr: int, wr: int, n_kt: int) -> torch.Tensor:
    """[B, Hr*Wr] inverse norms -> [B, n_kt, 256, 2] f32: for column j of
    reference tile k, flat position q = 254k + j, the pair (inv, 0) where q
    is a pixel of the map and j < 254, else (0, -inf): K4's scale and
    additive validity mask (the JAX package's `_banded_aux`, with -inf for
    its -1e30)."""
    src, keep, mask = _banded_columns(hr, wr, n_kt, inv_ref.device)
    inv = inv_ref.float()[:, src] * keep
    return torch.stack([inv, mask.expand_as(inv)], dim=-1)


MAX_BATCH = 65535   # K4-K7 launch one grid row per sample


def _check_batch(what: str, b: int) -> None:
    if b > MAX_BATCH:
        raise ValueError(f"{what} kernel takes at most {MAX_BATCH} samples, "
                         f"got {b}")


def _banded_launch(lr_map: torch.Tensor, ref_map: torch.Tensor,
                   inv_ref: torch.Tensor):
    """Launch K4 on CUDA maps."""
    dev = lr_map.device
    _lib.require_cuda_tensor(lr_map, "lr_map", torch.bfloat16, dev)
    _lib.require_cuda_tensor(ref_map, "ref_map", torch.bfloat16, dev)
    _lib.require_cuda_tensor(inv_ref, "inv_ref", torch.float32, dev)
    b, h, w, c = lr_map.shape
    hr, wr = ref_map.shape[1:3]
    if c % 16 or c > 256:
        raise ValueError(f"banded_corr_argmax kernel takes a multiple of 16 "
                         f"channels up to 256, got {c}")
    _check_batch("banded_corr_argmax", b)
    if max((h + 3) * (w + 1), (hr + 3) * (wr + 1)) >= MAX_POSITIONS:
        raise ValueError(f"banded_corr_argmax kernel takes maps of (H + 3)(W + 1) "
                         f"< 2^30 positions, got {h}x{w} and {hr}x{wr}")
    n_kt = banded_plan(hr, wr)
    fp, gp = banded_layout(lr_map), banded_layout(ref_map)
    aux = banded_aux(inv_ref, hr, wr, n_kt)
    s = torch.empty((b, h * w), dtype=torch.float32, device=dev)
    idx = torch.empty((b, h * w), dtype=torch.int32, device=dev)
    lib = _lib.library()
    _lib.check(lib.speinet_banded_corr(fp.data_ptr(), gp.data_ptr(), aux.data_ptr(),
                                       s.data_ptr(), idx.data_ptr(), b, h, w, hr, wr,
                                       c, n_kt, _lib.stream_ptr(lr_map)),
               "banded_corr_argmax")
    _lib.LAUNCHES["banded_corr_argmax"] += 1
    return s, idx


# the 3x3 patch offsets (dy, dx) K4's backward walks
OFFSETS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))


def banded_backward(lr_map: torch.Tensor, ref_map: torch.Tensor,
                    inv_ref: torch.Tensor, s: torch.Tensor, idx: torch.Tensor,
                    gs: torch.Tensor, needs=(True, True, True)):
    """K4's VJP (`_banded_bwd`): with gw_p = g_p inv[q*_p] and q* the
    winning reference pixel, for each offset o
        d_lr[p + o]   += gw_p ref[q*_p + o]
        d_ref[q*_p + o] += gw_p lr[p + o]
    (zero where a position lies off its map), and d_inv[q*_p] += g_p S_p /
    inv[q*_p]. All in float32; each cotangent is cast to its operand's
    dtype once. `needs` says which of (d_lr, d_ref, d_inv) to compute."""
    b, h, w, c = lr_map.shape
    hr, wr = ref_map.shape[1:3]
    idx = idx.long()
    gs = gs.float()
    inv_sel = torch.gather(inv_ref.float(), 1, idx)
    gw = gs * inv_sel                                         # [B, L]
    qr, qc = idx // wr, idx % wr
    base = torch.arange(b, device=idx.device)[:, None] * (hr * wr)
    ref_rows = ref_map.float().reshape(b * hr * wr, c)
    lr_pad = F.pad(lr_map.float(), (0, 0, 1, 1, 1, 1))
    d_lr_pad = torch.zeros_like(lr_pad) if needs[0] else None
    d_ref = torch.zeros_like(ref_rows) if needs[1] else None
    for dy, dx in OFFSETS:
        vr, vc = qr + dy, qc + dx
        ok = ((vr >= 0) & (vr < hr) & (vc >= 0) & (vc < wr)).float()
        qo = (vr.clamp(0, hr - 1) * wr + vc.clamp(0, wr - 1) + base).reshape(-1)
        win = (slice(None), slice(1 + dy, 1 + dy + h), slice(1 + dx, 1 + dx + w))
        if needs[0]:
            g_sel = ref_rows[qo].view(b, h, w, c)
            d_lr_pad[win] += (gw * ok).view(b, h, w, 1) * g_sel
        if needs[1]:
            f_o = lr_pad[win].reshape(b * h * w, c)
            d_ref.index_add_(0, qo, (gw * ok).reshape(-1, 1) * f_o)
    d_lr = d_ref_map = d_inv = None
    if needs[0]:
        d_lr = d_lr_pad[:, 1:-1, 1:-1].to(lr_map.dtype)
    if needs[1]:
        d_ref_map = d_ref.view(b, hr, wr, c).to(ref_map.dtype)
    if needs[2]:
        d_inv = torch.zeros(inv_ref.shape, dtype=torch.float32, device=inv_ref.device)
        d_inv.scatter_add_(1, idx, s / torch.clamp(inv_sel, min=1e-30) * gs)
        d_inv = d_inv.to(inv_ref.dtype)
    return d_lr, d_ref_map, d_inv


class BandedCorr(torch.autograd.Function):
    """K4: S_p = inv_q* <patch(ref, q*), patch(lr, p)>; forward K4 on the
    card, the plain version on the CPU; backward `banded_backward` on both."""

    @staticmethod
    def forward(ctx, lr_map, ref_map, inv_ref):
        if lr_map.device.type == "cpu":
            s, idx = banded_corr_argmax_plain(lr_map, ref_map, inv_ref)
        else:
            s, idx = _banded_launch(lr_map, ref_map, inv_ref)
        ctx.save_for_backward(lr_map, ref_map, inv_ref, s, idx)
        ctx.mark_non_differentiable(idx)
        return s, idx

    @staticmethod
    def backward(ctx, gs, _):
        return banded_backward(*ctx.saved_tensors, gs, ctx.needs_input_grad)


def banded_corr_argmax(lr_map: torch.Tensor, ref_map: torch.Tensor,
                       inv_ref: torch.Tensor):
    """lr_map [B, H, W, C], ref_map [B, Hr, Wr, C], inv_ref [B, Hr*Wr] f32
    -> (S [B, H*W] f32, idx [B, H*W] int32 row-major over Hr x Wr)."""
    _check_args(lr_map, ref_map, inv_ref)
    _lib.dispatch_device(lr_map, "banded_corr_argmax")
    return BandedCorr.apply(lr_map, ref_map, inv_ref)


def _check_unfold_args(what: str, lr: torch.Tensor, ref: torch.Tensor,
                       ref_rows: bool, inv_ref: torch.Tensor | None = None) -> None:
    """lr [B, D, L] and a reference [B, D, Lr] (or [B, Lr, D] where
    `ref_rows`) of the same batch and depth, all contiguous."""
    if lr.ndim != 3 or ref.ndim != 3:
        raise ValueError(f"{what} takes 3-d unfolds, got {tuple(lr.shape)} and "
                         f"{tuple(ref.shape)}")
    b, d, _ = lr.shape
    lr_len = ref.shape[1] if ref_rows else ref.shape[2]
    if tuple(ref.shape) != ((b, lr_len, d) if ref_rows else (b, d, lr_len)):
        raise ValueError(f"{what}: reference {tuple(ref.shape)} does not match "
                         f"query {tuple(lr.shape)}")
    if inv_ref is not None and inv_ref.shape != (b, lr_len):
        raise ValueError(f"inv_ref {tuple(inv_ref.shape)} should be [B, Lr]")
    for name, t in (("lr", lr), ("ref", ref), ("inv_ref", inv_ref)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def scaled_reference(ref: torch.Tensor, inv_ref: torch.Tensor) -> torch.Tensor:
    """ref * inv_ref per reference position, in ref's dtype: inv is cast to
    that dtype first and the (exact) f32 product rounded to it, as the TPU
    kernel scales its operand (pallas_corr.py:163)."""
    inv = inv_ref.to(ref.dtype).float()[:, None, :]
    return (ref.float() * inv).to(ref.dtype)


def _first_max(lr: torch.Tensor, ref_rows: torch.Tensor):
    """S[i] = max_k <ref_rows[:, k], lr[:, :, i]> and its first argmax, for
    lr [B, D, L] and ref_rows [B, Lr, D] (any strides), with the [Lr, L]
    product taken CHUNK reference positions at a time in f32."""
    b, _, l = lr.shape
    lf = lr.float()
    best = torch.full((b, l), float("-inf"), device=lr.device)
    best_idx = torch.zeros((b, l), dtype=torch.int64, device=lr.device)
    for q0 in range(0, ref_rows.shape[1], CHUNK):
        r = torch.bmm(ref_rows[:, q0:q0 + CHUNK].float(), lf)   # [B, chunk, L]
        cmax, carg = r.max(dim=1)
        upd = cmax > best
        best = torch.where(upd, cmax, best)
        best_idx = torch.where(upd, carg + q0, best_idx)
    return best, best_idx.to(torch.int32)


def correlation_argmax_lds_plain(lr: torch.Tensor, ref: torch.Tensor,
                                 inv_ref: torch.Tensor):
    """S[i] = max_k <scaled ref[:, k], lr[:, i]> and its first argmax."""
    return _first_max(lr, scaled_reference(ref, inv_ref).transpose(1, 2))


def correlation_argmax_ld_plain(lr: torch.Tensor, ref: torch.Tensor):
    """S[i] = max_k <ref[:, k], lr[:, i]> and its first argmax."""
    return _first_max(lr, ref.transpose(1, 2))


def correlation_argmax_plain(lr_n: torch.Tensor, ref_n: torch.Tensor):
    """S[i] = max_k <ref_n[k], lr_n[:, i]> and its first argmax (port of the
    XLA `correlation_argmax`, speinet_tpu/models/search_transfer.py:63)."""
    return _first_max(lr_n, ref_n)


def _pad8(t: torch.Tensor) -> torch.Tensor:
    """Positions (the last axis) padded to a multiple of 8, since a TMA
    tensor map's row pitch is a multiple of 16 bytes: a copy only where
    needed. The kernel's maps stop at the true length, so it never reads
    the padding."""
    return F.pad(t, (0, -t.shape[2] % 8)) if t.shape[2] % 8 else t


def _corr_unfold(what: str, lr: torch.Tensor, ref: torch.Tensor,
                 inv_ref: torch.Tensor | None):
    """Launch K5 (with inv_ref: the kernel's pre-pass first writes the
    scaled reference into a scratch buffer of ref's padded shape) or K6
    (without) on D-major unfolds."""
    dev = lr.device
    _lib.require_cuda_tensor(lr, "lr", torch.bfloat16, dev)
    _lib.require_cuda_tensor(ref, "ref", torch.bfloat16, dev)
    if inv_ref is not None:
        _lib.require_cuda_tensor(inv_ref, "inv_ref", torch.float32, dev)
    b, d, l = lr.shape
    _check_batch(what, b)
    lr_len = ref.shape[2]
    lr_p, ref_p = _pad8(lr), _pad8(ref)
    scratch = None if inv_ref is None else torch.empty_like(ref_p)
    s = torch.empty((b, l), dtype=torch.float32, device=dev)
    idx = torch.empty((b, l), dtype=torch.int32, device=dev)
    lib = _lib.library()
    _lib.check(lib.speinet_corr_unfold(
        lr_p.data_ptr(), ref_p.data_ptr(),
        None if inv_ref is None else inv_ref.data_ptr(),
        None if scratch is None else scratch.data_ptr(), s.data_ptr(),
        idx.data_ptr(), b, d, l, lr_p.shape[2], lr_len, ref_p.shape[2],
        _lib.stream_ptr(lr)), what)
    _lib.LAUNCHES[what] += 1
    return s, idx


def _winning_columns(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [B, D, Lr] at the columns idx [B, L] -> [B, D, L]."""
    return torch.gather(t, 2, idx[:, None, :].expand(-1, t.shape[1], -1))


def _scatter_columns(contrib: torch.Tensor, idx: torch.Tensor,
                     lr_len: int) -> torch.Tensor:
    """zeros [B, D, Lr] f32 with contrib [B, D, L] added at the columns idx."""
    b, d, _ = contrib.shape
    out = torch.zeros((b, d, lr_len), dtype=torch.float32, device=contrib.device)
    return out.scatter_add_(2, idx[:, None, :].expand(-1, d, -1), contrib)


class CorrLds(torch.autograd.Function):
    """K5: S_i = inv_k* <ref_k*, lr_i> (k* the argmax); the scale is part of
    the row, so the product rule gives inv's cotangent (`_corr_lds_bwd`)."""

    @staticmethod
    def forward(ctx, lr, ref, inv_ref):
        if lr.device.type == "cpu":
            s, idx = correlation_argmax_lds_plain(lr, ref, inv_ref)
        else:
            s, idx = _corr_unfold("correlation_argmax_lds", lr, ref, inv_ref)
        ctx.save_for_backward(lr, ref, inv_ref, s, idx)
        ctx.mark_non_differentiable(idx)
        return s, idx

    @staticmethod
    def backward(ctx, gs, _):
        lr, ref, inv_ref, s, idx = ctx.saved_tensors
        idx = idx.long()
        gs = gs.float()
        inv_sel = torch.gather(inv_ref.float(), 1, idx)
        w = (inv_sel * gs)[:, None, :]
        d_lr = d_ref = d_inv = None
        if ctx.needs_input_grad[0]:
            d_lr = (_winning_columns(ref, idx).float() * w).to(lr.dtype)
        if ctx.needs_input_grad[1]:
            d_ref = _scatter_columns(lr.float() * w, idx, ref.shape[2]).to(ref.dtype)
        if ctx.needs_input_grad[2]:
            # <ref_k*, lr_i> = S_i / inv_k*; inv > 0 always (1 / max(norm, eps))
            d_inv = torch.zeros(inv_ref.shape, dtype=torch.float32,
                                device=inv_ref.device)
            d_inv.scatter_add_(1, idx, s / torch.clamp(inv_sel, min=1e-30) * gs)
            d_inv = d_inv.to(inv_ref.dtype)
        return d_lr, d_ref, d_inv


class CorrLd(torch.autograd.Function):
    """K6: S_i = <ref_k*, lr_i> on a reference scaled outside (`_corr_ld_bwd`)."""

    @staticmethod
    def forward(ctx, lr, ref):
        if lr.device.type == "cpu":
            s, idx = correlation_argmax_ld_plain(lr, ref)
        else:
            s, idx = _corr_unfold("correlation_argmax_ld", lr, ref, None)
        ctx.save_for_backward(lr, ref, idx)
        ctx.mark_non_differentiable(idx)
        return s, idx

    @staticmethod
    def backward(ctx, gs, _):
        lr, ref, idx = ctx.saved_tensors
        idx = idx.long()
        w = gs.float()[:, None, :]
        d_lr = d_ref = None
        if ctx.needs_input_grad[0]:
            d_lr = (_winning_columns(ref, idx).float() * w).to(lr.dtype)
        if ctx.needs_input_grad[1]:
            d_ref = _scatter_columns(lr.float() * w, idx, ref.shape[2]).to(ref.dtype)
        return d_lr, d_ref


class CorrRows(torch.autograd.Function):
    """K7: S_i = <ref_n[k*], lr_n[:, i]>, the reference as rows (`_corr_bwd`)."""

    @staticmethod
    def forward(ctx, lr_n, ref_n):
        if lr_n.device.type == "cpu":
            s, idx = correlation_argmax_plain(lr_n, ref_n)
        else:
            s, idx = _corr_rows(lr_n, ref_n)
        ctx.save_for_backward(lr_n, ref_n, idx)
        ctx.mark_non_differentiable(idx)
        return s, idx

    @staticmethod
    def backward(ctx, gs, _):
        lr_n, ref_n, idx = ctx.saved_tensors
        b, lr_len, d = ref_n.shape
        idx = idx.long()
        w = gs.float()[:, :, None]                                  # [B, L, 1]
        d_lr = d_ref = None
        if ctx.needs_input_grad[0]:
            sel = torch.gather(ref_n, 1, idx[:, :, None].expand(-1, -1, d))
            d_lr = (sel.float() * w).transpose(1, 2).to(lr_n.dtype)
        if ctx.needs_input_grad[1]:
            flat = (idx + torch.arange(b, device=idx.device)[:, None] * lr_len)
            d_ref = torch.zeros((b * lr_len, d), dtype=torch.float32,
                                device=ref_n.device)
            d_ref.index_add_(0, flat.reshape(-1),
                             (lr_n.float().transpose(1, 2) * w).reshape(-1, d))
            d_ref = d_ref.view(b, lr_len, d).to(ref_n.dtype)
        return d_lr, d_ref


def correlation_argmax_lds(lr: torch.Tensor, ref: torch.Tensor,
                           inv_ref: torch.Tensor):
    """lr [B, D, L], ref [B, D, Lr] raw unfolds, inv_ref [B, Lr] f32
    -> (S [B, L] f32, idx [B, L] int32) of max_k <bf16(ref_k * inv_k), lr_i>."""
    _check_unfold_args("correlation_argmax_lds", lr, ref, False, inv_ref)
    _lib.dispatch_device(lr, "correlation_argmax_lds")
    return CorrLds.apply(lr, ref, inv_ref)


def correlation_argmax_ld(lr: torch.Tensor, ref: torch.Tensor):
    """lr [B, D, L], ref [B, D, Lr] (already scaled, `scaled_reference`)
    -> (S [B, L] f32, idx [B, L] int32) of max_k <ref_k, lr_i>."""
    _check_unfold_args("correlation_argmax_ld", lr, ref, False)
    _lib.dispatch_device(lr, "correlation_argmax_ld")
    return CorrLd.apply(lr, ref)


def _corr_rows(lr_n: torch.Tensor, ref_n: torch.Tensor):
    """Launch K7 on a [B, D, L] query and [B, Lr, D] reference rows."""
    dev = lr_n.device
    _lib.require_cuda_tensor(lr_n, "lr_n", torch.bfloat16, dev)
    _lib.require_cuda_tensor(ref_n, "ref_n", torch.bfloat16, dev)
    b, d, l = lr_n.shape
    _check_batch("correlation_argmax", b)
    if d % 8:
        raise ValueError(f"correlation_argmax kernel takes a depth that is a "
                         f"multiple of 8 (16-byte reference rows), got {d}")
    lr_p = _pad8(lr_n)
    s = torch.empty((b, l), dtype=torch.float32, device=dev)
    idx = torch.empty((b, l), dtype=torch.int32, device=dev)
    lib = _lib.library()
    _lib.check(lib.speinet_corr_rows(lr_p.data_ptr(), ref_n.data_ptr(),
                                     s.data_ptr(), idx.data_ptr(), b, d, l,
                                     lr_p.shape[2], ref_n.shape[1],
                                     _lib.stream_ptr(lr_n)), "correlation_argmax")
    _lib.LAUNCHES["correlation_argmax"] += 1
    return s, idx


def correlation_argmax(lr_n: torch.Tensor, ref_n: torch.Tensor):
    """lr_n [B, D, L] (columns L2-normalized), ref_n [B, Lr, D] (rows
    L2-normalized) -> (S [B, L] f32, idx [B, L] int32) of max_k
    <ref_n[k], lr_n[:, i]>."""
    _check_unfold_args("correlation_argmax", lr_n, ref_n, True)
    _lib.dispatch_device(lr_n, "correlation_argmax")
    return CorrRows.apply(lr_n, ref_n)
