#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (`speinet_tpu_torch`) on one
NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card and the CUDA
toolkit. In order it:
1. builds the ten hand-written kernels (K1-K10) from
   `speinet_tpu_torch/csrc/`, one nvcc per source, all started together;
2. holds each kernel against its plain PyTorch version on the card, in
   bf16 at the shapes of the 720p paths (and K1 at the two convs of the
   `--n_feat 64` encoder whose rows are staged in channel groups, K4 at
   that model's 256-channel lv3 map), and
   times kernel, plain version and (where one PyTorch call computes the
   same function) the library call, beside the least time the card could
   take; K6 must equal K5 bit for bit on the same operands, and the checks
   of K2 and K8 must reject two planted faults each; for reference it also
   times one cuBLAS bf16 bmm of the unfold correlation's product shape and
   one cuBLAS bf16 matmul per weight product of K8 and K9;
3. runs four main paths on a synthetic 12-frame 1280x720 video at the full
   width of the SPEINet template (n_feat 32, embed_dim 256, depths 6x6, 8
   heads, window 5, bf16) with seeded random weights and 2 windows per
   chunk, so 'sharp', 'self' and a mixed chunk all occur:
   - `cached`: the cached engine (K1-K5, K10; the mixed chunk is one
     'mixed' restore through K5);
   - `direct`: the direct engine (SPEINet.forward, per-sample routing
     through K5);
   - `split`: the cached engine with swin_fuse_block=False, corr_raw=False
     (K8 + K9 per Swin block, normalized unfolds through K7);
   - `prescaled`: the cached engine with corr_banded=False,
     corr_scaled=False (host-scaled unfolds through K6);
   the last three must agree with the cached engine's frames at 40 dB or
   more; the launch counts of each run, reset just before it, show every
   kernel of its path was launched and none of the path it replaces;
4. checks the port on the card against the port's float32 plain path on
   the CPU, same weights, at 80x80: the cached restore in both routings,
   the direct forward on a mixed batch, the self-ensemble and the chopped
   forward, then the restores and the mixed forward of the `split`
   configuration; the direct forward of a `--n_feat 64` model (Swin depth
   cut to 2 blocks); the restores and the mixed forward at n_sequence 5 and
   at n_sequence 1 (`nseq1`, untimed); and the sharpness detector's labels
   of the video;
   then the same at n_sequence 5 (`nseq5_cached`, `nseq5_direct`: four
   neighbour streams per restore), whose two engines must agree at 40 dB on
   the windows the JAX package's two engines route alike (its direct
   engine routes on frame 3, a blurry neighbour at that length);
5. trains: `Trainer.train()` for one epoch (4 steps) at the full width of
   the template and its batch of 20 at patch 200, in bf16, on a synthetic
   in-memory tree (no image files, no plots), then `Trainer.test()` on two
   windows; the launch counts of the epoch, reset just before it, must show
   K3 forward and backward, K5 and K10, and none of the kernels without a
   backward (K1, K2, K4, K6-K9); losses finite, weights and BatchNorm
   running statistics moved; three more steps are timed (ms per step,
   frames/s, peak memory); then the card's bf16 train step against the
   CPU's f32 one at 80x80 (Swin depth 2), which must also reject a planted
   fault (K3's backward with the shift not negated), and K3 / K5 / K10 at
   the train step's shapes against their plain versions; then the same
   epoch and card-vs-CPU step (the discriminator one more gradient group,
   no planted fault) with the VGG and GAN plugins (`train_plugins`, loss
   1*L1+2*HEM+0.1*VGG22+0.01*GAN): their loss columns finite, the
   discriminator's weights moved, and a checkpoint giving back the
   discriminator and its Adam state exactly; then `swint`: the same epoch
   and test() with the SWINT template (its steps must launch K3 forward
   and backward and no search kernel, its test() K1, K2 and K3) and its
   card-vs-CPU step, which must reject the planted K3 fault too;
   `swint_cpu`: SWINT's forward on the card against the CPU at 80x80 at
   n_sequence 3, 1 and with swin_fuse_block=False (K8 + K9 launched);
   `detector_train`: the detector's features of GoProRS re-blurred
   synthetic videos on both devices, and the logistic model, a tree and a
   forest fitted on each side's, held to each other; `ops`: the smoothing
   and utility ops on a 720p frame, card against CPU;
6. `k4_grad`: K4 under autograd at the cached restore's shape, 'sharp' and
   'self', and one restore_from_features(train=True) backward at 80x80,
   their K4 launches counted; the 720p gradients against autograd of an
   unfold form where the argmaxes agree, rejecting a planted backward that
   drops the dx shift; the backward timed;
7. `profile`: `--profile`'s torch.profiler trace of a 2-window run of the
   cached engine, which must name the port's kernels;
8. `dist`: the data-parallel paths in a world-size-1 nccl group opened as
   torchrun's processes open theirs: 3 train steps of the template (batch
   20, patch 200) under the group against the same 3 without one, held
   within the no-group steps' own repeat-to-repeat spread (losses,
   parameters, the first step's gradients, running statistics; ms per step
   of both), launching K3 forward and backward, K5 and K10; the cached and
   direct engines on the 720p video under the group against the frames of
   `cached` and `direct` (>= 60 dB; ms per frame); `sharded_conv2d` on
   [2, 720, 1280, 8] against the unsharded conv;
9. `pipeline`: `python -m speinet_tpu_torch.pipeline` on a generated tree
   (2 videos of 30 256x320 frames, template width, 1 epoch of batch 4 at
   patch 200, training under `torch.distributed.run --nproc_per_node 1`):
   every stage exits 0 (its seconds printed), and the inference stage's
   frames are those of the trained model_best, not of a random init;
10. prints the `kernels` JSON line, the card's name and power limit, and as
   the last line {"ok": true, "device": {...}}.

Any failure raises and exits non-zero; without CUDA, or outside a checkout,
it exits non-zero before printing any result. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

PEAK_BF16 = 989e12       # dense bf16 tensor-core FLOP/s, H100 SXM data sheet
PEAK_BYTES = 3.35e12     # HBM3 bytes/s, H100 SXM data sheet


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the operations over the bf16 peak
    and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean ms per call from CUDA events around `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def check_conv(rng_seed: int):
    """K1 at every main-path shape: (x shape, k, Cout, stride)."""
    import torch
    import torch.nn.functional as F
    from speinet_tpu_torch.kernels import conv2d, conv2d_plain

    cases = [
        ("in_conv 5x5 3->32 720x1280", (1, 720, 1280, 3), 5, 32, 1),
        ("lv1 res 5x5 32->32 720x1280", (1, 720, 1280, 32), 5, 32, 1),
        ("enc1 5x5/2 32->64 720x1280", (1, 720, 1280, 32), 5, 64, 2),
        ("lv2 res 5x5 64->64 360x640", (1, 360, 640, 64), 5, 64, 1),
        ("enc2 5x5/2 64->128 360x640", (1, 360, 640, 64), 5, 128, 2),
        ("lv3 res 5x5 128->128 180x320", (1, 180, 320, 128), 5, 128, 1),
        ("search3 3x3 64->64 360x640", (1, 360, 640, 64), 3, 64, 1),
        ("search33 3x3 64->32 720x1280", (1, 720, 1280, 64), 3, 32, 1),
        ("search43 3x3 32->32 720x1280", (1, 720, 1280, 32), 3, 32, 1),
        # --n_feat 64: rows too wide to stage whole (input channels in groups)
        ("n_feat 64 lv3 res 5x5 256->256 2x180x320", (2, 180, 320, 256), 5, 256, 1),
        ("n_feat 64 enc2 5x5/2 128->256 2x360x640", (2, 360, 640, 128), 5, 256, 2),
    ]
    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    rows = []
    for label, shape, k, co, stride in cases:
        cin = shape[-1]
        x = torch.rand(shape, generator=g, device="cuda").to(torch.bfloat16)
        w = ((torch.rand((k, k, cin, co), generator=g, device="cuda") * 2 - 1)
             * (k * k * cin) ** -0.5).to(torch.bfloat16)
        b = (torch.rand((co,), generator=g, device="cuda") * 2 - 1) * 0.1
        out = conv2d(x, w, b, relu=True, stride=stride)
        ref = conv2d_plain(x, w, b, relu=True, stride=stride)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        # both round one f32 sum to bf16: they may differ by one bf16 step
        # (2^-8 relative) where the f32 sums' order flips a rounding
        tol = 2.0 ** -7 * max(scale, 1.0)
        if not err <= tol:
            raise AssertionError(f"conv2d {label}: max err {err} > {tol}")
        xc = x.permute(0, 3, 1, 2)                     # channels_last view
        wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        bb = b.to(torch.bfloat16)
        ms = time_ms(lambda: conv2d(x, w, b, relu=True, stride=stride))
        plain_ms = time_ms(lambda: conv2d_plain(x, w, b, relu=True, stride=stride),
                           iters=3, warmup=1)
        lib_ms = time_ms(lambda: F.conv2d(xc, wc, bb, stride=stride, padding=k // 2))
        ho, wo = out.shape[1:3]
        flops = 2.0 * ho * wo * k * k * cin * co
        bms, by = bound(flops, nbytes(x, w, b, out))
        rows.append(dict(shape=label, max_abs_err=err, tol=tol, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                         bound_by=by, flops=flops))
    return rows


def swin_weights(g, c: int, hidden: int, heads: int):
    import torch
    from speinet_tpu_torch.kernels import SwinBlockWeights
    from speinet_tpu_torch.models.swinir import relative_position_index

    def mat(o, i):
        return ((torch.rand((o, i), generator=g, device="cuda") * 2 - 1)
                * i ** -0.5).to(torch.bfloat16)

    def vec(n, lo, hi):
        return lo + (hi - lo) * torch.rand((n,), generator=g, device="cuda")

    table = (torch.rand((81, heads), generator=g, device="cuda") * 2 - 1) * 0.1
    idx = torch.from_numpy(relative_position_index(5, 5).reshape(-1)).cuda()
    relbias = table[idx].reshape(25, 25, heads).permute(2, 0, 1).contiguous()
    return SwinBlockWeights(
        vec(c, 0.8, 1.2), vec(c, -0.1, 0.1), mat(2 * c, c), vec(2 * c, -0.1, 0.1),
        mat(c, c), vec(c, -0.1, 0.1), mat(c, c), vec(c, -0.1, 0.1), relbias,
        vec(c, 0.8, 1.2), vec(c, -0.1, 0.1), mat(hidden, c), vec(hidden, -0.1, 0.1),
        mat(c, hidden), vec(c, -0.1, 0.1))


def check_swin(rng_seed: int):
    """K2 on one 720p lv3 stream pair [2, 180, 320, 256], shift 0 and 2. The
    check must also reject the kernel run with two planted faults: the
    relative-position bias dropped, and (shift 2) the shift mask dropped."""
    import torch
    from speinet_tpu_torch.kernels import (block_errors, block_errors_pass,
                                          swin_block, swin_block_plain)

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    c, hidden, heads, ws = 256, 512, 8, 5
    b, h, w = 2, 180, 320
    wts = swin_weights(g, c, hidden, heads)
    no_bias = wts._replace(relbias=torch.zeros_like(wts.relbias))
    rows = []
    for shift in (0, 2):
        x = torch.randn((b, h, w, c), generator=g, device="cuda").to(torch.bfloat16)
        y = torch.randn((b, h, w, c), generator=g, device="cuda").to(torch.bfloat16)
        out = swin_block(x, y, wts, ws, shift, 0, 0, heads)
        ref = swin_block_plain(x, y, wts, ws, shift, 0, 0, heads)
        e = block_errors(out, ref, x)
        if not block_errors_pass(e):
            raise AssertionError(f"swin_block shift {shift}: {e}")
        faults = {"no_relbias": swin_block(x, y, no_bias, ws, shift, 0, 0, heads)}
        if shift:     # the kernel takes its mask from `shift` alone
            faults["no_shift_mask"] = swin_block(x, y, wts, ws, 0, 0, 0, heads)
        planted = {k: block_errors(v, ref, x) for k, v in faults.items()}
        for k, fe in planted.items():
            if block_errors_pass(fe):
                raise AssertionError(f"swin_block check accepts planted fault {k}: {fe}")
        ms = time_ms(lambda: swin_block(x, y, wts, ws, shift, 0, 0, heads), iters=5)
        plain_ms = time_ms(lambda: swin_block_plain(x, y, wts, ws, shift, 0, 0, heads),
                           iters=2, warmup=1)
        tokens = b * h * w
        n = ws * ws
        flops = 2.0 * tokens * (4 * c * c + 2 * c * hidden) + 4.0 * tokens * n * c
        wbytes = nbytes(*wts)
        bms, by = bound(flops, nbytes(x, y, out) + wbytes)
        rows.append(dict(shape=f"[2,180,320,256] shift {shift}", **e,
                         planted_faults_rejected=planted, ms=ms,
                         plain_ms=plain_ms, library_ms=None, bound_ms=bms,
                         bound_by=by, flops=flops))
    return rows


def check_roll(rng_seed: int):
    """K3 on [2, 180, 320, 256] bf16 by (2, 2) and back."""
    import torch
    from speinet_tpu_torch.kernels import roll2d, roll2d_plain

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    x = torch.randn((2, 180, 320, 256), generator=g, device="cuda").to(torch.bfloat16)
    rows = []
    for sh in (2, -2):
        out = roll2d(x, sh, sh)
        ref = roll2d_plain(x, sh % 180, sh % 320)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if err != 0.0:
            raise AssertionError(f"roll2d by {sh}: max err {err} (a copy is exact)")
        ms = time_ms(lambda: roll2d(x, sh, sh), iters=20)
        plain_ms = time_ms(lambda: roll2d_plain(x, sh % 180, sh % 320), iters=20)
        lib_ms = time_ms(lambda: torch.roll(x, (-sh, -sh), dims=(1, 2)), iters=20)
        bms, by = bound(0.0, 2 * nbytes(x))
        rows.append(dict(shape=f"[2,180,320,256] by {sh}", max_abs_err=err, tol=0.0,
                         ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bms, bound_by=by))
    return rows


def check_corr(rng_seed: int):
    """K4 at 720p lv3: B=1 with the 'sharp' reference and the transposed
    'self', both at C = 128, and the `--n_feat 64` lv3 map (C = 256,
    'sharp'). Each row also times the wrapper's glue alone (the padded flat
    copies of both maps and the (inv, mask) rows)."""
    import torch
    import torch.nn.functional as F
    from speinet_tpu_torch.kernels import banded_corr_argmax, banded_corr_argmax_plain
    from speinet_tpu_torch.kernels.corr import banded_aux, banded_layout, banded_plan
    from speinet_tpu_torch.models.search_transfer import patch_inv_norms

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    h, w = 180, 320
    rows = []
    for routing, c in (("sharp", 128), ("self", 128), ("sharp", 256)):
        f = torch.rand((1, h, w, c), generator=g, device="cuda").to(torch.bfloat16)
        if routing == "sharp":
            ref = torch.rand((1, h, w, c), generator=g, device="cuda").to(torch.bfloat16)
        else:
            ref = torch.flip(f.transpose(1, 2), dims=(1,)).contiguous()
        inv = patch_inv_norms(ref).contiguous()
        s, idx = banded_corr_argmax(f, ref, inv)
        s_p, idx_p = banded_corr_argmax_plain(f, ref, inv)
        torch.cuda.synchronize()
        lu = F.unfold(f.permute(0, 3, 1, 2).float(), 3, padding=1)[0]
        ru = F.unfold(ref.permute(0, 3, 1, 2).float(), 3, padding=1)[0]
        err, tol, nd = _corr_rule(f"corr {routing} C={c}", s, idx, s_p, idx_p,
                                  lambda bi, p, k: (lu[:, p] * ru[:, k]).sum(0)
                                  * inv[0, k])
        del lu, ru
        hr, wr = ref.shape[1:3]
        n_kt = banded_plan(hr, wr)
        glue_ms = time_ms(lambda: (banded_layout(f), banded_layout(ref),
                                   banded_aux(inv, hr, wr, n_kt)), iters=10)
        ms = time_ms(lambda: banded_corr_argmax(f, ref, inv), iters=5, warmup=1)
        plain_ms = time_ms(lambda: banded_corr_argmax_plain(f, ref, inv),
                           iters=1, warmup=1)
        l = h * w
        flops = 2.0 * 3 * l * l * c     # the banded form's work
        bms, by = bound(flops, nbytes(f, ref, inv, s, idx))
        rows.append(dict(shape=f"{routing} F[1,{h},{w},{c}] G{list(ref.shape)}",
                         max_abs_err=err, tol=tol, idx_differs=nd, ms=ms,
                         glue_ms=glue_ms, plain_ms=plain_ms, library_ms=None,
                         bound_ms=bms, bound_by=by, flops=flops,
                         tflops=flops / ms / 1e9))
    return rows


def check_corr_unfold(rng_seed: int):
    """K5 on mixed batches (sample 0 searches a sharp map's unfold, sample 1
    the permuted self reference) at 720p lv3 and at a chop tile's lv3."""
    import torch
    from speinet_tpu_torch.kernels import (correlation_argmax_lds,
                                          correlation_argmax_lds_plain)
    from speinet_tpu_torch.kernels.corr import scaled_reference
    from speinet_tpu_torch.models.search_transfer import (unfold_reference,
                                                          patch_inv_norms)

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    has_sharp = torch.tensor([True, False], device="cuda")
    rows = []
    for h, w in ((180, 320), (95, 165)):
        f = torch.rand((2, h, w, 128), generator=g, device="cuda").to(torch.bfloat16)
        sharp = torch.rand((2, h, w, 128), generator=g, device="cuda").to(torch.bfloat16)
        lr, ref, inv = unfold_reference(f, sharp, "mixed", has_sharp,
                                        patch_inv_norms(f))
        lr, ref, inv = lr.contiguous(), ref.contiguous(), inv.contiguous()
        s, idx = correlation_argmax_lds(lr, ref, inv)
        s_p, idx_p = correlation_argmax_lds_plain(lr, ref, inv)
        torch.cuda.synchronize()
        err = (s - s_p).abs().max().item()
        # the same bf16 operands (the scale rounded alike), f32 sums of
        # D = 1152 products in another order
        tol = 1e-5 * max(s_p.abs().max().item(), 1.0)
        if not err <= tol:
            raise AssertionError(f"corr_unfold {h}x{w}: max |S err| {err} > {tol}")
        # an index may differ only where it attains the max within tol
        diff = (idx != idx_p).nonzero()
        if diff.numel():
            bi, p = diff[:, 0], diff[:, 1]
            q = idx[bi, p].long()
            sc = scaled_reference(ref, inv)
            at_k = (lr[bi, :, p].float() * sc[bi, :, q].float()).sum(1)
            gap = (at_k - s_p[bi, p]).abs().max().item()
            if not gap <= tol:
                raise AssertionError(f"corr_unfold {h}x{w}: index off the max by {gap}")
        ms = time_ms(lambda: correlation_argmax_lds(lr, ref, inv), iters=3, warmup=1)
        plain_ms = time_ms(lambda: correlation_argmax_lds_plain(lr, ref, inv),
                           iters=1, warmup=1)
        b, d, l = lr.shape
        flops = 2.0 * b * l * ref.shape[2] * d
        bms, by = bound(flops, nbytes(lr, ref, inv, s, idx))
        rows.append(dict(shape=f"mixed B=2 D=1152 L=Lr={l} ({h}x{w}x128)",
                         max_abs_err=err, tol=tol, idx_differs=int(diff.shape[0]),
                         ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bms,
                         bound_by=by, flops=flops,
                         tflops=flops / ms / 1e9))
    return rows


def bmm_reference(rng_seed: int):
    """For reference only (no kernel of the port calls it): one cuBLAS bf16
    `torch.bmm` of the plain version's reference-chunk product at 720p lv3,
    [2, 2048, 1152] x [2, 1152, 57600], without the max: what the tensor
    cores sustain at this depth."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    a = torch.rand((2, 2048, 1152), generator=g, device="cuda").to(torch.bfloat16)
    b = torch.rand((2, 1152, 57600), generator=g, device="cuda").to(torch.bfloat16)
    ms = time_ms(lambda: torch.bmm(a, b))
    flops = 2.0 * 2 * 2048 * 1152 * 57600
    return dict(shape="bmm [2, 2048, 1152] x [2, 1152, 57600] bf16", ms=ms,
                tflops=flops / ms / 1e9)


def swin_matmul_references(rng_seed: int):
    """For reference only (no kernel of the port calls them): one cuBLAS bf16
    `torch.matmul` per weight product of K8 (Q, K | V, proj) and of K9 (fc1,
    fc2) at the check shapes (115,200 token rows, C 256, hidden 512): what
    the tensor cores sustain on each product alone, without the LayerNorms,
    the attention and the epilogues the kernels fuse around them."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    rows = 2 * 180 * 320
    out = {}
    for kernel, prods in (("window_cross_attention", (("q", 256, 256), ("kv", 256, 512),
                                                      ("proj", 256, 256))),
                          ("ln_mlp", (("fc1", 256, 512), ("fc2", 512, 256)))):
        lines = []
        for name, k, n in prods:
            a = torch.rand((rows, k), generator=g, device="cuda").to(torch.bfloat16)
            b = torch.rand((k, n), generator=g, device="cuda").to(torch.bfloat16)
            ms = time_ms(lambda: torch.matmul(a, b))
            flops = 2.0 * rows * k * n
            lines.append(dict(product=name, shape=f"[{rows}, {k}] x [{k}, {n}] bf16",
                              ms=ms, tflops=flops / ms / 1e9))
        out[kernel] = dict(products=lines, ms=sum(r["ms"] for r in lines))
    return out


def _corr_rule(what, s, idx, s_p, idx_p, score_at):
    """K4's rule: S within 1e-5 of its scale (the same bf16 products summed
    in f32 in another order); an index may differ from the plain version's
    only where it attains the max within that. Returns (err, tol, number of
    differing indices)."""
    err = (s - s_p).abs().max().item()
    tol = 1e-5 * max(s_p.abs().max().item(), 1.0)
    if not err <= tol:
        raise AssertionError(f"{what}: max |S err| {err} > {tol}")
    diff = (idx != idx_p).nonzero()
    if diff.numel():
        bi, p = diff[:, 0], diff[:, 1]
        gap = (score_at(bi, p, idx[bi, p].long()) - s_p[bi, p]).abs().max().item()
        if not gap <= tol:
            raise AssertionError(f"{what}: index off the max by {gap}")
    return err, tol, int(diff.shape[0])


def _mixed_maps(g, h, w):
    """A query map and a sharp map at the lv3 of an h x w map pair, and the
    mixed batch's flags (sample 0 sharp, sample 1 self)."""
    import torch

    f = torch.rand((2, h, w, 128), generator=g, device="cuda").to(torch.bfloat16)
    sharp = torch.rand((2, h, w, 128), generator=g, device="cuda").to(torch.bfloat16)
    return f, sharp, torch.tensor([True, False], device="cuda")


def check_corr_ld(rng_seed: int):
    """K6 on the host-scaled mixed batch of check_corr_unfold: S and idx
    equal to K5's on the raw operands, and K4's rule against its plain
    version."""
    import torch
    from speinet_tpu_torch.kernels import (correlation_argmax_ld,
                                          correlation_argmax_ld_plain,
                                          correlation_argmax_lds)
    from speinet_tpu_torch.kernels.corr import scaled_reference
    from speinet_tpu_torch.models.search_transfer import (patch_inv_norms,
                                                          unfold_reference)

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    rows = []
    for h, w in ((180, 320), (95, 165)):
        f, sharp, hs = _mixed_maps(g, h, w)
        lr, ref, inv = (t.contiguous() for t in unfold_reference(
            f, sharp, "mixed", hs, patch_inv_norms(f)))
        sc = scaled_reference(ref, inv)
        s, idx = correlation_argmax_ld(lr, sc)
        s5, idx5 = correlation_argmax_lds(lr, ref, inv)
        s_p, idx_p = correlation_argmax_ld_plain(lr, sc)
        torch.cuda.synchronize()
        if not (torch.equal(s, s5) and torch.equal(idx, idx5)):
            raise AssertionError(f"corr_ld {h}x{w}: K6 on the scaled reference "
                                 f"differs from K5 on the raw one")
        err, tol, nd = _corr_rule(f"corr_ld {h}x{w}", s, idx, s_p, idx_p,
                                  lambda bi, p, k: (lr[bi, :, p].float()
                                                    * sc[bi, :, k].float()).sum(1))
        ms = time_ms(lambda: correlation_argmax_ld(lr, sc), iters=3, warmup=1)
        plain_ms = time_ms(lambda: correlation_argmax_ld_plain(lr, sc),
                           iters=1, warmup=1)
        b, d, l = lr.shape
        flops = 2.0 * b * l * sc.shape[2] * d
        bms, by = bound(flops, nbytes(lr, sc, s, idx))
        rows.append(dict(shape=f"mixed B=2 D=1152 L=Lr={l} ({h}x{w}x128)",
                         equal_to_k5=True, max_abs_err=err, tol=tol,
                         idx_differs=nd, ms=ms, plain_ms=plain_ms, library_ms=None,
                         bound_ms=bms, bound_by=by, flops=flops,
                         tflops=flops / ms / 1e9))
    return rows


def check_corr_rows(rng_seed: int):
    """K7 on L2-normalized mixed batches (sample 0 against a sharp map,
    sample 1 against its self reference), the reference as [B, Lr, D]."""
    import torch
    from speinet_tpu_torch.kernels import correlation_argmax, correlation_argmax_plain
    from speinet_tpu_torch.models.search_transfer import normalized_reference

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    rows = []
    for h, w in ((180, 320), (95, 165)):
        f, sharp, hs = _mixed_maps(g, h, w)
        lr_n, ref_n = normalized_reference(f, sharp, "mixed", hs)
        lr_n = lr_n.to(torch.bfloat16).contiguous()
        ref_n = ref_n.to(torch.bfloat16).contiguous()
        s, idx = correlation_argmax(lr_n, ref_n)
        s_p, idx_p = correlation_argmax_plain(lr_n, ref_n)
        torch.cuda.synchronize()
        err, tol, nd = _corr_rule(f"corr_rows {h}x{w}", s, idx, s_p, idx_p,
                                  lambda bi, p, k: (lr_n[bi, :, p].float()
                                                    * ref_n[bi, k].float()).sum(1))
        ms = time_ms(lambda: correlation_argmax(lr_n, ref_n), iters=3, warmup=1)
        plain_ms = time_ms(lambda: correlation_argmax_plain(lr_n, ref_n),
                           iters=1, warmup=1)
        b, d, l = lr_n.shape
        flops = 2.0 * b * l * ref_n.shape[1] * d
        bms, by = bound(flops, nbytes(lr_n, ref_n, s, idx))
        rows.append(dict(shape=f"mixed B=2 D=1152 L=Lr={l} ({h}x{w}x128), "
                               f"ref [B, Lr, D]",
                         max_abs_err=err, tol=tol, idx_differs=nd, ms=ms,
                         plain_ms=plain_ms, library_ms=None, bound_ms=bms,
                         bound_by=by, flops=flops,
                         tflops=flops / ms / 1e9))
    return rows


def check_attn(rng_seed: int):
    """K8 on one 720p lv3 stream pair [2, 180, 320, 256], shift 0 and 2, held
    as K2 is with x = 0 (the output is all update, so its errors are
    measured against the output's own scale). The check must reject the
    same two planted faults as K2's."""
    import torch
    from speinet_tpu_torch.kernels import (block_errors, block_errors_pass,
                                          window_cross_attention,
                                          window_cross_attention_plain)

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    c, hidden, heads, ws = 256, 512, 8, 5
    b, h, w = 2, 180, 320
    wts = swin_weights(g, c, hidden, heads)
    no_bias = wts._replace(relbias=torch.zeros_like(wts.relbias))
    rows = []
    for shift in (0, 2):
        x = torch.randn((b, h, w, c), generator=g, device="cuda").to(torch.bfloat16)
        y = torch.randn((b, h, w, c), generator=g, device="cuda").to(torch.bfloat16)
        out = window_cross_attention(x, y, wts, ws, shift, 0, 0, heads)
        ref = window_cross_attention_plain(x, y, wts, ws, shift, 0, 0, heads)
        zero = torch.zeros_like(ref)
        e = block_errors(out, ref, zero)
        if not block_errors_pass(e):
            raise AssertionError(f"window_cross_attention shift {shift}: {e}")
        faults = {"no_relbias": window_cross_attention(x, y, no_bias, ws, shift, 0,
                                                       0, heads)}
        if shift:     # the kernel takes its mask from `shift` alone
            faults["no_shift_mask"] = window_cross_attention(x, y, wts, ws, 0, 0, 0,
                                                             heads)
        planted = {k: block_errors(v, ref, zero) for k, v in faults.items()}
        for k, fe in planted.items():
            if block_errors_pass(fe):
                raise AssertionError(f"window_cross_attention check accepts "
                                     f"planted fault {k}: {fe}")
        ms = time_ms(lambda: window_cross_attention(x, y, wts, ws, shift, 0, 0, heads),
                     iters=5)
        plain_ms = time_ms(lambda: window_cross_attention_plain(
            x, y, wts, ws, shift, 0, 0, heads), iters=2, warmup=1)
        tokens = b * h * w
        flops = 2.0 * tokens * 4 * c * c + 4.0 * tokens * ws * ws * c
        attn_w = [wts.ln1_w, wts.ln1_b, wts.wkv, wts.bkv, wts.wq, wts.bq, wts.wp,
                  wts.bp, wts.relbias]
        bms, by = bound(flops, nbytes(x, y, out, *attn_w))
        rows.append(dict(shape=f"[2,180,320,256] shift {shift}", **e,
                         planted_faults_rejected=planted, ms=ms,
                         plain_ms=plain_ms, library_ms=None, bound_ms=bms,
                         bound_by=by, flops=flops))
    return rows


def check_mlp(rng_seed: int):
    """K9 on the 720p lv3 token rows [2, 57600, 256], hidden 512, held to
    the update (out - x) as K2 is."""
    import torch
    from speinet_tpu_torch.kernels import (block_errors, block_errors_pass, ln_mlp,
                                          ln_mlp_plain)

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    c, hidden, heads = 256, 512, 8
    wts = swin_weights(g, c, hidden, heads)
    x = torch.randn((2, 57600, c), generator=g, device="cuda").to(torch.bfloat16)
    out = ln_mlp(x, wts)
    ref = ln_mlp_plain(x, wts)
    e = block_errors(out, ref, x)
    if not block_errors_pass(e):
        raise AssertionError(f"ln_mlp: {e}")
    ms = time_ms(lambda: ln_mlp(x, wts), iters=5)
    plain_ms = time_ms(lambda: ln_mlp_plain(x, wts), iters=2, warmup=1)
    flops = 4.0 * x.shape[0] * x.shape[1] * c * hidden
    mlp_w = [wts.ln2_w, wts.ln2_b, wts.w1, wts.b1, wts.w2, wts.b2]
    bms, by = bound(flops, nbytes(x, out, *mlp_w))
    return [dict(shape="[2,57600,256] hidden 512", **e, ms=ms, plain_ms=plain_ms,
                 library_ms=None, bound_ms=bms, bound_by=by, flops=flops)]


def check_gather(rng_seed: int):
    """K10 at the gather-fold's shapes: the one-tile-padded tile rows of the
    three sharp levels side by side ([B, (H+2)(W+2), 896] bf16) and the nine
    shifted tile indices of every lv3 position, at B = 2 720p and at a chop
    tile's lv3; bit-exact against its plain version. The library call is
    the advanced indexing the port used before K10 (it is the plain version
    too)."""
    import torch
    from speinet_tpu_torch.kernels import row_gather, row_gather_plain
    from speinet_tpu_torch.ops.patch_ops import _shift9_flat

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    r = 128 + 4 * 64 + 16 * 32
    rows_out = []
    for h, w in ((180, 320), (95, 165)):
        rows = torch.randn((2, (h + 2) * (w + 2), r), generator=g,
                           device="cuda").to(torch.bfloat16)
        index = torch.randint(0, h * w, (2, h * w), generator=g, device="cuda")
        flat = _shift9_flat(index, h, w).contiguous()
        out = row_gather(rows, flat)
        ref = row_gather_plain(rows, flat)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"row_gather {h}x{w}: not an exact copy")
        ms = time_ms(lambda: row_gather(rows, flat), iters=10)
        plain_ms = time_ms(lambda: row_gather_plain(rows, flat), iters=10)
        bidx = torch.arange(2, device="cuda")[:, None]
        lib_ms = time_ms(lambda: rows[bidx, flat], iters=10)
        bms, by = bound(0.0, nbytes(rows, flat, out))
        rows_out.append(dict(shape=f"rows [2,{rows.shape[1]},{r}] idx [2,{flat.shape[1]}]"
                                   f" ({h}x{w} lv3)",
                             max_abs_err=0.0, tol=0.0, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bms, bound_by=by))
    return rows_out


def synthetic_video(n: int, h: int, w: int, seed: int):
    """n uint8 HxWx3 frames: smooth moving patterns plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for i in range(n):
        base = (127 + 70 * np.sin(xx / 37.0 + 0.3 * i) * np.cos(yy / 29.0)
                + 30 * np.sin((xx + yy) / 11.0 - 0.2 * i))
        img = np.stack([base, 0.9 * base + 10, 0.8 * base + 20], -1)
        img += 6 * rng.standard_normal((h, w, 1)).astype(np.float32)
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


def run_main_path(cfg, frames, cache_pyramids: bool, **paths):
    """One engine (with the kernel-path switches `paths`) on a synthetic
    video with sharp labels at its first and last frame (12 frames, 2 per
    chunk: sharp x3, mixed, self x2). Returns (inference, launch counts of
    the run, wall s, psnr, ssim, outputs), outputs the restored frames
    [3, H, W] f32 on the CPU by name."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from speinet_tpu_torch.infer import Inference
    from speinet_tpu_torch.kernels import LAUNCHES, reset_launches

    n_frames = len(frames)
    keys = [f"synthetic/{i:08d}" for i in range(n_frames)]
    store = dict(zip(keys, frames))
    labels = np.zeros(n_frames, np.int64)
    labels[[0, n_frames - 1]] = 1
    outputs = {}
    with tempfile.TemporaryDirectory() as res:
        inf = Inference(cfg, data_path=res, model_path="", result_path=res,
                        save_image=False, batch_windows=2,
                        cache_pyramids=cache_pyramids, device="cuda", seed=0,
                        **paths)
        score = inf._score_chunk

        def keep(v, names, out, *args):
            for k, name in enumerate(names):
                outputs[name] = out[k].float().cpu()
            return score(v, names, out, *args)

        inf._score_chunk = keep
        try:
            with ThreadPoolExecutor(max_workers=4) as pool:
                # warm-up chunk: first-use costs (allocator, cuDNN plans)
                inf.infer_video("warmup", keys[:3], keys[:3], labels[:3],
                                store.__getitem__, pool)
                for k in inf.stage_seconds:
                    inf.stage_seconds[k] = 0.0
                reset_launches()
                t0 = time.time()
                psnr, ssim = inf.infer_video("synthetic", keys, keys, labels,
                                             store.__getitem__, pool)
                wall = time.time() - t0
                counts = dict(LAUNCHES)
        finally:
            inf.close()
    if len(psnr) != n_frames or not all(np.isfinite(psnr)) \
            or not all(np.isfinite(ssim)):
        raise AssertionError(f"engine output not finite: {psnr} {ssim}")
    return inf, counts, wall, psnr, ssim, outputs


def psnr_db(a, b, peak: float = 1.0) -> float:
    """PSNR of two float images clamped to [0, peak]."""
    import math

    mse = ((a.clamp(0, peak) - b.clamp(0, peak)) ** 2).mean().item()
    return 10 * math.log10(peak * peak / max(mse, 1e-20))


def small_frames(n: int = 5):
    """n synthetic 80x80 frames [n, 3, 80, 80] in [0, 1] on the CPU."""
    import numpy as np
    import torch

    return torch.from_numpy(np.stack(
        [f.transpose(2, 0, 1) for f in synthetic_video(n, 80, 80, seed=2)])
    ).float() / 255.0


def mixed_batch(frames):
    """[2, T, 3, H, W]: the window, and the same with the routing frame
    zeroed (the 'self' routing): frame 3, or the last frame of a 3-frame
    window (n_sequence 1), as the model reads it."""
    import torch

    blind = frames.clone()
    blind[min(3, len(frames) - 1)] = 0.0
    return torch.stack([frames, blind])


def compare_to_cpu(name, gpu_o, cpu_o):
    import torch

    if not torch.isfinite(gpu_o).all():
        raise AssertionError(f"{name}: card output not finite")
    psnr = psnr_db(gpu_o, cpu_o)
    # bf16 through 36 Swin blocks and ~30 ResBlocks against f32: the
    # outputs must agree to well above the rounding noise floor
    if not psnr > 30.0:
        raise AssertionError(f"{name}: card vs CPU PSNR {psnr:.2f} dB")
    return dict(max_abs_diff=(gpu_o - cpu_o).abs().max().item(), psnr_vs_cpu_f32=psnr)


def check_wide(cfg):
    """The `--n_feat 64` model (256 channels at lv3, D = 2304 unfolds; the
    Swin depth cut to one stage of 2 blocks) on the card in bf16 against
    its f32 CPU path, same seeded weights: the direct forward on the mixed
    80x80 batch, in which K1 stages the input channels of the 5x5 256->256
    and 5x5/2 128->256 convs in groups."""
    import torch
    from speinet_tpu_torch.kernels import LAUNCHES, reset_launches
    from speinet_tpu_torch.models.speinet import SPEINet, init_weights

    wide = cfg.replace(n_feat=64, depths=[2], num_heads=[8])
    gpu = SPEINet.from_config(wide)
    init_weights(gpu, 0)
    gpu.to("cuda").eval()
    cpu = SPEINet.from_config(wide.replace(compute_dtype="float32"))
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    cpu.eval()
    x = mixed_batch(small_frames())
    reset_launches()
    with torch.inference_mode():
        out = gpu(x.cuda()).float().cpu()
        counts = dict(LAUNCHES)
        ref = cpu(x)
    for k in ("conv2d", "swin_block", "correlation_argmax_lds"):
        if counts[k] <= 0:
            raise AssertionError(f"n_feat 64 forward: {k} not launched")
    return dict(forward_mixed=compare_to_cpu("n_feat 64 forward_mixed", out, ref),
                launches=counts)


def check_against_cpu(cfg, card_model, full: bool = True, **paths):
    """The card (kernels, bf16) against the CPU plain path (f32), same
    weights, window length and kernel-path switches `paths`, at 80x80: the
    cached restore of one window in both host routings (the centre's
    features and every neighbour's), and on a mixed batch (sample 1 has its
    routing frame zeroed) the direct forward and, if `full`, the 8-way
    self-ensemble and the chopped forward."""
    import torch
    from speinet_tpu_torch.infer import forward_x8
    from speinet_tpu_torch.models.speinet import SPEINet
    from speinet_tpu_torch.parallel.chop import chop_forward

    cpu = SPEINet.from_config(cfg.replace(compute_dtype="float32"), **paths)
    cpu.load_state_dict({k: v.cpu() for k, v in card_model.state_dict().items()})
    cpu.eval()
    ns = cfg.n_sequence
    mid = ns // 2
    frames = small_frames(ns + 2)
    results = {}

    def compare(name, gpu_o, cpu_o):
        results[name] = compare_to_cpu(name, gpu_o, cpu_o)

    for routing in ("sharp", "self"):
        outs = []
        for model, dev in ((card_model, "cuda"), (cpu, "cpu")):
            fr = frames.to(dev)
            m, n = model.encode_window_legs(fr[:ns])
            p1, p2, p3 = model.anchor_pyramid(fr[ns + 1:ns + 2])
            o = model.restore_from_features(
                m[mid:mid + 1], [n[i:i + 1] for i in range(ns) if i != mid],
                p1, p2, p3, routing)
            outs.append(o.float().cpu())
        compare(f"restore_{routing}", *outs)
    x = mixed_batch(frames)
    runs = [("forward_mixed", lambda m, t: m(t))]
    if full:
        runs += [("forward_x8", lambda m, t: forward_x8(t, m)),
                 ("chop", lambda m, t: chop_forward(m, t, shave=cfg.chop_shave))]
    for name, fn in runs:
        compare(name, fn(card_model, x.cuda()).float().cpu(), fn(cpu, x))
    return results


def check_detector(frames):
    """Labels of the synthetic video from focus features computed on the
    card and on the CPU: features within 1e-4 relative, labels equal
    wherever the margin exceeds what that feature tolerance can move."""
    import numpy as np
    from speinet_tpu_torch.detector.classifier import LogisticRegression
    from speinet_tpu_torch.detector.train import video_features

    det = LogisticRegression.load()
    arr = np.stack(frames)
    f_gpu = video_features(arr, kernel_size=11, device="cuda")
    f_cpu = video_features(arr, kernel_size=11, device="cpu")
    rel = float(np.max(np.abs(f_gpu - f_cpu) / np.maximum(np.abs(f_cpu), 1e-30)))
    if not rel <= 1e-4:
        raise AssertionError(f"detector features: card vs CPU relative diff {rel}")
    m_cpu = det.decision_function(f_cpu)
    slack = (np.abs(det.coef / det.scale) * np.abs(f_cpu) * 1e-4).sum(axis=1)
    sure = np.abs(m_cpu) > slack
    l_gpu, l_cpu = det.predict(f_gpu), det.predict(f_cpu)
    if not np.array_equal(l_gpu[sure], l_cpu[sure]):
        raise AssertionError(f"detector labels differ: {l_gpu} vs {l_cpu}")
    return dict(frames=len(frames), features_max_rel_diff=rel,
                labels_card=l_gpu.tolist(), labels_cpu=l_cpu.tolist(),
                decided_beyond_tolerance=int(sure.sum()))


# --- training -----------------------------------------------------------------

def check_train_shapes(rng_seed: int):
    """The three kernels of the train step at its shapes (the template's
    batch 20 at patch 200: lv3 50x50): K3 on the Swin stream [40, 50, 50, 256]
    bf16, forward and its backward launch (shift negated); K5 on a mixed
    [20, 1152, 2500] batch; K10 on the gather-fold's rows [20, 52*52, 896]
    with [20, 9*2500] indices. Each against its plain version as in the
    inference checks; beside each, the time of its plain PyTorch backward
    where it has one (K5, K10)."""
    import torch
    from speinet_tpu_torch.kernels import (correlation_argmax_lds,
                                          correlation_argmax_lds_plain, roll2d,
                                          roll2d_plain, row_gather, row_gather_plain)
    from speinet_tpu_torch.kernels.corr import CorrLds, scaled_reference
    from speinet_tpu_torch.kernels.gather import row_scatter_add
    from speinet_tpu_torch.models.search_transfer import (patch_inv_norms,
                                                          unfold_reference)
    from speinet_tpu_torch.ops.patch_ops import _shift9_flat

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    rows = {}
    x = torch.randn((40, 50, 50, 256), generator=g, device="cuda").to(torch.bfloat16)
    roll_rows = []
    for what, sh in (("forward", 2), ("backward", -2)):
        out = roll2d(x, sh, sh)
        if not torch.equal(out, roll2d_plain(x, sh % 50, sh % 50)):
            raise AssertionError(f"roll2d train shape {what}: not an exact copy")
        bms, by = bound(0.0, 2 * nbytes(x))
        roll_rows.append(dict(shape=f"[40,50,50,256] by {sh} ({what})", max_abs_err=0.0,
                              ms=time_ms(lambda: roll2d(x, sh, sh), iters=20),
                              plain_ms=time_ms(lambda: roll2d_plain(x, sh % 50, sh % 50),
                                               iters=20),
                              library_ms=time_ms(lambda: torch.roll(
                                  x, (-sh, -sh), dims=(1, 2)), iters=20),
                              bound_ms=bms, bound_by=by))
    rows["roll2d"] = roll_rows

    f = torch.rand((20, 50, 50, 128), generator=g, device="cuda").to(torch.bfloat16)
    sharp = torch.rand((20, 50, 50, 128), generator=g, device="cuda").to(torch.bfloat16)
    hs = torch.arange(20, device="cuda") % 2 == 0
    lr, ref, inv = (t.contiguous() for t in unfold_reference(f, sharp, "mixed", hs,
                                                             patch_inv_norms(f)))
    s, idx = correlation_argmax_lds(lr, ref, inv)
    s_p, idx_p = correlation_argmax_lds_plain(lr, ref, inv)
    sc = scaled_reference(ref, inv)
    err, tol, nd = _corr_rule("corr_unfold train shape", s, idx, s_p, idx_p,
                              lambda bi, p, k: (lr[bi, :, p].float()
                                                * sc[bi, :, k].float()).sum(1))
    b, d, l = lr.shape
    flops = 2.0 * b * l * ref.shape[2] * d
    bms, by = bound(flops, nbytes(lr, ref, inv, s, idx))
    leaves = [t.detach().clone().requires_grad_(True) for t in (lr, ref, inv)]
    gs = torch.randn_like(s)

    def fwd_bwd():
        out, _ = CorrLds.apply(*leaves)
        out.backward(gs)

    fwd_ms = time_ms(lambda: correlation_argmax_lds(lr, ref, inv), iters=3, warmup=1)
    rows["correlation_argmax_lds"] = [dict(
        shape=f"mixed B=20 D=1152 L=Lr={l} (50x50x128)", max_abs_err=err, tol=tol,
        idx_differs=nd, ms=fwd_ms,
        plain_ms=time_ms(lambda: correlation_argmax_lds_plain(lr, ref, inv),
                         iters=1, warmup=1),
        library_ms=None, bound_ms=bms, bound_by=by, flops=flops,
        backward_ms=time_ms(fwd_bwd, iters=3, warmup=1) - fwd_ms)]

    r = 128 + 4 * 64 + 16 * 32
    tiles = torch.randn((20, 52 * 52, r), generator=g, device="cuda").to(torch.bfloat16)
    index = torch.randint(0, 2500, (20, 2500), generator=g, device="cuda")
    flat = _shift9_flat(index, 50, 50).contiguous()
    out = row_gather(tiles, flat)
    if not torch.equal(out, row_gather_plain(tiles, flat)):
        raise AssertionError("row_gather train shape: not an exact copy")
    go = torch.randn_like(out)
    bms, by = bound(0.0, nbytes(tiles, flat, out))
    bidx = torch.arange(20, device="cuda")[:, None]
    rows["row_gather"] = [dict(
        shape=f"rows [20,2704,{r}] idx [20,22500] (50x50 lv3)", max_abs_err=0.0,
        ms=time_ms(lambda: row_gather(tiles, flat), iters=10),
        plain_ms=time_ms(lambda: row_gather_plain(tiles, flat), iters=10),
        library_ms=time_ms(lambda: tiles[bidx, flat], iters=10), bound_ms=bms,
        bound_by=by, backward_ms=time_ms(lambda: row_scatter_add(go, flat, 2704),
                                         iters=5))]
    return rows


def memory_tree(root, videos, frames_per_video: int, h: int, w: int, seed: int):
    """A dataset tree under `root` (gt/, blur/, label/) whose frame files are
    empty: the frames live in memory, keyed by path, for `MemoryVideos`.
    Each ground-truth frame is a synthetic pattern; its blurred input the
    mean of 7 horizontal shifts; every 12th frame is labelled sharp, so
    windows far from one have their pre-sharp frame zeroed (routed 'self')."""
    import os

    import numpy as np

    store = {}
    os.makedirs(os.path.join(root, "label"), exist_ok=True)
    for v in range(videos):
        name = f"video{v:02d}"
        gts = synthetic_video(frames_per_video, h, w, seed=seed + v)
        labels = np.zeros(frames_per_video, np.int64)
        labels[::12] = 1
        np.save(os.path.join(root, "label", name + ".npy"), labels)
        for kind in ("gt", "blur"):
            os.makedirs(os.path.join(root, kind, name))
        for i, gt in enumerate(gts):
            blur = np.mean([np.roll(gt, k, axis=1) for k in range(-3, 4)], axis=0)
            for kind, img in (("gt", gt), ("blur", blur.astype(np.uint8))):
                path = os.path.join(root, kind, name, f"{i:08d}.png")
                open(path, "wb").close()
                store[path] = img
    return store


def memory_data(cfg, train_root: str, test_root: str, store: dict):
    """Train and test loaders (`Data`'s pair) over frames held in memory."""
    from types import SimpleNamespace

    from speinet_tpu_torch.data.loader import BatchIterator
    from speinet_tpu_torch.data.videodata import VideoDataset

    class MemoryVideos(VideoDataset):
        def _imread(self, path):
            return store[path]

    train = MemoryVideos(cfg.replace(dir_data=train_root), train=True)
    test = MemoryVideos(cfg.replace(dir_data_test=test_root), train=False)
    return SimpleNamespace(
        loader_train=BatchIterator(train, cfg.batch_size, shuffle=True, seed=cfg.seed,
                                   n_threads=cfg.n_threads, drop_last=True),
        loader_test=BatchIterator(test, 1, shuffle=False, seed=cfg.seed,
                                  n_threads=cfg.n_threads))


# per model, the kernels its train step must launch, and those it must not
# (training runs its convs and Swin blocks as PyTorch ops; SPEINet routes
# 'mixed' through K5 and gathers through K10, SWINT has no search)
TRAIN_LAUNCHES = {"SPEINet": ["roll2d", "correlation_argmax_lds", "row_gather"],
                  "SWINT": ["roll2d"]}
_NO_BACKWARD = ["conv2d", "swin_block", "banded_corr_argmax", "correlation_argmax_ld",
                "correlation_argmax", "window_cross_attention", "ln_mlp"]
TRAIN_SHUNS = {"SPEINet": _NO_BACKWARD,
               "SWINT": _NO_BACKWARD + ["correlation_argmax_lds", "row_gather"]}
# the kernels Trainer.test()'s inference forward must launch
TEST_LAUNCHES = {"SPEINet": ["conv2d", "swin_block", "roll2d", "correlation_argmax_lds",
                             "row_gather"],
                 "SWINT": ["conv2d", "swin_block", "roll2d"]}


def run_training(cfg, workdir: str):
    """The training main path of the model `cfg` names (SPEINet or SWINT):
    `Trainer.train()` for one epoch at full width on a synthetic in-memory
    tree (2 videos of 24 240x320 frames: 4 steps of the template's batch 20
    at patch 200), then `Trainer.test()` on two windows of a 6-frame video.
    Launch counts are reset just before train() and read just after, and
    again around test() (the record's `test_launches`); then three more
    steps on one batch are timed, each ended by a device sync. Returns (the
    run's record, launch counts, backward launch counts, the trainer, the
    discriminator's first weights)."""
    import os

    import numpy as np
    import torch
    from speinet_tpu_torch.data.loader import to_device
    from speinet_tpu_torch.kernels import BACKWARD_LAUNCHES, LAUNCHES, reset_launches
    from speinet_tpu_torch.models import make_model
    from speinet_tpu_torch.models.speinet import init_weights
    from speinet_tpu_torch.training.train_state import train_step
    from speinet_tpu_torch.training.trainer import Trainer
    from speinet_tpu_torch.utils.logging import Logger

    train_root = os.path.join(workdir, "train")
    test_root = os.path.join(workdir, "val")
    store = memory_tree(train_root, 2, 24, 240, 320, seed=3)
    store.update(memory_tree(test_root, 1, 6, 240, 320, seed=9))
    cfg = cfg.replace(experiment_dir=workdir + "/", save="train", epochs=1,
                      print_every=1, save_images=False)

    class Unplotted(Logger):
        def plot(self, values, label, filename):    # matplotlib is not needed
            pass

    logger = Unplotted(cfg)
    model = init_weights(make_model(cfg), cfg.seed)
    trainer = Trainer(cfg, memory_data(cfg, train_root, test_root, store), model,
                      logger, device="cuda")
    params0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    dis0 = None if trainer.gan is None else {
        k: v.detach().clone() for k, v in trainer.gan.dis.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts, backward = dict(LAUNCHES), dict(BACKWARD_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    steps = trainer.step
    losses = trainer.ckp.loss_log
    after = model.state_dict()
    moved = {kind: sum(not torch.equal(after[k], params0[k]) for k in after
                       if k.endswith(suffix))
             for kind, suffix in (("weights", "weight"), ("running_means", "running_mean"))}
    total = {kind: sum(k.endswith(suffix) for k in after)
             for kind, suffix in (("weights", "weight"), ("running_means", "running_mean"))}
    reset_launches()
    t1 = time.time()
    trainer.test()
    torch.cuda.synchronize()
    test_s = time.time() - t1
    test_counts = dict(LAUNCHES)
    psnr = trainer.ckp.psnr_log[-1]
    logger.done()

    batch = next(iter(trainer.data.loader_train))
    inp = to_device(batch[0], trainer.device)
    gt = to_device(batch[1][:, cfg.n_sequence // 2], trainer.device)
    step_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.time()
        train_step(model, trainer.optimizer, trainer.loss, inp, gt, trainer.generator,
                   trainer.gan)
        torch.cuda.synchronize()
        step_ms.append((time.time() - t1) * 1e3)
    ms = sum(step_ms) / len(step_ms)
    if steps < 3 or not (np.isfinite(losses).all() and np.isfinite(psnr)):
        raise AssertionError(f"training: {steps} steps, losses {losses}, psnr {psnr}")
    # search23 is defined but unused (parity), and a gate's ReLU may leave a
    # weight without gradient at random init: nine in ten must move
    if moved["weights"] < 0.9 * total["weights"] or moved["running_means"] != total[
            "running_means"]:
        raise AssertionError(f"training moved {moved} of {total}")
    record = dict(model=cfg.model, loss=cfg.loss, batch=cfg.batch_size,
                  patch=cfg.patch_size, steps=steps,
                  epoch_wall_s=wall, epoch_loss=losses[-1],
                  epoch_components=dict(zip(trainer.ckp.comp_names,
                                            trainer.ckp.comp_log[0].tolist())),
                  test_windows=len(trainer.data.loader_test),
                  test_s=test_s, test_psnr=psnr, test_launches=test_counts,
                  moved=moved, of=total,
                  ms_per_step=ms, step_ms=step_ms,
                  windows_per_s=cfg.batch_size / (ms / 1e3),
                  peak_memory_gib=peak / 2 ** 30)
    return record, counts, backward, trainer, dis0


def check_plugins(record, trainer, dis0, workdir: str):
    """The VGG / GAN epoch: its VGG22, GAN and DIS columns finite (DIS
    positive), every discriminator weight moved, and a checkpoint of the
    trainer's state restoring the discriminator and its Adam state exactly
    into a fresh one."""
    import math

    import torch
    from speinet_tpu_torch.models.speinet import SPEINet
    from speinet_tpu_torch.training.adversarial import init_gan_state
    from speinet_tpu_torch.training.train_state import make_optimizer
    from speinet_tpu_torch.utils.checkpoint import CheckpointManager

    comps = record["epoch_components"]
    if not all(math.isfinite(comps.get(k, math.nan)) for k in ("VGG22", "GAN", "DIS")) \
            or not comps["DIS"] > 0:
        raise AssertionError(f"plugin loss columns: {comps}")
    dis = trainer.gan.dis.state_dict()
    still = [k for k in dis if torch.equal(dis[k], dis0[k])]
    if still:
        raise AssertionError(f"discriminator weights did not move: {still}")
    ckpt = CheckpointManager(workdir + "/roundtrip")
    ckpt.save(trainer.model, trainer.optimizer, trainer.step, 1, gan=trainer.gan)
    model = SPEINet.from_config(trainer.cfg)
    fresh = init_gan_state(torch.Generator().manual_seed(99), "cuda")
    ckpt.restore(model, make_optimizer(trainer.cfg, model), "model_latest", fresh)
    bad = [k for k, v in fresh.dis.state_dict().items() if not torch.equal(v, dis[k])]
    want, got = trainer.gan.opt.state_dict(), fresh.opt.state_dict()
    bad += [f"opt {i}.{f}" for i, st in want["state"].items() for f, v in st.items()
            if not torch.equal(got["state"][i][f].cpu(), v.cpu())]
    if bad or len(got["state"]) != len(want["state"]) or not want["state"]:
        raise AssertionError(f"discriminator checkpoint round trip differs: {bad}")
    return dict(components=comps, discriminator_tensors_moved=len(dis),
                round_trip="exact", adam_states=len(want["state"]))


GRAD_GROUPS = (("encoder", ("recons_net.inBlock.", "recons_net.encoder_")),
               ("swin", ("swin.",)),
               ("transfer", ("fusion.", "SelfTransfer.")),
               ("fusion_conv", ("conv.",)),            # SWINT's 1x1 fusion conv
               ("decoder", ("recons_net.decoder_", "recons_net.outBlock.",
                            "conv_lv", "search")))


def wrong_roll():
    """A planted fault: the K3 roll under autograd with a backward that
    launches K3 with the shifts not negated."""
    import torch
    from speinet_tpu_torch.kernels import roll2d

    class WrongRoll(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, sh, sw):
            ctx.shifts = (sh, sw)
            return roll2d(x, sh, sw)

        @staticmethod
        def backward(ctx, g):
            sh, sw = ctx.shifts
            return roll2d(g.contiguous(), sh, sw), None, None

    def roll(x, sh, sw):
        sh %= x.shape[1]
        sw %= x.shape[2]
        return x if sh == 0 and sw == 0 else WrongRoll.apply(x, sh, sw)

    return roll


def check_train_against_cpu(cfg, plant: bool = True):
    """The card's bf16 train step of the model `cfg` names (SPEINet or
    SWINT) against the port's f32 CPU step, same weights and batch (the
    mixed 80x80 pair; the Swin depth cut to 2 blocks, widths full): the loss within 2%, the gradient's cosine >= 0.99 for each
    parameter group, and >= 0.9 for each parameter tensor of 64 elements or
    more (cosines in float64). DropPath and HEM draw from one CPU generator
    seeded alike on both sides. The check must reject one planted fault: a
    step whose Swin rolls go through a K3 function with an un-negated
    backward shift. That fault leaves every group's cosine above 0.9999 (a
    few Swin tensors' gradients dwarf the rest) while the attention tensors
    of the shifted block fall to 0.04-0.97, which the per-tensor rule sees;
    bf16 against f32 keeps each such tensor near 0.99 (a CPU rehearsal in
    bf16: 0.9898 at the lowest). With a GAN term in `cfg.loss` the
    discriminator (its own step's gradient) is one more group; `plant`
    runs the planted fault."""
    import torch
    import speinet_tpu_torch.models.swinir as swinir
    from speinet_tpu_torch.models import make_model
    from speinet_tpu_torch.models.speinet import init_weights
    from speinet_tpu_torch.training.loss import LossComputer
    from speinet_tpu_torch.training.train_state import (make_gan_state, make_optimizer,
                                                        train_step)

    small = cfg.replace(depths=[2], num_heads=[8])
    gpu = init_weights(make_model(small), 0).to("cuda")
    state = {k: v.detach().clone() for k, v in gpu.state_dict().items()}
    cpu = make_model(small.replace(compute_dtype="float32"))
    x = mixed_batch(small_frames())
    gt = x[:, 1].clone()

    def step(model, dev):
        model.load_state_dict({k: v.to(dev) for k, v in state.items()})
        gan = make_gan_state(small, dev)      # the same seeded draw on both
        total, _ = train_step(model, make_optimizer(small, model),
                              LossComputer(small.loss, rgb_range=small.rgb_range),
                              x.to(dev), gt.to(dev), torch.Generator().manual_seed(5),
                              gan)
        named = list(model.named_parameters()) + (
            [] if gan is None else [(f"discriminator.{n}", p)
                                    for n, p in gan.dis.named_parameters()])
        return total.item(), {n: p.grad.double().flatten().cpu()
                              for n, p in named if p.grad is not None}

    def cos(a, b):
        return torch.nn.functional.cosine_similarity(a, b, dim=0).item()

    def compare(card, ref):
        loss_rel = abs(card[0] - ref[0]) / abs(ref[0])
        groups = {g: cos(*(torch.cat([d[n] for n in ref[1] if n.startswith(pre)])
                           for d in (card[1], ref[1])))
                  for g, pre in GRAD_GROUPS + (("discriminator", ("discriminator.",)),)
                  if any(n.startswith(pre) for n in ref[1])}
        tensors = sorted((cos(card[1][n], ref[1][n]), n) for n in ref[1]
                         if ref[1][n].numel() >= 64)
        return dict(loss_card=card[0], loss_cpu=ref[0], loss_rel=loss_rel,
                    cosine=groups, lowest_tensors=tensors[:3],
                    ok=(loss_rel <= 0.02 and min(groups.values()) >= 0.99
                        and tensors[0][0] >= 0.9))

    ref = step(cpu, "cpu")
    good = compare(step(gpu, "cuda"), ref)
    if not good["ok"]:
        raise AssertionError(f"train step card vs cpu: {good}")
    if not plant:
        return dict(step=good)
    swinir.roll2d, real = wrong_roll(), swinir.roll2d
    try:
        planted = compare(step(gpu, "cuda"), ref)
    finally:
        swinir.roll2d = real
    if planted["ok"]:
        raise AssertionError(f"train step check accepts the planted roll fault: {planted}")
    return dict(step=good, planted_fault_rejected=planted)

# --- SWINT, detector training, utility ops -----------------------------------

def cfg_swint():
    """The SWINT template, in bf16, as its phases run it."""
    from speinet_tpu_torch.config import Config, set_template

    return set_template(Config(template="SWINT")).replace(
        compute_dtype="bfloat16", n_threads=4)


def check_swint_against_cpu(cfg):
    """SWINT at full width (depths 6x6) on the card in bf16 against its f32
    CPU path, same seeded weights, at 80x80 on a batch of two windows (the
    synthetic frames and their mirror image): n_sequence 3, n_sequence 1
    (no neighbour: the centre's residual Swin pass), and n_sequence 3 with
    swin_fuse_block=False, whose blocks must launch K8 + K9 and not K2.
    Each above 30 dB, as `compare_to_cpu` holds SPEINet. Returns the
    comparisons and the launch counts of each card forward."""
    import torch
    from speinet_tpu_torch.kernels import LAUNCHES, reset_launches
    from speinet_tpu_torch.models.speinet import init_weights
    from speinet_tpu_torch.models.swint import SWINT

    out = {}
    for name, n_seq, fuse in (("nseq3", 3, True), ("nseq1", 1, True),
                              ("split", 3, False)):
        c = cfg.replace(n_sequence=n_seq)
        gpu = init_weights(SWINT.from_config(c, swin_fuse_block=fuse), 0).to("cuda").eval()
        cpu = SWINT.from_config(c.replace(compute_dtype="float32"), swin_fuse_block=fuse)
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        frames = small_frames(n_seq)
        x = torch.stack([frames, frames.flip(-1)])
        reset_launches()
        got = gpu(x.cuda()).float().cpu()
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        out[name] = dict(compare_to_cpu(f"swint {name}", got, cpu.eval()(x)),
                         launches=counts)
        needs = ["conv2d", "roll2d"] + (["swin_block"] if fuse else
                                        ["window_cross_attention", "ln_mlp"])
        missing = [k for k in needs if counts[k] <= 0]
        if missing or (not fuse and counts["swin_block"] > 0):
            raise AssertionError(f"swint {name}: launches {counts}")
    return out


def _undecided(tree, x, tol: float):
    """Rows of x whose path through `tree` passes a split threshold within
    `tol` relative of the row's feature."""
    out = []
    for row in x:
        node, near = tree.root, False
        while node.left is not None:
            v = row[node.feature]
            near |= abs(v - node.threshold) <= tol * max(abs(v), abs(node.threshold))
            node = node.left if v <= node.threshold else node.right
        out.append(near)
    return out


def check_detector_train():
    """The detector-training entry point `train_detectors` on the card's and
    the CPU's features. Data: 16 synthetic 180x320 videos of 120 frames,
    each re-blurred by the GoProRS generator (ratio 0.5, one seeded
    generator), as `collate_synthetic` does; the focus features (k 11) on
    each device. The frames are cut from the GoPro 1280x720: the fits see
    one 6-feature row per sample, so the check needs samples, not pixels
    (276 here), and at 720p their 1920 sharp frames, the generator and the
    CPU's half of the feature pass would take about 160 s on four CPU
    threads, more than the whole smoke run's margin; `check_detector` holds
    the feature pass itself card against CPU on the main path's 1280x720
    frames.
    `train_detectors` (90 / 10 split, the logistic model, a tree and a
    10-tree forest, the three `{Model}_0.5_11.pkl` pickles and the CSV)
    runs once on each side's features; the pickles are loaded back through
    the port's loaders. Rules:
    - features within 1e-4 relative (as `check_detector`);
    - each side's CSV has the header and one row per model, its numbers the
      metrics `train_detectors` returned;
    - logistic coefficients and intercept within the spread that the 1e-4
      feature tolerance itself produces: the largest change, over 8 fits on
      the CPU's training rows each scaled element-wise by 1 + 1e-4 s with
      random signs s, of each coefficient (mean / scale within 1e-4
      relative);
    - labels of every sample equal wherever the CPU margin exceeds the
      slack that the feature tolerance and that coefficient spread allow;
    - held-out tree and forest predictions equal on every sample none of
      whose split tests on the CPU fit lies within 2e-4 relative of its
      threshold (the two sides' features differ by up to 1e-4 each way, so
      only such a test can go either way; the fits split at midpoints of
      the sorted training values, the same where the order is), so the
      required agreement on those samples is 100%; the rate over all
      held-out samples is reported;
    - each model's held-out metrics equal on both sides when every
      held-out sample is decided under those rules."""
    import csv
    import os

    import numpy as np
    from speinet_tpu_torch.data.gopro_rs import generate_blurry_sequence
    from speinet_tpu_torch.detector.classifier import (DecisionTree, LogisticRegression,
                                                       RandomForest,
                                                       fit_logistic_regression)
    from speinet_tpu_torch.detector.train import (holdout_split, train_detectors,
                                                  video_features)

    rng = np.random.default_rng(0)
    blur, labels = [], []
    for v in range(16):
        b, _, y = generate_blurry_sequence(synthetic_video(120, 180, 320, seed=20 + v),
                                           0.5, rng)
        blur.append(b)
        labels.append(y)
    blur, y = np.concatenate(blur), np.concatenate(labels)
    t0 = time.time()
    f_gpu = video_features(blur, 11, device="cuda")
    gpu_s = time.time() - t0
    f_cpu = video_features(blur, 11, device="cpu")
    rel = float(np.max(np.abs(f_gpu - f_cpu) / np.maximum(np.abs(f_cpu), 1e-30)))
    if not rel <= 1e-4:
        raise AssertionError(f"detector_train features: relative diff {rel}")

    models, metrics = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for side, f in (("card", f_gpu), ("cpu", f_cpu)):
            out, table = os.path.join(tmp, side), os.path.join(tmp, f"{side}.csv")
            metrics[side] = train_detectors(f, y, out, 0.5, 11, csv_path=table,
                                            n_forest_trees=10)
            pkl = lambda m: os.path.join(out, f"{m}_0.5_11.pkl")
            models[side] = (LogisticRegression.load(pkl("LogisticRegression")),
                            DecisionTree.load(pkl("DecisionTree")),
                            RandomForest.load(pkl("RandomForest")))
            with open(table, newline="") as fh:
                rows = list(csv.reader(fh))
            want = [["model", "ratio", "kernel_size", "accuracy", "recall",
                     "precision", "f1"]] + [
                [m, "0.5", "11"] + [str(r[k]) for k in ("accuracy", "recall",
                                                        "precision", "f1")]
                for m, r in metrics[side].items()]
            if rows != want:
                raise AssertionError(f"detector_train {side} CSV: {rows} vs {want}")
    (lr_g, dt_g, rf_g), (lr_c, dt_c, rf_c) = models["card"], models["cpu"]
    test, train = holdout_split(len(y))

    spread_w = np.zeros_like(lr_c.coef, dtype=np.float64)
    spread_b = 0.0
    for k in range(8):
        s = np.random.default_rng(100 + k).choice([-1.0, 1.0], f_cpu[train].shape)
        p = fit_logistic_regression(f_cpu[train] * (1 + 1e-4 * s), y[train])
        spread_w = np.maximum(spread_w, np.abs(p.coef - lr_c.coef))
        spread_b = max(spread_b, abs(p.intercept - lr_c.intercept))
    d_w = np.abs(lr_g.coef - lr_c.coef)
    d_b = abs(lr_g.intercept - lr_c.intercept)
    if not (np.all(d_w <= spread_w) and d_b <= spread_b
            and np.allclose(lr_g.mean, lr_c.mean, rtol=1e-4)
            and np.allclose(lr_g.scale, lr_c.scale, rtol=1e-4)):
        raise AssertionError(f"logistic fit card vs cpu: coef diff {d_w} (spread "
                             f"{spread_w}), intercept diff {d_b} ({spread_b})")
    z = (f_cpu - lr_c.mean) / lr_c.scale
    slack = (np.abs(lr_c.coef / lr_c.scale) * np.abs(f_cpu) * 2e-4).sum(axis=1) \
        + (spread_w * np.abs(z)).sum(axis=1) + spread_b
    sure = np.abs(lr_c.decision_function(f_cpu)) > slack
    l_gpu, l_cpu = lr_g.predict(f_gpu), lr_c.predict(f_cpu)
    if not np.array_equal(l_gpu[sure], l_cpu[sure]):
        raise AssertionError("logistic labels card vs cpu differ beyond the slack")
    held = {}
    for name, card, ref in (("LogisticRegression", lr_g, lr_c),
                            ("DecisionTree", dt_g, dt_c), ("RandomForest", rf_g, rf_c)):
        if name == "LogisticRegression":
            undecided = ~sure[test]
        else:
            trees = ref.trees if name == "RandomForest" else [ref]
            undecided = np.any([_undecided(t, f_cpu[test], 2e-4) for t in trees],
                               axis=0)
        agree = card.predict(f_gpu[test]) == ref.predict(f_cpu[test])
        if not agree[~undecided].all():
            raise AssertionError(f"{name}: held-out predictions differ on decided "
                                 f"samples {np.flatnonzero(~agree & ~undecided)}")
        same = metrics["card"][name] == metrics["cpu"][name]
        if not undecided.any() and not same:
            raise AssertionError(f"{name}: held-out metrics {metrics['card'][name]} "
                                 f"vs {metrics['cpu'][name]}")
        held[name] = dict(agree_rate=float(agree.mean()),
                          decided=int((~undecided).sum()), of=len(test),
                          metrics_equal=same, metrics_cpu=metrics["cpu"][name])
    return dict(samples=len(y), sharp=int(y.sum()), size="180x320",
                features_max_rel_diff=rel, features_card_s=gpu_s,
                logistic=dict(coef_diff=d_w.tolist(), coef_tol=spread_w.tolist(),
                              intercept_diff=d_b, intercept_tol=spread_b,
                              labels_decided=int(sure.sum()),
                              labels_agree=float((l_gpu == l_cpu).mean())),
                held_out=held)


def check_ops():
    """The classical smoothing and utility ops on a 1280x720 frame (in
    [0, 1], its 5x5 box blur, the PSF) on the card against the CPU, both
    float32 (TF32 off). Tolerances, as max |card - cpu| / max |cpu|:
    sobel_magnitude and adaptive_instance_normalization (on the frame as
    [1, 3, 720, 1280] against its blur as [1, 3, 720, 256, 5]) 1e-5, a few
    float32 steps; wiener_deconv and ftvd (20 iterations) 1e-5, where the
    CPU's own float32 result lies within 1e-6 of its float64 one;
    psnr_uint8 (float64) 1e-9 relative. l0_smoothing thresholds gradients
    at lam / beta, so a pixel whose gradient lies within rounding of the
    threshold may go either way: on the CPU its float32 result differs from
    its float64 one by 1.1e-5 on average, up to 4.7e-3 at 1% of the pixels;
    the rule is a mean |diff| <= 1e-4 and a PSNR >= 60 dB."""
    import math

    import torch
    import torch.nn.functional as F
    from speinet_tpu_torch.ops.filters import sobel_magnitude, wiener_deconv
    from speinet_tpu_torch.ops.metrics import psnr_uint8
    from speinet_tpu_torch.ops.smoothing import ftvd, l0_smoothing
    from speinet_tpu_torch.utils.image_utils import adaptive_instance_normalization

    frame = torch.from_numpy(synthetic_video(1, 720, 1280, seed=5)[0]).float() / 255.0
    nchw = frame.permute(2, 0, 1)[None].contiguous()
    blur = F.avg_pool2d(nchw, 5, stride=1, padding=2, count_include_pad=False)
    u8 = lambda t: (t.clamp(0, 1) * 255).round().to(torch.uint8)
    host = dict(frame=frame, nchw=nchw, blur=blur, psf=torch.ones((5, 5)) / 25.0,
                blur_hwc=blur[0].permute(1, 2, 0).contiguous(), frame_u8=u8(frame),
                blur_u8=u8(blur[0].permute(1, 2, 0)),
                knn=blur.reshape(1, 3, 720, 256, 5))
    inputs = {d: {k: v.to(d) for k, v in host.items()} for d in ("cuda", "cpu")}
    ops = {
        "psnr_uint8": (lambda t: psnr_uint8(t["frame_u8"], t["blur_u8"]), 1e-9),
        "l0_smoothing": (lambda t: l0_smoothing(t["frame"]), None),
        "ftvd": (lambda t: ftvd(t["blur_hwc"], t["psf"]), 1e-5),
        "wiener_deconv": (lambda t: wiener_deconv(t["blur"], t["psf"]), 1e-5),
        "sobel_magnitude": (lambda t: sobel_magnitude(t["nchw"]), 1e-5),
        "adaptive_instance_normalization": (
            lambda t: adaptive_instance_normalization(t["nchw"], t["knn"]), 1e-5),
    }
    out = {}
    for name, (fn, tol) in ops.items():
        got = fn(inputs["cuda"]).cpu()
        t0 = time.time()
        ref = fn(inputs["cpu"])
        cpu_s = time.time() - t0
        diff = (got.double() - ref.double()).abs()
        rel = (diff.max() / ref.double().abs().max()).item()
        row = dict(max_abs_err=diff.max().item(), rel_err=rel, cpu_ms=cpu_s * 1e3,
                   ms=time_ms(lambda: fn(inputs["cuda"]), iters=3, warmup=1))
        if tol is None:
            mse = (diff ** 2).mean().item()
            row.update(mean_abs_err=diff.mean().item(),
                       psnr_db=10 * math.log10(1.0 / max(mse, 1e-30)))
            ok = row["mean_abs_err"] <= 1e-4 and row["psnr_db"] >= 60.0
        else:
            ok = torch.isfinite(got).all().item() and rel <= tol
        if not ok:
            raise AssertionError(f"{name} card vs cpu: {row}")
        out[name] = row
    return out

# --- n_sequence, K4 under autograd, profiling --------------------------------

def route_alike(n_seq: int, n_frames: int):
    """Names of the windows of run_main_path's video that the JAX package's
    two engines route alike at window length `n_seq`: its direct engine
    routes on frame 3, which at n_sequence 5 is a blurry neighbour, so every
    window searches the sub-sharp frame, never zeroed there; its cached
    engine does so only where the pre-sharp frame lies within 7 frames of
    the window's last one and the sub-sharp frame too."""
    import os

    import numpy as np
    from speinet_tpu_torch.data.indices import gene_seq, gene_seq_nsf
    from speinet_tpu_torch.infer import window_metas

    labels = np.zeros(n_frames, np.int64)
    labels[[0, n_frames - 1]] = 1
    pre, sub = gene_seq_nsf(labels, n_seq=n_seq, border=True)
    _, padded = gene_seq([f"synthetic/{i:08d}" for i in range(n_frames)], n_seq=n_seq,
                         border=True)
    return [os.path.basename(c).split(".")[0]
            for c, _, hs, akey in window_metas(padded, pre, sub, n_seq)
            if hs and akey != "<ZERO>"]


def check_n_sequence_1(cfg):
    """An n_sequence 1 model (3-frame windows: the frame, its pre- and
    sub-sharp frames; no neighbour, so the Swin fusion is the residual
    pass of the centre alone) at full width on the card against its f32 CPU
    path at 80x80: both restores and the mixed forward, whose routing frame
    is the sub-sharp one (the JAX package's clamped frame 3). Untimed."""
    from speinet_tpu_torch.kernels import LAUNCHES, reset_launches
    from speinet_tpu_torch.models.speinet import SPEINet, init_weights

    one = cfg.replace(n_sequence=1)
    model = init_weights(SPEINet.from_config(one), 0).to("cuda").eval()
    reset_launches()
    out = check_against_cpu(one, model, full=False)
    out["launches"] = dict(LAUNCHES)
    if out["launches"]["banded_corr_argmax"] <= 0 or out["launches"]["swin_block"] <= 0:
        raise AssertionError(f"n_sequence 1: kernels not launched {out['launches']}")
    return out


def _banded_grads(f, g, inv, routing, gs, card: bool, idx=None):
    """Gradients of sum(gs * S) w.r.t. (f, [g,] inv) for K4's search of f
    in g ('sharp') or in f transposed and flipped ('self'): through the
    K4 autograd function (`card`), or through a differentiable unfold form
    of S at the winners `idx`, in float32."""
    import torch
    import torch.nn.functional as F
    from speinet_tpu_torch.kernels import banded_corr_argmax

    leaves = [t.detach().clone().requires_grad_(True)
              for t in ((f, g, inv) if card else (f.float(), g.float(), inv))]
    ref = leaves[1] if routing == "sharp" else torch.flip(
        leaves[0].transpose(1, 2), dims=(1,)).contiguous()
    if card:
        s, idx = banded_corr_argmax(leaves[0], ref, leaves[2])
    else:
        lu = F.unfold(leaves[0].permute(0, 3, 1, 2), 3, padding=1)
        ru = F.unfold(ref.permute(0, 3, 1, 2), 3, padding=1)
        i = idx.long()
        s = ((torch.gather(ru, 2, i[:, None].expand(-1, ru.shape[1], -1)) * lu).sum(1)
             * torch.gather(leaves[2], 1, i))
    s.backward(gs)
    used = leaves if routing == "sharp" else leaves[::2]
    return [t.grad.float() for t in used], idx


def check_k4_grad(rng_seed: int):
    """K4 under autograd: at the cached restore's shape ([1, 180, 320, 128]
    bf16, 'sharp' and 'self') the forward launches K4 and the backward
    (`banded_backward`) runs on the card; then one restore_from_features
    (routing 'sharp', train=True, Swin depth 2) at 80x80 backpropagates
    through K4 into the model. Launch counts are reset before those runs
    and read after them. Then the checks: the 720p gradients against
    autograd of an unfold form of S at the plain forward's winners, with
    the cotangent zeroed where the kernel's and the plain argmax differ
    (a near tie may flip under rounding); within two bf16 steps of the
    largest element (d lr and d ref are cast to bf16 once each, and 'self'
    adds the two). The check must reject a planted backward that drops the
    dx shift of every patch offset."""
    import torch
    import speinet_tpu_torch.kernels.corr as corr
    from speinet_tpu_torch.kernels import (LAUNCHES, banded_corr_argmax,
                                          banded_corr_argmax_plain, reset_launches)
    from speinet_tpu_torch.models.search_transfer import patch_inv_norms
    from speinet_tpu_torch.models.speinet import SPEINet, init_weights

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    h, w, c = 180, 320, 128
    cases = {}
    for routing in ("sharp", "self"):
        f = torch.rand((1, h, w, c), generator=g, device="cuda").to(torch.bfloat16)
        gm = torch.rand((1, h, w, c), generator=g, device="cuda").to(torch.bfloat16)
        ref = gm if routing == "sharp" else torch.flip(f.transpose(1, 2), dims=(1,))
        inv = patch_inv_norms(ref).contiguous()
        gs = torch.randn((1, h * w), generator=g, device="cuda")
        cases[routing] = (f, gm, inv, gs, ref.contiguous())
    reset_launches()
    card = {}
    for routing, (f, gm, inv, gs, _) in cases.items():
        card[routing] = _banded_grads(f, gm, inv, routing, gs, card=True)
    small = SPEINet.from_config(cfg_template().replace(depths=[2], num_heads=[8]))
    model = init_weights(small, 0).to("cuda")
    fr = small_frames().cuda()
    m, n = model.encode_window_legs(fr[:3])
    pyr = model.anchor_pyramid(fr[4:5])
    out = model.restore_from_features(m[1:2], [n[0:1], n[2:3]], *pyr, "sharp",
                                      train=True,
                                      generator=torch.Generator(device="cuda").manual_seed(1))
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    if counts["banded_corr_argmax"] < 3:
        raise AssertionError(f"k4_grad: K4 launched {counts['banded_corr_argmax']} "
                             f"times, fewer than the 3 calls")
    restore_grads = {k: model.get_parameter(k).grad for k in (
        "fusion.weight", "conv_lv3.weight", "swin.conv_first.weight")}
    if not all(t is not None and torch.isfinite(t).all() and t.abs().max() > 0
               for t in restore_grads.values()):
        raise AssertionError("restore_from_features(train=True): no gradient "
                             "reached the fusion, decoder or Swin weights")

    def errors(grads, want):
        return max(((a - b).abs().max() / b.abs().max()).item()
                   for a, b in zip(grads, want))

    rows = {}
    for routing, (f, gm, inv, gs, ref) in cases.items():
        (grads, idx) = card[routing]
        s_p, idx_p = banded_corr_argmax_plain(f, ref, inv)
        agree = idx == idx_p
        gs_m = gs * agree
        # the card's gradient again under the masked cotangent (the first
        # run above is the counted one, on the unmasked cotangent)
        grads, _ = _banded_grads(f, gm, inv, routing, gs_m, card=True)
        want, _ = _banded_grads(f, gm, inv, routing, gs_m, card=False, idx=idx_p)
        err = errors(grads, want)
        if not err <= 2.0 ** -7:
            raise AssertionError(f"k4_grad {routing}: relative error {err}")
        real = corr.OFFSETS
        corr.OFFSETS = tuple((dy, 0) for dy, _ in real)
        try:
            planted = errors(_banded_grads(f, gm, inv, routing, gs_m, card=True)[0], want)
        finally:
            corr.OFFSETS = real
        if planted <= 2.0 ** -7:
            raise AssertionError(f"k4_grad {routing}: the planted backward without "
                                 f"the dx shift passes ({planted})")
        s, idx = banded_corr_argmax(f, ref, inv)
        bwd_ms = time_ms(lambda: corr.banded_backward(f, ref, inv, s, idx, gs),
                         iters=5, warmup=1)
        # its least traffic: the maps, inv, S, idx and the cotangent read
        # once, the three cotangents written once
        bms, by = bound(0.0, nbytes(f, ref, inv, s, idx, gs) + nbytes(f, ref, inv))
        rows[routing] = dict(shape=f"{routing} F[1,{h},{w},{c}]", rel_err=err,
                             planted_rel_err=planted,
                             idx_differs=int((~agree).sum()), backward_ms=bwd_ms,
                             backward_bound_ms=bms, backward_bound_by=by)
    return dict(rows=rows, launches=counts,
                restore_train_grad_max={k: v.abs().max().item()
                                        for k, v in restore_grads.items()})


PORT_KERNEL_FUNCTIONS = ("conv_kernel", "swin_block_kernel", "roll_kernel",
                         "banded_corr_kernel", "corr_unfold_kernel",
                         "row_gather_kernel", "swin_attn_kernel", "swin_mlp_kernel")


def check_profile(cfg, frames):
    """`--profile`'s function (`infer.profile_run`) around a 2-window run of
    the cached engine: the trace file exists and names the port's kernels."""
    import glob
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from speinet_tpu_torch.infer import Inference, profile_run

    keys = [f"synthetic/{i:08d}" for i in range(2)]
    store = dict(zip(keys, frames[:2]))
    labels = np.array([1, 0], np.int64)
    with tempfile.TemporaryDirectory() as res:
        inf = Inference(cfg, data_path=res, model_path="", result_path=res,
                        save_image=False, batch_windows=2, cache_pyramids=True,
                        device="cuda", seed=0)
        t0 = time.time()
        try:
            with ThreadPoolExecutor(max_workers=2) as pool:
                profile_run(lambda: inf.infer_video("profiled", keys, keys, labels,
                                                    store.__getitem__, pool),
                            os.path.join(res, "trace"), inf.device)
        finally:
            inf.close()
        wall = time.time() - t0
        traces = glob.glob(os.path.join(res, "trace", "*.pt.trace.json"))
        if len(traces) != 1:
            raise AssertionError(f"--profile wrote {traces}")
        with open(traces[0]) as fh:
            events = json.load(fh)["traceEvents"]
        size = os.path.getsize(traces[0])
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    port = sorted({k for k in PORT_KERNEL_FUNCTIONS if any(k in n for n in kernels)})
    if not port:
        raise AssertionError(f"the trace names no kernel of the port among "
                             f"{len(kernels)} kernels")
    return dict(windows=2, wall_s=wall, trace_bytes=size, kernel_names=len(kernels),
                port_kernels=port)


# --- data parallelism and the pipeline ----------------------------------------

def dist_batch(cfg, n: int):
    """A batch of n windows at the template's patch on the card: [n, 5, 3, p,
    p] in [0, rgb_range] (every third window's pre-sharp frame zeroed, so it
    routes to the self reference) and the centre frames as ground truth."""
    import numpy as np
    import torch

    p = cfg.patch_size
    frames = np.stack([f.transpose(2, 0, 1) for f in synthetic_video(n + 4, p, p, 4)])
    x = np.stack([frames[i:i + 5] for i in range(n)]).astype(np.float32)
    x *= cfg.rgb_range / 255.0
    x[::3, 3] = 0.0
    x = torch.from_numpy(x).cuda()
    return x, x[:, 1].clone()


def dist_steps(cfg, state, x, gt, n_steps: int = 3, deterministic: bool = False):
    """n_steps train steps of the template's model from `state` on one batch,
    DropPath and HEM drawing from a card generator seeded 7, each ended by a
    device sync; with `deterministic`, under torch's deterministic
    algorithms (cuDNN's deterministic convolutions, sorted scatter-adds;
    warn-only for an op that has none). Returns the losses, ms per step,
    the first step's gradients, the state after, and the launch counts
    (forward, backward) of the run."""
    import torch

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    torch.backends.cudnn.deterministic = deterministic
    if deterministic:
        torch.backends.cudnn.benchmark = False
    try:
        return _dist_steps(cfg, state, x, gt, n_steps)
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = was[2:]


def _dist_steps(cfg, state, x, gt, n_steps):
    import torch
    from speinet_tpu_torch.kernels import BACKWARD_LAUNCHES, LAUNCHES, reset_launches
    from speinet_tpu_torch.models import make_model
    from speinet_tpu_torch.training.loss import LossComputer
    from speinet_tpu_torch.training.train_state import make_optimizer, train_step

    model = make_model(cfg).cuda()
    model.load_state_dict(state)
    opt = make_optimizer(cfg, model)
    loss = LossComputer(cfg.loss, rgb_range=cfg.rgb_range)
    gen = torch.Generator(device="cuda").manual_seed(7)
    losses, ms, grads = [], [], None
    torch.cuda.synchronize()
    reset_launches()
    for _ in range(n_steps):
        t0 = time.time()
        total, _ = train_step(model, opt, loss, x, gt, gen)
        torch.cuda.synchronize()
        ms.append((time.time() - t0) * 1e3)
        losses.append(total.item())
        if grads is None:
            grads = {n: p.grad.detach().double().flatten()
                     for n, p in model.named_parameters() if p.grad is not None}
    counts, backward = dict(LAUNCHES), dict(BACKWARD_LAUNCHES)
    after = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return losses, ms, grads, after, counts, backward


def open_world_of_one():
    """A world-size-1 nccl group opened the way torchrun's processes open
    theirs: `maybe_init_distributed` reading RANK, WORLD_SIZE, LOCAL_RANK and
    MASTER_ADDR / MASTER_PORT (a free port on localhost), which are removed
    again so the pipeline's processes do not see them."""
    import os
    import socket

    from speinet_tpu_torch.parallel.mesh import maybe_init_distributed, world

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        dev = maybe_init_distributed("cuda")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    if str(dev) != "cuda:0" or world() != 1:
        raise AssertionError(f"world of one: device {dev}, world {world()}")
    return dev


def compare_steps(run, ref, state, params):
    """How far `run` (dist_steps' result) is from `ref`: each step's loss
    (relative), the first step's gradient cosine and norm ratio per group
    of tensors (GRAD_GROUPS), each parameter tensor's cosine after the
    steps, and the running statistics' largest difference over each
    tensor's max."""
    import torch

    def cos(a, b):
        return torch.nn.functional.cosine_similarity(a.double().flatten(),
                                                     b.double().flatten(), dim=0).item()

    g_cos, g_norm = {}, {}
    for grp, pre in GRAD_GROUPS:
        names = [n for n in ref[2] if n.startswith(pre)]
        if names:
            a = torch.cat([run[2][n] for n in names])
            b = torch.cat([ref[2][n] for n in names])
            g_cos[grp] = cos(a, b)
            g_norm[grp] = (a.norm() / b.norm()).item()
    stats = [n for n in ref[3] if n.endswith(("running_mean", "running_var"))]
    moved = [n for n in params if not torch.equal(ref[3][n], state[n].cuda())]
    return dict(
        losses_rel=[abs(a - b) / abs(b) for a, b in zip(run[0], ref[0])],
        grad_cosine=g_cos, grad_norm_ratio=g_norm,
        param_cosine={n: cos(run[3][n], ref[3][n]) for n in params},
        update_cosine_lowest=sorted(
            (cos(run[3][n] - state[n].cuda(), ref[3][n] - state[n].cuda()), n)
            for n in moved)[:3],
        running_stats_rel=max((run[3][n] - ref[3][n]).abs().max().item()
                              / max(ref[3][n].abs().max().item(), 1e-12)
                              for n in stats))


def check_dist(cfg, frames, outputs, train_ms: float):
    """The data-parallel paths in a world-size-1 nccl group (one card):
    3 train steps of the template (batch 20, patch 200, bf16, 1*L1+2*HEM,
    DropPath 0.1) from the same weights, batch and generator seed, under
    torch's deterministic algorithms without a group, again without one,
    and under the group; timed without them in runs of 4 steps, the first
    of each not counted, in turns without, under, without and under the
    group (ms per step: the mean of each side's 6); the cached and
    direct engines on the 12-frame 720p video under the group against the
    frames of the `cached` and `direct` paths without one (>= 60 dB);
    `sharded_conv2d` on a [2, 720, 1280, 8] tensor against the unsharded
    depthwise conv.

    The group adds the gates' statistic all-reduces, the gradient
    all-reduce and the engines' gathers; with one rank each is the
    identity, and the gates compute sum / count the same way with or
    without a group, so the group's steps should repeat the no-group ones.
    The template's randomly initialised step amplifies any rounding: while
    the gates divided by a host scalar without a group (a reciprocal
    product on CUDA) and by a device tensor under it, the first step agreed
    within 2e-6 but the third step's loss differed by 0.4-5% and a gate's
    running variance by 4-15%; two no-group runs outside the deterministic
    algorithms (atomic adds in their backwards) differed by 0.02-2% there.
    Under them the three runs agreed bit for bit on the card. The
    tolerances, each the larger of
    a floor and 4 x the no-group repeat's own difference: the first step's
    loss 1e-4 relative; its gradient per group (GRAD_GROUPS) 1 - cos 1e-4
    and norm 0.5% (an average over a wrong count moves the norm); after the
    3 steps each loss 1e-3 relative, each parameter tensor 1 - cos 1e-4,
    the running statistics 1e-4 of their max. A gate whose statistics stay
    local (the fault tests/test_torch_dist.py plants and catches on two
    gloo ranks) is the global batch's statistic in a world of one, so no
    card run of one rank can show it."""
    import torch
    from speinet_tpu_torch.models import make_model
    from speinet_tpu_torch.models.speinet import init_weights
    from speinet_tpu_torch.ops.filters import depthwise_conv2d
    from speinet_tpu_torch.parallel.halo import sharded_conv2d
    from speinet_tpu_torch.parallel.mesh import close_group

    state = init_weights(make_model(cfg), cfg.seed).state_dict()
    params = [n for n, _ in make_model(cfg).named_parameters()]
    x, gt = dist_batch(cfg, cfg.batch_size)
    plain = dist_steps(cfg, state, x, gt, deterministic=True)
    repeat = dist_steps(cfg, state, x, gt, deterministic=True)
    # timed runs of 4 steps, the first (algorithm choice, buffers) not
    # counted, in turns: without, under, without, under the group
    timed = [dist_steps(cfg, state, x, gt, n_steps=4)]
    t0 = time.time()
    open_world_of_one()
    init_s = time.time() - t0
    try:
        grouped = dist_steps(cfg, state, x, gt, deterministic=True)
        grouped_timed = [dist_steps(cfg, state, x, gt, n_steps=4)]
        engines = {}
        for path, cached in (("cached", True), ("direct", False)):
            inf, counts, wall, psnr, ssim, out = run_main_path(cfg, frames,
                                                               cache_pyramids=cached)
            engines[path] = dict(
                launches=counts, wall_s=wall,
                ms_per_frame={k: v / len(frames) * 1e3
                              for k, v in inf.stage_seconds.items() if v},
                psnr_vs_no_group_db=min(psnr_db(out[k], outputs[path][k])
                                        for k in outputs[path]))
        g = torch.Generator(device="cuda").manual_seed(3)
        xh = torch.rand((2, 720, 1280, 8), generator=g, device="cuda")
        k = torch.rand((5, 5), generator=g, device="cuda")
        want = depthwise_conv2d(xh.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)
        halo_err = (sharded_conv2d(k)(xh) - want).abs().max().item()
    finally:
        close_group()
    timed.append(dist_steps(cfg, state, x, gt, n_steps=4))
    open_world_of_one()
    try:
        grouped_timed.append(dist_steps(cfg, state, x, gt, n_steps=4))
    finally:
        close_group()

    got = compare_steps(grouped, plain, state, params)
    base = compare_steps(repeat, plain, state, params)
    p_slack = sorted((1 - got["param_cosine"][n])
                     / max(1e-4, 4 * (1 - base["param_cosine"][n])) for n in params)
    steady = lambda runs: [ms for run in runs for ms in run[1][1:]]
    ms_plain = sum(steady(timed)) / len(steady(timed))
    ms_group = sum(steady(grouped_timed)) / len(steady(grouped_timed))
    summary = lambda c: dict(
        c, param_cosine_lowest=sorted((v, n) for n, v in c["param_cosine"].items())[:3],
        param_cosine=None)
    record = dict(
        group_init_s=init_s, steps=len(plain[0]), batch=cfg.batch_size,
        patch=cfg.patch_size, loss=cfg.loss, losses_no_group=plain[0],
        losses_no_group_repeat=repeat[0], losses_group=grouped[0],
        group_vs_no_group=summary(got), repeat_vs_no_group=summary(base),
        param_cosine_worst_share_of_tolerance=p_slack[-1],
        step_ms_deterministic=dict(no_group=plain[1], no_group_repeat=repeat[1],
                                   group=grouped[1]),
        step_ms_no_group=[run[1] for run in timed],
        step_ms_group=[run[1] for run in grouped_timed],
        ms_per_step_no_group=ms_plain,
        ms_per_step_group=ms_group, group_overhead=ms_group / ms_plain - 1.0,
        train_phase_ms_per_step=train_ms,
        launches=grouped_timed[0][4], backward_launches=grouped_timed[0][5],
        engines=engines,
        halo=dict(shape=[2, 720, 1280, 8], kernel=[5, 5], max_abs_err=halo_err),
        local_stats_fault="a world of one cannot show it (its local batch is the "
                          "global batch); tests/test_torch_dist.py catches it on "
                          "two gloo ranks")
    bad = []
    if got["losses_rel"][0] > 1e-4:
        bad.append("first step's loss")
    for grp, c in got["grad_cosine"].items():
        if 1 - c > max(1e-4, 4 * (1 - base["grad_cosine"][grp])) or abs(
                got["grad_norm_ratio"][grp] - 1) > max(
                5e-3, 4 * abs(base["grad_norm_ratio"][grp] - 1)):
            bad.append(f"first step's gradient ({grp})")
    if any(r > max(1e-3, 4 * b) for r, b in zip(got["losses_rel"], base["losses_rel"])):
        bad.append("losses")
    if p_slack[-1] > 1.0:
        bad.append("parameter cosine")
    if got["running_stats_rel"] > max(1e-4, 4 * base["running_stats_rel"]):
        bad.append("running statistics")
    if min(e["psnr_vs_no_group_db"] for e in engines.values()) < 60.0:
        bad.append("engines under the group")
    if halo_err > 1e-5:
        bad.append("halo")
    missing = [k for k in TRAIN_LAUNCHES["SPEINet"] if grouped_timed[0][4][k] <= 0]
    if grouped_timed[0][5]["roll2d"] <= 0:
        missing.append("roll2d (backward)")
    if bad or missing:
        raise AssertionError(f"dist: {bad}, not launched {missing}: {record}")
    return record


def check_pipeline():
    """`python -m speinet_tpu_torch.pipeline` on a tree it generates (2
    videos of 30 frames at 256x320), template width, 1 epoch of batch 4 at
    patch 200, the train stage under `torch.distributed.run --nproc_per_node
    1`: every stage must exit 0, the inference stage must read the trained
    model_best (its log names it), and its frames must be the trained
    model's: its per-frame PSNRs equal those of the same engine restoring
    with model_best here, and differ from those of the seeded random init.
    The stages' kernel launches happen in their own processes and are not
    counted here."""
    import glob
    import os
    import re
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from speinet_tpu_torch.config import Config, set_template
    from speinet_tpu_torch.infer import Inference
    from speinet_tpu_torch.utils.image_io import imread

    with tempfile.TemporaryDirectory() as work:
        t0 = time.time()
        run = subprocess.run(
            [sys.executable, "-m", "speinet_tpu_torch.pipeline", "--work", work,
             "--n_videos", "2", "--n_frames", "30", "--epochs", "1",
             "--batch_size", "4", "--patch_size", "200", "--dp_devices", "1"],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        wall = time.time() - t0
        out = run.stdout
        if run.returncode != 0:
            raise AssertionError(f"pipeline exit {run.returncode}:\n{out[-4000:]}\n"
                                 f"{run.stderr[-4000:]}")
        seconds = {m.group(1): float(m.group(2)) for m in re.finditer(
            r"=== pipeline stage (\w+): exit 0 in ([0-9.]+) s ===", out)}
        if set(seconds) != {"generate", "detector", "train", "infer"}:
            raise AssertionError(f"pipeline stages {seconds}:\n{out[-4000:]}")
        best = os.path.join(work, "experiment", "run", "model", "model_best")
        logs = glob.glob(os.path.join(work, "results", "inference_log_*.txt"))
        text = open(logs[0]).read() if len(logs) == 1 else ""
        if f"Loading model from {best}" not in text:
            raise AssertionError(f"the inference stage did not read {best}: {logs}")
        logged = [float(v) for v in re.findall(r"PSNR=([0-9.]+), SSIM", text)]
        tree = os.path.join(work, "rs")
        cfg = set_template(Config(template="SPEINet")).replace(
            compute_dtype="bfloat16", n_threads=4)
        video = sorted(os.listdir(os.path.join(tree, "blur")))[0]
        keys = sorted(glob.glob(os.path.join(tree, "blur", video, "*")))
        gts = sorted(glob.glob(os.path.join(tree, "gt", video, "*")))
        labels = np.load(os.path.join(tree, "label", video + ".npy"))
        psnr = {}
        for name, path in (("trained", best), ("random", "")):
            inf = Inference(cfg, tree, path, os.path.join(work, name),
                            save_image=False, device="cuda", seed=0)
            try:
                with ThreadPoolExecutor(max_workers=4) as pool:
                    psnr[name] = inf.infer_video(video, keys, gts, labels, imread,
                                                 pool)[0]
            finally:
                inf.close()
    n = len(psnr["trained"])
    # the log prints 5 significant digits
    same = len(logged) >= n and np.allclose(psnr["trained"], logged[:n], atol=2e-3)
    differs = float(np.max(np.abs(np.subtract(psnr["trained"], psnr["random"]))))
    record = dict(wall_s=wall, stage_seconds=seconds, frames_logged=len(logged),
                  mean_psnr_trained=float(np.mean(psnr["trained"])),
                  mean_psnr_random_init=float(np.mean(psnr["random"])),
                  max_psnr_change_vs_random_init=differs, log_matches_trained=same)
    if not same or differs < 1e-3:
        raise AssertionError(f"pipeline inference frames: {record}")
    return record


def cfg_template():
    """The SPEINet template, in bf16, as every phase runs it."""
    from speinet_tpu_torch.config import Config, set_template

    return set_template(Config(template="SPEINet")).replace(
        compute_dtype="bfloat16", n_threads=4)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from speinet_tpu_torch.kernels import _lib
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    t0 = time.time()
    so = _lib.build()
    _lib.library()
    print(f"build: {time.time() - t0:.1f} s ({so.name})", flush=True)
    ptxas = so.parent / f"ptxas_{so.stem}.log"
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                print("  ptxas", line.strip())

    checks = {}
    for name, fn in (("roll2d", check_roll), ("conv2d", check_conv),
                     ("banded_corr_argmax", check_corr),
                     ("correlation_argmax_lds", check_corr_unfold),
                     ("correlation_argmax_ld", check_corr_ld),
                     ("correlation_argmax", check_corr_rows),
                     ("swin_block", check_swin),
                     ("window_cross_attention", check_attn),
                     ("ln_mlp", check_mlp), ("row_gather", check_gather)):
        t1 = time.time()
        checks[name] = fn(0)
        for row in checks[name]:
            print(f"{name} {json.dumps(row)}", flush=True)
        print(f"{name}: checked in {time.time() - t1:.1f} s", flush=True)
    print("cublas reference (not a kernel of the port): "
          + json.dumps(bmm_reference(0)), flush=True)
    for kernel, ref in swin_matmul_references(0).items():
        print(f"cublas reference (not a kernel of the port; {kernel}'s weight "
              "products): " + json.dumps(ref), flush=True)

    cfg = cfg_template()
    frames = synthetic_video(12, 720, 1280, seed=1)
    n_frames = len(frames)
    # each path: (engine, kernel-path switches, window length, kernels it
    # must launch, kernels it must not), with its launch counts reset just
    # before it
    split = dict(swin_fuse_block=False, corr_raw=False)
    prescaled = dict(corr_banded=False, corr_scaled=False)
    paths = {
        "cached": (True, {}, 3, ["conv2d", "swin_block", "roll2d", "banded_corr_argmax",
                                 "correlation_argmax_lds", "row_gather"], []),
        "direct": (False, {}, 3, ["conv2d", "swin_block", "roll2d",
                                  "correlation_argmax_lds", "row_gather"], []),
        "split": (True, split, 3, ["conv2d", "roll2d", "window_cross_attention",
                                   "ln_mlp", "correlation_argmax", "row_gather"],
                  ["swin_block", "banded_corr_argmax", "correlation_argmax_lds"]),
        "prescaled": (True, prescaled, 3, ["conv2d", "swin_block", "roll2d",
                                           "correlation_argmax_ld", "row_gather"],
                      ["banded_corr_argmax", "correlation_argmax_lds"]),
        # n_sequence 5: four neighbour streams per restore (K2 at batch 4B)
        "nseq5_cached": (True, {}, 5, ["conv2d", "swin_block", "roll2d",
                                       "banded_corr_argmax", "row_gather"], []),
        "nseq5_direct": (False, {}, 5, ["conv2d", "swin_block", "roll2d",
                                        "correlation_argmax_lds", "row_gather"], []),
    }
    launches = {k: 0 for k in checks}
    by_path = {}
    outputs, vs_cached, engines = {}, {}, {}
    for path, (cached, switches, n_seq, needs, shuns) in paths.items():
        t1 = time.time()
        inf, counts, wall, psnr, ssim, outputs[path] = run_main_path(
            cfg.replace(n_sequence=n_seq), frames, cache_pyramids=cached, **switches)
        engines[path] = inf
        per_frame = {k: v / n_frames * 1e3 for k, v in inf.stage_seconds.items() if v}
        line = dict(engine=path, switches=switches, n_sequence=n_seq, frames=n_frames,
                    size="1280x720", batch_windows=2, wall_s=wall,
                    ms_per_frame=per_frame, launches=counts,
                    mean_psnr_vs_gt=float(sum(psnr) / len(psnr)))
        if n_seq == 3 and path != "cached":
            vs_cached[path] = [psnr_db(outputs[path][k], outputs["cached"][k])
                               for k in sorted(outputs["cached"])]
            line["psnr_vs_cached_db"] = vs_cached[path]
        print(f"main path ({path}): " + json.dumps(line), flush=True)
        print(f"main path ({path}): run in {time.time() - t1:.1f} s", flush=True)
        missing = [k for k in needs if counts[k] <= 0]
        if missing:
            raise AssertionError(f"kernels not launched on the {path} path: {missing}")
        stray = [k for k in shuns if counts[k] > 0]
        if stray:
            raise AssertionError(f"kernels of another path launched on the {path} "
                                 f"path: {stray}")
        by_path[path] = counts
        for k in launches:
            launches[k] += counts[k]
    # the paths differ from the cached engine only in where bf16 rounds
    # (the direct forward rounds the centre frame to bf16 before its RL
    # branch; the split block rounds the residual stream to bf16 between K8
    # and K9, where K2 keeps it in f32; normalized operands round otherwise
    # than raw ones) and in summation order
    for path, vs in vs_cached.items():
        if not min(vs) >= 40.0:
            raise AssertionError(f"{path} vs cached engine: {min(vs):.2f} dB < 40")
    # at n_sequence 5 the engines agree only where the JAX package's two
    # engines route alike (its direct engine always searches the sub-sharp
    # frame there)
    alike = route_alike(5, n_frames)
    vs5 = {k: psnr_db(outputs["nseq5_direct"][k], outputs["nseq5_cached"][k])
           for k in alike}
    print("n_sequence 5, direct vs cached where the JAX engines route alike: "
          + json.dumps(dict(windows=alike, psnr_db=vs5)), flush=True)
    if not alike or not min(vs5.values()) >= 40.0:
        raise AssertionError(f"n_sequence 5 direct vs cached engine: {vs5}")
    print("card vs cpu: " + json.dumps(check_against_cpu(cfg, engines["direct"].model)),
          flush=True)
    print("card vs cpu (split): " + json.dumps(
        check_against_cpu(cfg, engines["split"].model, full=False, **split)), flush=True)
    print("card vs cpu (n_feat 64): " + json.dumps(check_wide(cfg)), flush=True)
    print("card vs cpu (n_sequence 5): " + json.dumps(
        check_against_cpu(cfg.replace(n_sequence=5), engines["nseq5_direct"].model,
                          full=False)), flush=True)
    t1 = time.time()
    print("card vs cpu (n_sequence 1): " + json.dumps(check_n_sequence_1(cfg)),
          flush=True)
    print(f"n_sequence 1: checked in {time.time() - t1:.1f} s", flush=True)
    print("detector: " + json.dumps(check_detector(frames)), flush=True)

    # the training main paths: SPEINet with the template's loss and with the
    # plugins' spec (the VGG and GAN weights of the JAX package's plugin
    # tests), then SWINT; launch counts reset just before each epoch and
    # around each test(); each step then held to the CPU's (the planted K3
    # fault where `plant`)
    records = {}
    swint = cfg_swint()
    for path, tcfg, plant in (("train", cfg, True),
                              ("train_plugins",
                               cfg.replace(loss=cfg.loss + "+0.1*VGG22+0.01*GAN"), False),
                              ("swint", swint, True)):
        t1 = time.time()
        with tempfile.TemporaryDirectory() as work:
            record, counts, backward, trainer, dis0 = run_training(tcfg, work)
            if trainer.gan is not None:
                record["plugins"] = check_plugins(record, trainer, dis0, work)
        del trainer
        records[path] = record
        print(f"main path ({path}): " + json.dumps(dict(record, launches=counts,
                                                        backward_launches=backward)),
              flush=True)
        print(f"main path ({path}): run in {time.time() - t1:.1f} s", flush=True)
        missing = [k for k in TRAIN_LAUNCHES[tcfg.model] if counts[k] <= 0]
        if backward["roll2d"] <= 0:
            missing.append("roll2d (backward)")
        missing += [f"{k} (test)" for k in TEST_LAUNCHES[tcfg.model]
                    if record["test_launches"][k] <= 0]
        if missing:
            raise AssertionError(f"kernels not launched in the {path} steps: {missing}")
        stray = [k for k in TRAIN_SHUNS[tcfg.model] if counts[k] > 0]
        if stray:
            raise AssertionError(f"kernels without a backward or of another model "
                                 f"launched in the {path} steps: {stray}")
        for name, c in ((path, counts), (f"{path}_test", record["test_launches"])):
            by_path[name] = c
            for k in launches:
                launches[k] += c[k]
        t1 = time.time()
        print(f"{path} step card vs cpu: " + json.dumps(check_train_against_cpu(
            tcfg, plant=plant)), flush=True)
        print(f"{path} step card vs cpu: checked in {time.time() - t1:.1f} s",
              flush=True)
    t1 = time.time()
    swint_cpu = check_swint_against_cpu(swint)
    print("swint card vs cpu: " + json.dumps(swint_cpu), flush=True)
    print(f"swint card vs cpu: checked in {time.time() - t1:.1f} s", flush=True)
    by_path["swint_split"] = swint_cpu["split"]["launches"]
    for k in launches:
        launches[k] += by_path["swint_split"][k]
    for name, fn in (("detector_train", check_detector_train), ("ops", check_ops)):
        t1 = time.time()
        print(f"{name}: " + json.dumps(fn()), flush=True)
        print(f"{name}: checked in {time.time() - t1:.1f} s", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    for path, rec in records.items():
        print(f"{path} ({rec['model']}, batch {rec['batch']}, patch {rec['patch']}, bf16, "
              f"loss {rec['loss']}): {rec['ms_per_step']:.1f} ms per step, "
              f"{rec['windows_per_s']:.2f} windows/s, peak memory "
              f"{rec['peak_memory_gib']:.2f} GiB; {smi}", flush=True)
    for path in ("cached", "direct", "nseq5_cached", "nseq5_direct"):
        per_frame = {k: v / n_frames * 1e3
                     for k, v in engines[path].stage_seconds.items() if v}
        print(f"{path}: ms per 720p frame " + json.dumps(per_frame) + f"; {smi}",
              flush=True)
    # K4 under autograd: its launches counted over the phase's main runs
    t1 = time.time()
    k4 = check_k4_grad(0)
    print("k4_grad: " + json.dumps(k4), flush=True)
    print(f"k4_grad: checked in {time.time() - t1:.1f} s", flush=True)
    by_path["k4_grad"] = k4["launches"]
    for k in launches:
        launches[k] += k4["launches"][k]
    t1 = time.time()
    print("profile: " + json.dumps(check_profile(cfg, frames)), flush=True)
    print(f"profile: checked in {time.time() - t1:.1f} s", flush=True)
    t1 = time.time()
    train_shapes = check_train_shapes(0)
    for name, rows in train_shapes.items():
        for row in rows:
            print(f"{name} (train shape) {json.dumps(row)}", flush=True)
    print(f"train shapes: checked in {time.time() - t1:.1f} s", flush=True)

    # the data-parallel paths in a world of one, then the pipeline script;
    # launch counts of the group's train steps and engines reset before each
    t1 = time.time()
    dist_rec = check_dist(cfg, frames, {p: outputs[p] for p in ("cached", "direct")},
                          records["train"]["ms_per_step"])
    print("dist: " + json.dumps(dist_rec), flush=True)
    print(f"dist (world of one, nccl): {dist_rec['ms_per_step_group']:.1f} ms per "
          f"step under the group, {dist_rec['ms_per_step_no_group']:.1f} without "
          f"({100 * dist_rec['group_overhead']:+.2f}%); ms per 720p frame under the "
          "group " + json.dumps({p: e["ms_per_frame"]
                                 for p, e in dist_rec["engines"].items()})
          + f"; {smi}", flush=True)
    print(f"dist: checked in {time.time() - t1:.1f} s", flush=True)
    for name, c in (("dist_train", dist_rec["launches"]),
                    ("dist_cached", dist_rec["engines"]["cached"]["launches"]),
                    ("dist_direct", dist_rec["engines"]["direct"]["launches"])):
        by_path[name] = c
        for k in launches:
            launches[k] += c[k]
    t1 = time.time()
    print("pipeline: " + json.dumps(check_pipeline()), flush=True)
    print(f"pipeline: checked in {time.time() - t1:.1f} s", flush=True)

    meta = {
        "conv2d": ("speinet_tpu_torch/csrc/conv.cu",
                   "speinet_tpu/ops/pallas_conv.py:93"),
        "swin_block": ("speinet_tpu_torch/csrc/swin_block.cu",
                       "speinet_tpu/ops/pallas_swin.py:420"),
        "roll2d": ("speinet_tpu_torch/csrc/roll.cu",
                   "speinet_tpu/ops/pallas_roll.py:115"),
        "banded_corr_argmax": ("speinet_tpu_torch/csrc/corr_banded.cu",
                               "speinet_tpu/ops/pallas_corr.py:526"),
        "correlation_argmax_lds": ("speinet_tpu_torch/csrc/corr_unfold.cu",
                                   "speinet_tpu/ops/pallas_corr.py:260"),
        "correlation_argmax_ld": ("speinet_tpu_torch/csrc/corr_unfold.cu",
                                  "speinet_tpu/ops/pallas_corr.py:204"),
        "correlation_argmax": ("speinet_tpu_torch/csrc/corr_unfold.cu",
                               "speinet_tpu/ops/pallas_corr.py:83"),
        "window_cross_attention": ("speinet_tpu_torch/csrc/swin_attn.cu",
                                   "speinet_tpu/ops/pallas_swin.py:629"),
        "ln_mlp": ("speinet_tpu_torch/csrc/swin_mlp.cu",
                   "speinet_tpu/ops/pallas_swin.py:131"),
        "row_gather": ("speinet_tpu_torch/csrc/row_gather.cu",
                       "speinet_tpu/ops/pallas_gather.py:64"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        rows = checks[name]
        lib = [r["library_ms"] for r in rows]
        ops_ms = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
        train_rows = train_shapes.get(name, [])
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name],
            launches_by_path={p: c[name] for p, c in by_path.items()},
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=sum(r["ms"] for r in rows), plain_ms=sum(r["plain_ms"] for r in rows),
            bound_ms=sum(r["bound_ms"] for r in rows),
            bound_by="operations" if ops_ms * 2 >= sum(r["bound_ms"] for r in rows)
            else "bytes",
            library_ms=None if any(v is None for v in lib) else sum(lib),
            tflops=sum(r.get("flops", 0.0) for r in rows)
            / sum(r["ms"] for r in rows) / 1e9,
            train_ms=sum(r["ms"] for r in train_rows) if train_rows else None,
            train_bound_ms=sum(r["bound_ms"] for r in train_rows) if train_rows
            else None,
            backward_ms=(sum(r["backward_ms"] for r in k4["rows"].values())
                         if name == "banded_corr_argmax" else
                         sum(r.get("backward_ms", 0.0) for r in train_rows) or None)))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
