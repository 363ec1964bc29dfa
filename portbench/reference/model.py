"""Plain float32 reference of SPEINet and SWINT, inference and training.

A frozen, independent statement of the two models' mathematics for the
benchmark's correctness check: plain PyTorch on a dict of named tensors
(the original model's parameter names, so one set of weights serves the
program and this file), NCHW, no kernels, no caches, no batching tricks.
It imports nothing of the program and nothing of JAX.

Every conv, linear and matmul goes through an `Ops` object. `Ops()` is
float32 (TF32 must be off, `precision.strict_float32`); `Ops(fp8)` rounds
every operand of those products to float8 e4m3 with a per-tensor scale,
which is the check's control: the same arithmetic one precision step
below the bfloat16 the configurations state.

Where the published model and the program agree on a quirk, it is kept
here too and named: the sharp pyramid is encoded from the sub-sharp frame
while the routing reads the pre-sharp one; the Swin blocks take queries
from the neighbour stream and keys / values from the centre stream; the
correlation folds the query's patch norms in after the argmax.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]


class Ops:
    """The products of the model, with their operands and results passed
    through `quant` (the identity unless a lower precision is simulated:
    then every product reads and writes that precision, as a kernel that
    computes in it does). Under autograd the rounding is a straight-through
    estimate."""

    def __init__(self, quant: Callable[[torch.Tensor], torch.Tensor] | None = None):
        self.quant = quant

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.quant is None:
            return t
        if t.requires_grad:
            return t + (self.quant(t.detach()) - t.detach())
        return self.quant(t)

    def conv(self, x, w, b=None, stride=1, padding=0):
        return self.q(F.conv2d(self.q(x), self.q(w), b, stride=stride, padding=padding))

    def conv_t(self, x, w, b):
        return self.q(F.conv_transpose2d(self.q(x), self.q(w), b, stride=2, padding=1,
                                         output_padding=1))

    def linear(self, x, w, b=None):
        return self.q(F.linear(self.q(x), self.q(w), b))

    def mm(self, a, b):
        return self.q(self.q(a) @ self.q(b))


# ---------------------------------------------------------------- weights

def _conv_spec(spec, name, cout, cin, k, bias=True):
    spec.append((name + ".weight", (cout, cin, k, k), ("u", cin * k * k)))
    if bias:
        spec.append((name + ".bias", (cout,), ("u", cin * k * k)))


def _lin_spec(spec, name, out, inp, swin=False):
    spec.append((name + ".weight", (out, inp), ("t",) if swin else ("u", inp)))
    spec.append((name + ".bias", (out,), ("zero",) if swin else ("u", inp)))


def _norm_spec(spec, name, c):
    spec.append((name + ".weight", (c,), ("one",)))
    spec.append((name + ".bias", (c,), ("zero",)))


def _bn_spec(spec, name):
    _norm_spec(spec, name, 1)
    spec += [(name + ".running_mean", (1,), ("zero",)),
             (name + ".running_var", (1,), ("one",)),
             (name + ".num_batches_tracked", (), ("count",))]


def _resblock_spec(spec, p, c, k=5):
    _conv_spec(spec, p + ".main.0.main.0", c, c, k)
    _conv_spec(spec, p + ".main.1.main.0", c, c, k)
    _lin_spec(spec, p + ".se.fc.0", c // 4, c)
    _lin_spec(spec, p + ".se.fc.2", c, c // 4)
    for gate, kk in (("cw", 7), ("hc", 5)):
        _conv_spec(spec, f"{p}.te.{gate}.conv.conv", 1, 2, kk, bias=False)
        _bn_spec(spec, f"{p}.te.{gate}.conv.bn")


def _recons_spec(spec, f, n, out_ch):
    r = "recons_net"
    for stage, cin, cout in (("inBlock", 3, f), ("encoder_first", f, 2 * f),
                             ("encoder_second", 2 * f, 4 * f)):
        _conv_spec(spec, f"{r}.{stage}.0.0", cout, cin, 5)
        for i in range(1, n + 1):
            _resblock_spec(spec, f"{r}.{stage}.{i}", cout)
    for stage, cin, cout in (("decoder_second", 4 * f, 2 * f),
                             ("decoder_first", 2 * f, f)):
        for i in range(n):
            _resblock_spec(spec, f"{r}.{stage}.{i}", cin)
        name = f"{r}.{stage}.{n}.0"
        spec.append((name + ".weight", (cin, cout, 3, 3), ("u", cout * 9)))
        spec.append((name + ".bias", (cout,), ("u", cout * 9)))
    for i in range(n):
        _resblock_spec(spec, f"{r}.outBlock.{i}", f)
    _conv_spec(spec, f"{r}.outBlock.{n}", out_ch, f, 5)


def _swin_spec(spec, cin, e, depths, heads, ws, mlp_ratio):
    s = "swin"
    _conv_spec(spec, s + ".conv_first", e, cin, 3)
    _norm_spec(spec, s + ".patch_embed.norm", e)
    hidden = int(e * mlp_ratio)
    for li, (depth, h) in enumerate(zip(depths, heads)):
        for bi in range(depth):
            p = f"{s}.layers.{li}.residual_group.blocks.{bi}"
            _norm_spec(spec, p + ".norm1", e)
            spec.append((p + ".attn.relative_position_bias_table",
                         ((2 * ws - 1) ** 2, h), ("t",)))
            _lin_spec(spec, p + ".attn.qkv_x", 2 * e, e, swin=True)
            _lin_spec(spec, p + ".attn.qkv_y", e, e, swin=True)
            _lin_spec(spec, p + ".attn.proj", e, e, swin=True)
            _norm_spec(spec, p + ".norm2", e)
            _lin_spec(spec, p + ".mlp.fc1", hidden, e, swin=True)
            _lin_spec(spec, p + ".mlp.fc2", e, hidden, swin=True)
        _conv_spec(spec, f"{s}.layers.{li}.conv", e, e, 3)
    _norm_spec(spec, s + ".norm", e)
    _conv_spec(spec, s + ".conv_after_body", e, e, 3)
    _conv_spec(spec, s + ".conv_last", cin, e, 3)


def param_spec(cfg: dict) -> List[tuple]:
    """(name, shape, init) of every tensor of the model `cfg["model"]`
    names, with the original model's names. init: ("u", fan_in) uniform
    in +-fan_in^-1/2, ("t",) truncated normal of std 0.02, ("one",),
    ("zero",), ("count",) an int64 zero."""
    f, n, ns = cfg["n_feat"], cfg["n_resblock"], cfg["n_sequence"]
    spec: List[tuple] = []
    _recons_spec(spec, f, n, cfg["n_colors"])
    _swin_spec(spec, 4 * f, cfg["embed_dim"], cfg["depths"], cfg["num_heads"],
               cfg["window_size"], cfg["mlp_ratio"])
    if cfg["model"].lower() == "swint":
        _conv_spec(spec, "conv", 4 * f, 4 * f * ns, 1)
        return spec
    for name, cout, cin, k in (
            ("conv_lv1", f, 2 * f, 1), ("conv_lv2", 2 * f, 4 * f, 1),
            ("conv_lv3", 4 * f, 8 * f, 1), ("fusion", 4 * f, 4 * f * ns, 1),
            ("search3", 2 * f, 2 * f, 3), ("search2", 2 * f, 4 * f, 1),
            ("search1", 2 * f, 4 * f, 1), ("search43", f, f, 3),
            ("search33", f, 2 * f, 3), ("search23", f, 2 * f, 1),
            ("search13", f, 2 * f, 1), ("SelfTransfer.search1", 2 * f, 4 * f, 1),
            ("SelfTransfer.search2", f, 2 * f, 1)):
        _conv_spec(spec, name, cout, cin, k)
    return spec


def make_weights(cfg: dict, seed: int, device) -> Params:
    """The model's tensors drawn from `seed` on `device` in two draws (one
    uniform, one normal) sliced by name, float32 (the parameters' type)."""
    spec = param_spec(cfg)
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    n_u = sum(int(np.prod(s)) for _, s, init in spec if init[0] == "u")
    n_t = sum(int(np.prod(s)) for _, s, init in spec if init[0] == "t")
    u = torch.rand(n_u, generator=g, device=device) * 2 - 1
    t = torch.randn(n_t, generator=g, device=device).clamp_(-2, 2) * (0.02 / 0.8796)
    out: Params = {}
    iu = it = 0
    for name, shape, init in spec:
        k = int(np.prod(shape))
        if init[0] == "u":
            out[name] = u[iu:iu + k].reshape(shape) * init[1] ** -0.5
            iu += k
        elif init[0] == "t":
            out[name] = t[it:it + k].reshape(shape)
            it += k
        elif init[0] == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
        else:
            out[name] = torch.full(shape, 1.0 if init[0] == "one" else 0.0,
                                   device=device)
    return out


# ---------------------------------------------------------------- blocks

def _gate(p: Params, name: str, plane: torch.Tensor, k: int, ops: Ops,
          train: bool) -> torch.Tensor:
    """[B, 2, A1, A2] pooled plane -> [B, A1, A2]: conv (no bias), then
    BatchNorm with running or batch statistics; no ReLU, no sigmoid."""
    z = ops.conv(plane, p[name + ".conv.weight"], padding=(k - 1) // 2)[:, 0]
    if train:
        mean = z.mean()
        var = torch.clamp((z * z).mean() - mean * mean, min=0.0)
    else:
        mean, var = p[name + ".bn.running_mean"], p[name + ".bn.running_var"]
    inv = torch.rsqrt(var + 1e-5) * p[name + ".bn.weight"]
    return (z - mean) * inv + p[name + ".bn.bias"]


def _triplet(p: Params, name: str, x: torch.Tensor, ops: Ops, train: bool):
    """x [B, C, H, W]: x times the sum of the (H, C) and (C, W) gates."""
    xh = x.permute(0, 2, 3, 1)                                      # B H W C
    cw = torch.stack([xh.amax(dim=2), xh.mean(dim=2)], dim=1)       # B 2 H C
    hc = torch.stack([xh.amax(dim=1), xh.mean(dim=1)], dim=1)       # B 2 W C
    g_cw = _gate(p, name + ".cw.conv", cw, 7, ops, train)           # B H C
    g_hc = _gate(p, name + ".hc.conv", hc.transpose(2, 3), 5, ops, train)  # B C W
    g = g_cw[:, :, None, :] + g_hc.transpose(1, 2)[:, None, :, :]   # B H W C
    return (xh * g).permute(0, 3, 1, 2)


def resblock(p: Params, name: str, x: torch.Tensor, ops: Ops, train: bool):
    """conv5-ReLU-conv5, then squeeze-excite + triplet attention + x."""
    y = torch.relu(ops.conv(x, p[name + ".main.0.main.0.weight"],
                            p[name + ".main.0.main.0.bias"], padding=2))
    y = ops.conv(y, p[name + ".main.1.main.0.weight"],
                 p[name + ".main.1.main.0.bias"], padding=2)
    s = y.mean(dim=(2, 3))
    s = torch.relu(ops.linear(s, p[name + ".se.fc.0.weight"], p[name + ".se.fc.0.bias"]))
    s = torch.sigmoid(ops.linear(s, p[name + ".se.fc.2.weight"],
                                 p[name + ".se.fc.2.bias"]))
    return y * s[:, :, None, None] + _triplet(p, name + ".te", y, ops, train) + x


def _maybe_ckpt(fn, *args, ckpt: bool):
    if ckpt:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class Net:
    """The reference network for one configuration dict. `ckpt` recomputes
    each residual block and Swin block pair in the backward pass, so a
    training step at the template's batch fits on one card in float32."""

    def __init__(self, cfg: dict, ops: Ops | None = None, ckpt: bool = False):
        self.cfg = cfg
        self.ops = ops or Ops()
        self.ckpt = ckpt
        self.n = cfg["n_resblock"]
        self.ws = cfg["window_size"]
        self.heads = cfg["num_heads"]
        self.depths = cfg["depths"]
        self.drop_rates = np.linspace(0, cfg["drop_path_rate"], sum(self.depths)).tolist()

    # -- hourglass ----------------------------------------------------------
    def _res(self, p, name, x, train):
        return _maybe_ckpt(lambda t: resblock(p, name, t, self.ops, train), x,
                           ckpt=self.ckpt and train)

    def _encode(self, p, stage, x, stride, train):
        x = torch.relu(self.ops.conv(x, p[f"recons_net.{stage}.0.0.weight"],
                                     p[f"recons_net.{stage}.0.0.bias"],
                                     stride=stride, padding=2))
        for i in range(1, self.n + 1):
            x = self._res(p, f"recons_net.{stage}.{i}", x, train)
        return x

    def encode_pyramid(self, p, x, train=False):
        """[B, 3, H, W] -> (lv1, lv2, lv3)."""
        lv1 = self._encode(p, "inBlock", x, 1, train)
        lv2 = self._encode(p, "encoder_first", lv1, 2, train)
        return lv1, lv2, self._encode(p, "encoder_second", lv2, 2, train)

    def _up(self, p, stage, x, train):
        for i in range(self.n):
            x = self._res(p, f"recons_net.{stage}.{i}", x, train)
        name = f"recons_net.{stage}.{self.n}.0"
        return torch.relu(self.ops.conv_t(x, p[name + ".weight"], p[name + ".bias"]))

    def out_block(self, p, x, train):
        for i in range(self.n):
            x = self._res(p, f"recons_net.outBlock.{i}", x, train)
        name = f"recons_net.outBlock.{self.n}"
        return self.ops.conv(x, p[name + ".weight"], p[name + ".bias"], padding=2)

    # -- Swin fusion --------------------------------------------------------
    def _block(self, p, name, x, y, hh, ww, shift, drop):
        """One cross-attention Swin block on token streams x (keys, values;
        updated) and y (queries) [B, L, C]."""
        ops = self.ops
        b, l, c = x.shape
        heads = self.heads[int(name.split(".")[2])]
        ws, ss = self.ws, shift
        if min(hh, ww) <= ws:
            ss, ws = 0, min(hh, ww)
        ph, pw = (-hh) % ws, (-ww) % ws
        n = ws * ws
        hd = c // heads

        def img(t):
            t = F.pad(t.reshape(b, hh, ww, c), (0, 0, 0, pw, 0, ph))
            return torch.roll(t, (-ss, -ss), dims=(1, 2)) if ss else t

        def windows(t):
            hp, wp = t.shape[1:3]
            t = t.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
            return t.reshape(-1, n, c)

        xi, yi = img(x), img(y)
        hp, wp = xi.shape[1:3]
        xw = windows(F.layer_norm(xi, (c,), p[name + ".norm1.weight"],
                                  p[name + ".norm1.bias"], 1e-5))
        yw = windows(F.layer_norm(yi, (c,), p[name + ".norm1.weight"],
                                  p[name + ".norm1.bias"], 1e-5))
        bw = xw.shape[0]
        k, v = ops.linear(xw, p[name + ".attn.qkv_x.weight"],
                          p[name + ".attn.qkv_x.bias"]).split(c, dim=-1)
        q = ops.linear(yw, p[name + ".attn.qkv_y.weight"], p[name + ".attn.qkv_y.bias"])
        q = q.reshape(bw, n, heads, hd).transpose(1, 2) * hd ** -0.5
        k = k.reshape(bw, n, heads, hd).transpose(1, 2)
        v = v.reshape(bw, n, heads, hd).transpose(1, 2)
        table = p[name + ".attn.relative_position_bias_table"]
        idx = torch.from_numpy(relative_position_index(ws).reshape(-1)).to(table.device)
        bias = table[idx].reshape(n, n, heads).permute(2, 0, 1)
        attn = ops.mm(q, k.transpose(-1, -2)) + bias[None]
        mask = window_mask(hp, wp, ws, ss, ph, pw)
        if mask is not None:
            m = torch.from_numpy(mask).to(attn.device)
            nw = m.shape[0]
            attn = (attn.reshape(bw // nw, nw, heads, n, n) + m[None, :, None]
                    ).reshape(bw, heads, n, n)
        o = ops.mm(torch.softmax(attn, dim=-1), v).transpose(1, 2).reshape(bw, n, c)
        o = ops.linear(o, p[name + ".attn.proj.weight"], p[name + ".attn.proj.bias"])
        o = o.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        o = o.reshape(b, hp, wp, c)
        if ss:
            o = torch.roll(o, (ss, ss), dims=(1, 2))
        o = o[:, :hh, :ww].reshape(b, l, c)
        x = x + drop_path(o, drop, 0)
        h = F.layer_norm(x, (c,), p[name + ".norm2.weight"], p[name + ".norm2.bias"], 1e-5)
        h = F.gelu(ops.linear(h, p[name + ".mlp.fc1.weight"], p[name + ".mlp.fc1.bias"]))
        h = ops.linear(h, p[name + ".mlp.fc2.weight"], p[name + ".mlp.fc2.bias"])
        return x + drop_path(h, drop, 1)

    def swin(self, p, x, y, train=False, drops=None):
        """x, y [B, C, h, w] -> x + the cross-frame SwinIR residual."""
        ops = self.ops
        b, _, hh, ww = x.shape
        x_first = ops.conv(x, p["swin.conv_first.weight"], p["swin.conv_first.bias"],
                           padding=1)
        y_first = ops.conv(y, p["swin.conv_first.weight"], p["swin.conv_first.bias"],
                           padding=1)
        e = x_first.shape[1]
        tokens = lambda t: t.permute(0, 2, 3, 1).reshape(b, hh * ww, e)
        image = lambda t: t.reshape(b, hh, ww, e).permute(0, 3, 1, 2)
        pn = (p["swin.patch_embed.norm.weight"], p["swin.patch_embed.norm.bias"])
        xe = F.layer_norm(tokens(x_first), (e,), *pn, 1e-6)
        ye = F.layer_norm(tokens(y_first), (e,), *pn, 1e-6)
        feat, k = xe, 0
        for li, depth in enumerate(self.depths):
            res = feat
            for bi in range(0, depth, 2):
                names = [f"swin.layers.{li}.residual_group.blocks.{j}"
                         for j in range(bi, min(bi + 2, depth))]
                ds = [drops[k + bi + j] if drops else None for j in range(len(names))]

                def pair(t, names=names, ds=ds):
                    for j, nm in enumerate(names):
                        t = self._block(p, nm, t, ye, hh, ww,
                                        0 if (bi + j) % 2 == 0 else self.ws // 2, ds[j])
                    return t

                res = _maybe_ckpt(pair, res, ckpt=self.ckpt and train)
            k += depth
            conv = f"swin.layers.{li}.conv"
            feat = tokens(ops.conv(image(res), p[conv + ".weight"], p[conv + ".bias"],
                                   padding=1)) + feat
        feat = F.layer_norm(feat, (e,), p["swin.norm.weight"], p["swin.norm.bias"], 1e-6)
        res = ops.conv(image(feat), p["swin.conv_after_body.weight"],
                       p["swin.conv_after_body.bias"], padding=1) + x_first
        return x + ops.conv(res, p["swin.conv_last.weight"], p["swin.conv_last.bias"],
                            padding=1)

    def draw_drops(self, batch: int, generator, device):
        """Per block in order: None where its rate is 0, else (rate, keep
        [2, batch] bool), one uniform draw [2, batch] per such block."""
        drops = []
        for rate in self.drop_rates:
            if rate == 0.0:
                drops.append(None)
                continue
            u = torch.rand((2, batch), generator=generator, device=device)
            drops.append((rate, u < 1.0 - rate))
        return drops

    def fuse(self, p, f_mid, nbs, train=False, drops=None):
        """Centre features fused with each neighbour's through one batched
        Swin call -> [B, C n_sequence, h, w]."""
        b = f_mid.shape[0]
        f_trans = self.swin(p, torch.cat([f_mid] * len(nbs)), torch.cat(nbs),
                            train, drops)
        return torch.cat([f_mid] + [f_trans[k * b:(k + 1) * b]
                                    for k in range(len(nbs))], dim=1)

    # -- SPEINet's search, transfer and decoder -----------------------------
    def _c1(self, p, name, x):
        return self.ops.conv(x, p[name + ".weight"], p[name + ".bias"])

    def _fast(self, p, name, x):
        return torch.relu(self.ops.conv(x, p[name + ".weight"], p[name + ".bias"],
                                        padding=1))

    def correlate(self, q_map, r_map, chunk: int = 2048):
        """S[i] = max_j <patch_q[i], patch_r[j]> / |patch_r[j]| / |patch_q[i]|
        over 3x3 zero-padded patches, and the first j attaining the max
        (row-major over r_map). q_map, r_map [B, C, h, w]."""
        qu = F.unfold(q_map, 3, padding=1)                 # B D L
        ru = F.unfold(r_map, 3, padding=1)                 # B D Lr
        inv_q = 1.0 / torch.clamp(qu.norm(dim=1), min=1e-12)
        inv_r = 1.0 / torch.clamp(ru.norm(dim=1), min=1e-12)
        b, _, l = qu.shape
        best = torch.full((b, l), float("-inf"), device=qu.device)
        arg = torch.zeros((b, l), dtype=torch.int64, device=qu.device)
        for j0 in range(0, ru.shape[2], chunk):
            r = self.ops.mm(ru[:, :, j0:j0 + chunk].transpose(1, 2), qu)
            r = r * inv_r[:, j0:j0 + chunk, None]
            cmax, carg = r.max(dim=1)
            upd = cmax > best
            best = torch.where(upd, cmax, best)
            arg = torch.where(upd, carg + j0, arg)
        return best * inv_q, arg

    def texture(self, ref: torch.Tensor, idx: torch.Tensor, s: int) -> torch.Tensor:
        """The reference's transfer: fold(gather(unfold(ref, 3s, stride s,
        pad s), idx)) / 9 for ref [B, C, s h, s w] and idx [B, h w]."""
        b, c, hs, ws_ = ref.shape
        u = F.unfold(ref, 3 * s, padding=s, stride=s)
        g = torch.gather(u, 2, idx[:, None, :].expand(-1, u.shape[1], -1))
        return F.fold(g, (hs, ws_), 3 * s, padding=s, stride=s) / 9.0

    def transfer(self, p, f_fusion, lv1, lv2, lv3, has_sharp: torch.Tensor):
        """(S [B, 1, h, w], T3, T2, T1): per sample, the sharp pyramid's
        search and texture where `has_sharp`, else the self search (the
        fused map transposed and flipped) and the self textures."""
        b, c, hh, ww = f_fusion.shape
        own = torch.flip(f_fusion.transpose(2, 3), dims=(2,))
        s_rows, t_rows = [], []
        for i in range(b):
            fi = f_fusion[i:i + 1]
            if bool(has_sharp[i]):
                s, idx = self.correlate(fi, lv3[i:i + 1])
                t = (self.texture(lv3[i:i + 1], idx, 1),
                     self.texture(lv2[i:i + 1], idx, 2),
                     self.texture(lv1[i:i + 1], idx, 4))
            else:
                s, _ = self.correlate(fi, own[i:i + 1])
                up2 = F.interpolate(fi, scale_factor=2, mode="bicubic", align_corners=False)
                t2 = torch.relu(self._c1(p, "SelfTransfer.search1", up2))
                up4 = F.interpolate(t2, scale_factor=2, mode="bicubic", align_corners=False)
                t = (fi, t2, torch.relu(self._c1(p, "SelfTransfer.search2", up4)))
            s_rows.append(s.reshape(1, 1, hh, ww))
            t_rows.append(t)
        return (torch.cat(s_rows),) + tuple(torch.cat([t[k] for t in t_rows])
                                            for k in range(3))

    def decode(self, p, f_fusion, s, t3, t2, t1, train=False):
        up = lambda t, k: F.interpolate(t, scale_factor=k, mode="bicubic",
                                        align_corners=False)
        cat = lambda *ts: torch.cat(ts, dim=1)
        f_lv3 = f_fusion + self._c1(p, "conv_lv3", cat(f_fusion, t3)) * s
        dec2 = self._up(p, "decoder_second", f_lv3, train)
        f_lv2 = dec2 + self._c1(p, "conv_lv2", cat(dec2, t2)) * up(s, 2)
        search_1 = torch.relu(self._c1(p, "search1", up(f_lv3, 2)))
        search_2 = self._fast(p, "search3", f_lv2)
        search_11 = torch.relu(self._c1(p, "search2", cat(dec2, search_1)))
        search_22 = torch.relu(self._c1(p, "search2", cat(f_lv2, search_2)))
        f_v3 = dec2 + search_11
        f_lv2 = f_lv2 + search_22
        dec1 = self._up(p, "decoder_first", f_lv2, train)
        f_lv1 = dec1 + self._c1(p, "conv_lv1", cat(dec1, t1)) * up(s, 4)
        search_13 = torch.relu(self._c1(p, "search13", up(f_v3, 2)))
        search_23 = self._fast(p, "search33", up(f_lv2, 2))
        search_33 = self._fast(p, "search43", f_lv1)
        f_lv1 = (f_lv1 + self._fast(p, "search33", cat(search_13, search_23))
                 + self._fast(p, "search33", cat(search_13, search_33))
                 + self._fast(p, "search33", cat(search_23, search_33)))
        return self.out_block(p, f_lv1, train)

    # -- whole models -------------------------------------------------------
    def legs(self, p, frames):
        """Per frame [F, 3, H, W]: (M, N) = (enc(f) + enc(RL5 f),
        enc(f) + enc(RL1 f)) at lv3, the centre and neighbour features."""
        e = self.encode_pyramid(p, frames)[2]
        e1 = self.encode_pyramid(p, richardson_lucy(frames, 1))[2]
        e5 = self.encode_pyramid(p, richardson_lucy(frames, 5))[2]
        return e + e5, e + e1

    def restore(self, p, f_mid, nbs, anchor_pyr, has_sharp, train=False, drops=None):
        """The restored centre frames [B, 3, H, W] from the centre and
        neighbour features and the anchor pyramid (SPEINet)."""
        f_fusion = self._c1(p, "fusion", self.fuse(p, f_mid, nbs, train, drops))
        s, t3, t2, t1 = self.transfer(p, f_fusion, *anchor_pyr, has_sharp)
        return self.decode(p, f_fusion, s, t3, t2, t1, train)

    def speinet_train_forward(self, p, x, drops, has_sharp=None):
        """SPEINet's training forward on x [B, n + 2, 3, H, W]: every leg
        (sub-sharp, centre, RL5 centre, each neighbour and its RL1) through
        one encoder call, so the gates' statistics are the stacked batch's;
        'mixed' routing on the pre-sharp frame being non-zero (or as
        `has_sharp` [B] says)."""
        ns = self.cfg["n_sequence"]
        b, mid = x.shape[0], ns // 2
        nbs_in = [x[:, i] for i in range(ns) if i != mid]
        legs = [x[:, ns + 1], x[:, mid], richardson_lucy(x[:, mid], 5)]
        if nbs_in:
            rl = richardson_lucy(torch.cat(nbs_in), 1)
            for k, nb in enumerate(nbs_in):
                legs += [nb, rl[k * b:(k + 1) * b]]
        lv1, lv2, lv3 = self.encode_pyramid(p, torch.cat(legs), train=True)
        leg = lambda k: lv3[k * b:(k + 1) * b]
        nbs = [leg(3 + 2 * k) + leg(4 + 2 * k) for k in range(len(nbs_in))]
        if has_sharp is None:
            has_sharp = ~(x[:, min(3, ns + 1)] == 0).flatten(1).all(dim=1)
        return self.restore(p, leg(1) + leg(2), nbs, (lv1[:b], lv2[:b], lv3[:b]),
                            has_sharp, True, drops)

    def swint_forward(self, p, x, train=False, drops=None):
        """SWINT on x [B, >= n, 3, H, W]: each frame encoded (at once for
        inference; one frame at a time, centre first, in training, so each
        gate normalises with that frame's statistics), fused, decoded."""
        ns = self.cfg["n_sequence"]
        b, mid = x.shape[0], ns // 2
        order = [mid] + [i for i in range(ns) if i != mid]
        if train:
            feats = [self.encode_pyramid(p, x[:, i], True)[2] for i in order]
        else:
            lv3 = self.encode_pyramid(p, torch.cat([x[:, i] for i in order]))[2]
            feats = [lv3[k * b:(k + 1) * b] for k in range(ns)]
        f = self._c1(p, "conv", self.fuse(p, feats[0], feats[1:], train, drops))
        return self.out_block(p, self._up(p, "decoder_first",
                                          self._up(p, "decoder_second", f, train),
                                          train), train)


def drop_path(x: torch.Tensor, drop, branch: int) -> torch.Tensor:
    """Per-sample stochastic depth of one residual branch: kept samples
    scaled by 1 / (1 - rate), dropped ones zeroed."""
    if drop is None:
        return x
    rate, keep = drop
    k = keep[branch].reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.where(k, x / (1.0 - rate), torch.zeros_like(x))


def richardson_lucy(image: torch.Tensor, iterations: int, lam: float = 0.01):
    """The edge branch: Laplacian-regularised Richardson-Lucy with a 5x5
    box PSF, zero 'SAME' padding; NaN and negative ratios set to 0."""
    c = image.shape[1]
    box = torch.full((c, 1, 5, 5), 1.0 / 25, device=image.device, dtype=image.dtype)
    lap = torch.tensor([[0.0, -1.0, 0.0], [-1.0, 4.0, -1.0], [0.0, -1.0, 0.0]],
                       device=image.device, dtype=image.dtype).expand(c, 1, 3, 3)
    out = image
    for _ in range(iterations):
        blurred = F.conv2d(out, box, padding=2, groups=c)
        ratio = image / blurred
        ratio = torch.where(torch.isnan(ratio) | (ratio < 0), torch.zeros_like(ratio),
                            ratio)
        out = ratio * (out + lam * F.conv2d(out, lap, padding=1, groups=c))
    return out


def relative_position_index(ws: int) -> np.ndarray:
    """[ws^2, ws^2] index into the (2 ws - 1)^2 relative-position table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return rel[:, :, 0] * (2 * ws - 1) + rel[:, :, 1]


def window_mask(hp: int, wp: int, ws: int, shift: int, ph: int, pw: int):
    """[nW, N, N] additive mask, -100 per violated rule: keys from another
    region of the shifted image, keys that are padding (after the roll);
    None where neither applies."""
    mask = None
    if shift > 0:
        region = np.zeros((hp, wp))
        cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
        for k, (a, b) in enumerate((a, b) for a in cuts for b in cuts):
            region[a, b] = k
        m = region.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3)
        m = m.reshape(-1, ws * ws)
        mask = np.where(m[:, None, :] != m[:, :, None], -100.0, 0.0)
    if ph or pw:
        pad = np.zeros((hp, wp))
        pad[hp - ph:, :] = 1.0
        pad[:, wp - pw:] = 1.0
        if shift > 0:
            pad = np.roll(pad, (-shift, -shift), axis=(0, 1))
        pm = pad.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3)
        pm = pm.reshape(-1, ws * ws)
        pmask = np.where(pm[:, None, :] > 0, -100.0, 0.0)
        mask = pmask if mask is None else mask + pmask
    return None if mask is None else mask.astype(np.float32)


def speinet_windows(p: Params, net: Net, frames: torch.Tensor,
                    anchor: torch.Tensor, has_sharp: Sequence[bool],
                    ) -> torch.Tensor:
    """Restore windows one at a time: frames [B, n, 3, H, W], anchor
    [B, 3, H, W] (the sub-sharp frame or zeros), `has_sharp` per window ->
    [B, 3, H, W]."""
    ns = net.cfg["n_sequence"]
    mid = ns // 2
    outs = []
    for i in range(frames.shape[0]):
        m, n = net.legs(p, frames[i])
        nbs = [n[k:k + 1] for k in range(ns) if k != mid]
        pyr = net.encode_pyramid(p, anchor[i:i + 1])
        outs.append(net.restore(p, m[mid:mid + 1], nbs, pyr,
                                torch.tensor([bool(has_sharp[i])])))
    return torch.cat(outs)
