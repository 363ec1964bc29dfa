"""Model FLOPs, counted by `torch.utils.flop_counter.FlopCounterMode` over
the frozen reference on meta tensors (shapes only, nothing computed), so
the yardstick is the same work whatever implements it; and K2's
operations and bytes from its shapes."""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.model import Net, Ops, param_spec
from portbench.reference.train import forward, is_param, loss_fn
from portbench.reference.windows import windows


def _meta_params(cfg: dict, grad: bool = False):
    return {name: torch.empty(shape, device="meta",
                              dtype=torch.int64 if init[0] == "count" else torch.float32,
                              requires_grad=grad and init[0] != "count" and is_param(name))
            for name, shape, init in param_spec(cfg)}


def _count(fn) -> float:
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


@functools.lru_cache(maxsize=8)
def _video_parts(cfg_json: str, h: int, w: int) -> dict:
    """FLOPs of one frame's legs, one anchor pyramid, one window's restore
    per routing, at h x w."""
    cfg = json.loads(cfg_json)
    net, p = Net(cfg, Ops()), _meta_params(cfg)
    f, ns = cfg["n_feat"], cfg["n_sequence"]
    frame = torch.empty((1, 3, h, w), device="meta")
    feat = lambda c, s: torch.empty((1, c, h // s, w // s), device="meta")
    pyr = (feat(f, 1), feat(2 * f, 2), feat(4 * f, 4))
    nbs = [feat(4 * f, 4) for _ in range(ns - 1)]
    with torch.no_grad():
        return {"legs": _count(lambda: net.legs(p, frame)),
                "anchor": _count(lambda: net.encode_pyramid(p, frame)),
                "sharp": _count(lambda: net.restore(p, feat(4 * f, 4), nbs, pyr,
                                                    torch.tensor([True]))),
                "self": _count(lambda: net.restore(p, feat(4 * f, 4), nbs, pyr,
                                                   torch.tensor([False])))}


def video_flops(cfg: dict, vids, done, h: int, w: int) -> float:
    """FLOPs the restored windows `done` [(video, window), ...] need: each
    frame's legs, each window's restore in its routing, each distinct
    anchor of a video once."""
    parts = _video_parts(json.dumps(cfg, sort_keys=True), h, w)
    per_video = {}
    total, anchors = 0.0, set()
    for v, wi in done:
        if v not in per_video:
            per_video[v] = windows(vids.keys(v, "blur"), vids.get(v)[1], cfg["n_sequence"])
        _, hs, anchor = per_video[v][wi]
        total += parts["legs"] + parts["sharp" if hs else "self"]
        anchors.add((v, anchor))
    return total + len(anchors) * parts["anchor"]


@functools.lru_cache(maxsize=8)
def train_step_flops(cfg_json: str, batch: int, patch: int, n_sharp: int) -> float:
    """FLOPs of one training step's forward and backward (no recomputation)
    at the batch and patch, `n_sharp` of the samples routed to the sharp
    search."""
    cfg = json.loads(cfg_json)
    net, p = Net(cfg, Ops()), _meta_params(cfg, grad=True)
    x = torch.empty((batch, cfg["n_sequence"] + 2, 3, patch, patch), device="meta")
    gt = torch.empty((batch, 3, patch, patch), device="meta")
    hs = torch.tensor([i < n_sharp for i in range(batch)])

    def step():
        out = forward(net, p, x, None, hs)
        u = torch.empty((batch, patch * patch), device="meta")
        loss = loss_fn(out, gt, u)
        loss.backward()

    return _count(step)


def k2_launch(cfg: dict, bw: int, h: int, w: int) -> dict:
    """Tokens, FLOPs per token and bytes of one K2 launch over the Swin
    call of a chunk: the centre stream against each neighbour,
    bw (n_sequence - 1) maps of h/4 x w/4 at embed_dim channels, bf16
    streams, bf16 weight matrices and float32 vectors."""
    c, ws = cfg["embed_dim"], cfg["window_size"]
    hidden = int(c * cfg["mlp_ratio"])
    heads = cfg["num_heads"][0]
    n = ws * ws
    tokens = bw * (cfg["n_sequence"] - 1) * (h // 4) * (w // 4)
    flops_per_token = 2.0 * (4 * c * c + 2 * c * hidden) + 4.0 * n * c
    wbytes = 2 * (4 * c * c + 2 * c * hidden) + 4 * (8 * c + hidden + heads * n * n)
    return {"tokens": tokens, "flops_per_token": flops_per_token,
            "stream_bytes_per_token": 3 * c * 2, "weight_bytes": wbytes}
