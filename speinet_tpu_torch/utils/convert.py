"""speinet_tpu flax parameters -> port state_dict.

The inverse of `speinet_tpu/utils/convert.py::convert_state_dict`, written
without JAX: the input is the flax tree as nested dicts of array-likes
(numpy arrays), as `jax.device_get(variables)` gives them. Layouts:
    flax Conv kernel          [kh, kw, I, O] -> torch Conv2d [O, I, kh, kw]
    ConvTransposeTorch kernel [kh, kw, O, I] -> torch ConvTranspose2d [I, O, kh, kw]
    flax Dense kernel         [I, O]         -> torch Linear [O, I]
    BatchNorm scale / bias + batch_stats mean / var
                                             -> weight / bias / running_mean / running_var
Swin blocks: the flax model scans W/SW block pairs, so block i of layer L
comes from `swin/layer{L}/pairs/block_{w|sw}` at index i // 2 (odd depths
are unrolled as `block{i}`).

The flax model never calls `search23` (speinet.py:113 defines it for
parity), so its tree has no such leaves; the port keeps the layer, and it
is filled with zeros here. Every window length converts alike: the fusion
conv's input width, 4 n_feat n_sequence, comes with its kernel.

`swint_from_flax` converts a SWINT tree (recons_net, swin and its 1x1
fusion conv `conv`); `flax_model_name` tells the two trees apart.
`discriminator_from_flax` converts the GAN plugin's discriminator
(`training/adversarial.py`: flax `Conv_{i}` -> `convs.{i}`).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(node) -> Dict[str, torch.Tensor]:
    out = {"weight": _t(np.asarray(node["kernel"]).transpose(3, 2, 0, 1))}
    if "bias" in node:
        out["bias"] = _t(node["bias"])
    return out


def _dense(node) -> Dict[str, torch.Tensor]:
    return {"weight": _t(np.asarray(node["kernel"]).T), "bias": _t(node["bias"])}


def _put(sd: dict, prefix: str, leaves: Dict[str, torch.Tensor]) -> None:
    for k, v in leaves.items():
        sd[f"{prefix}.{k}"] = v


def _resblock(sd, prefix, p, bs) -> None:
    _put(sd, f"{prefix}.main.0.main.0", _conv(p["conv1"]["Conv_0"]))
    _put(sd, f"{prefix}.main.1.main.0", _conv(p["conv2"]["Conv_0"]))
    _put(sd, f"{prefix}.se.fc.0", _dense(p["se"]["Dense_0"]))
    _put(sd, f"{prefix}.se.fc.2", _dense(p["se"]["Dense_1"]))
    for g in ("cw", "hc"):
        gp, gb = p["te"][g], bs["te"][g]["BatchNorm_0"]
        _put(sd, f"{prefix}.te.{g}.conv.conv", _conv(gp["Conv_0"]))
        bn = f"{prefix}.te.{g}.conv.bn"
        sd[f"{bn}.weight"] = _t(gp["BatchNorm_0"]["scale"])
        sd[f"{bn}.bias"] = _t(gp["BatchNorm_0"]["bias"])
        sd[f"{bn}.running_mean"] = _t(gb["mean"])
        sd[f"{bn}.running_var"] = _t(gb["var"])
        sd[f"{bn}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _recons(sd, p, bs, n_res: int) -> None:
    for name, conv, res in (("inBlock", "in_conv", "in_res"),
                            ("encoder_first", "enc1_conv", "enc1_res"),
                            ("encoder_second", "enc2_conv", "enc2_res")):
        _put(sd, f"recons_net.{name}.0.0", _conv(p[conv]["Conv_0"]))
        for i in range(n_res):
            _resblock(sd, f"recons_net.{name}.{i + 1}", p[res][f"res{i}"],
                      bs[res][f"res{i}"])
    for name, res, up in (("decoder_second", "dec2_res", "dec2_up"),
                          ("decoder_first", "dec1_res", "dec1_up")):
        for i in range(n_res):
            _resblock(sd, f"recons_net.{name}.{i}", p[res][f"res{i}"],
                      bs[res][f"res{i}"])
        k = np.asarray(p[up]["kernel"])
        sd[f"recons_net.{name}.{n_res}.0.weight"] = _t(k.transpose(3, 2, 0, 1))
        sd[f"recons_net.{name}.{n_res}.0.bias"] = _t(p[up]["bias"])
    for i in range(n_res):
        _resblock(sd, f"recons_net.outBlock.{i}", p["out_res"][f"res{i}"],
                  bs["out_res"][f"res{i}"])
    _put(sd, f"recons_net.outBlock.{n_res}", _conv(p["out_conv"]))


def _swin_block(sd, prefix, node, idx) -> None:
    pick = (lambda a: np.asarray(a)[idx]) if idx is not None else np.asarray
    sd[f"{prefix}.norm1.weight"] = _t(pick(node["norm1"]["scale"]))
    sd[f"{prefix}.norm1.bias"] = _t(pick(node["norm1"]["bias"]))
    sd[f"{prefix}.norm2.weight"] = _t(pick(node["norm2"]["scale"]))
    sd[f"{prefix}.norm2.bias"] = _t(pick(node["norm2"]["bias"]))
    for mine, theirs in (("attn.qkv_x", ("attn", "qkv_x")),
                         ("attn.qkv_y", ("attn", "qkv_y")),
                         ("attn.proj", ("attn", "proj")),
                         ("mlp.fc1", ("mlp_fc1",)), ("mlp.fc2", ("mlp_fc2",))):
        leaf = node
        for k in theirs:
            leaf = leaf[k]
        sd[f"{prefix}.{mine}.weight"] = _t(pick(leaf["kernel"]).T)
        sd[f"{prefix}.{mine}.bias"] = _t(pick(leaf["bias"]))
    sd[f"{prefix}.attn.relative_position_bias_table"] = _t(
        pick(node["attn"]["relative_position_bias_table"]))


def _swin(sd, p, depths) -> None:
    for name in ("conv_first", "conv_after_body", "conv_last"):
        _put(sd, f"swin.{name}", _conv(p[name]))
    sd["swin.norm.weight"] = _t(p["norm"]["scale"])
    sd["swin.norm.bias"] = _t(p["norm"]["bias"])
    sd["swin.patch_embed.norm.weight"] = _t(p["patch_embed_norm"]["scale"])
    sd["swin.patch_embed.norm.bias"] = _t(p["patch_embed_norm"]["bias"])
    for li, depth in enumerate(depths):
        lp = p[f"layer{li}"]
        _put(sd, f"swin.layers.{li}.conv", _conv(lp["conv"]))
        for i in range(depth):
            prefix = f"swin.layers.{li}.residual_group.blocks.{i}"
            if "pairs" in lp:
                which = "block_w" if i % 2 == 0 else "block_sw"
                _swin_block(sd, prefix, lp["pairs"][which], i // 2)
            else:
                _swin_block(sd, prefix, lp[f"block{i}"], None)


def flax_model_name(params: Dict[str, Any]) -> str:
    """'SWINT' or 'SPEINet': the model a flax tree belongs to, by its keys
    (SWINT has a fusion conv `conv` and no `conv_lv1`)."""
    return "SWINT" if "conv_lv1" not in params and "conv" in params else "SPEINet"


def flax_model_shape(params: Dict[str, Any]) -> Dict[str, Any]:
    """The configuration a SPEINet or SWINT flax tree was built with, read
    off its shapes: n_feat, n_sequence (from the fusion conv's input width,
    4 n_feat n_sequence), embed_dim, depths and n_resblock."""
    if flax_model_name(params) == "SWINT":
        fusion = np.shape(params["conv"]["kernel"])
        n_feat = fusion[3] // 4
    else:
        fusion = np.shape(params["fusion"]["kernel"])
        n_feat = np.shape(params["conv_lv1"]["kernel"])[3]
    depths = []
    for li in range(sum(k.startswith("layer") for k in params["swin"])):
        lp = params["swin"][f"layer{li}"]
        depths.append(2 * np.shape(lp["pairs"]["block_w"]["norm1"]["scale"])[0]
                      if "pairs" in lp else sum(k.startswith("block") for k in lp))
    return dict(n_feat=int(n_feat),
                n_sequence=int(fusion[2] // (4 * n_feat)),
                embed_dim=int(np.shape(params["swin"]["conv_first"]["kernel"])[3]),
                depths=[int(d) for d in depths],
                n_resblock=len(params["recons_net"]["in_res"]))


def from_flax_params(params: Dict[str, Any], batch_stats: Dict[str, Any],
                     depths: Sequence[int] = (6, 6, 6, 6, 6, 6),
                     n_resblock: int = 3) -> Dict[str, torch.Tensor]:
    """The speinet_tpu SPEINet tree (params, batch_stats) as a state_dict
    that the port's SPEINet loads with strict=True."""
    sd: Dict[str, torch.Tensor] = {}
    _recons(sd, params["recons_net"], batch_stats["recons_net"], n_resblock)
    _swin(sd, params["swin"], depths)
    for name in ("conv_lv1", "conv_lv2", "conv_lv3", "fusion", "search3",
                 "search2", "search1", "search43", "search33", "search13"):
        _put(sd, name, _conv(params[name]))
    sd["search23.weight"] = torch.zeros_like(sd["search13.weight"])
    sd["search23.bias"] = torch.zeros_like(sd["search13.bias"])
    _put(sd, "SelfTransfer.search1", _conv(params["transfer"]["self_search1"]))
    _put(sd, "SelfTransfer.search2", _conv(params["transfer"]["self_search2"]))
    return sd


def swint_from_flax(params: Dict[str, Any], batch_stats: Dict[str, Any],
                    depths: Sequence[int] = (6, 6, 6, 6, 6, 6),
                    n_resblock: int = 3) -> Dict[str, torch.Tensor]:
    """The speinet_tpu SWINT tree (params, batch_stats) as a state_dict
    that the port's SWINT loads with strict=True."""
    sd: Dict[str, torch.Tensor] = {}
    _recons(sd, params["recons_net"], batch_stats["recons_net"], n_resblock)
    _swin(sd, params["swin"], depths)
    _put(sd, "conv", _conv(params["conv"]))
    return sd


def discriminator_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's discriminator params ({'Conv_0': ..., 'Conv_6': ...},
    `TrainState.gan['params']`) as the port Discriminator's state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(len(params)):
        _put(sd, f"convs.{i}", _conv(params[f"Conv_{i}"]))
    return sd
