"""VGG perceptual loss plugin (port of `speinet_tpu/training/perceptual.py`;
the reference's `loss.vgg`, a module its repository does not have).

Features of the VGG19 conv plan (3x3 convs + ReLU, a 2x2 max pool after each
stage; 64-64 / 128-128 / 256x4 / 512x4 / 512x4) up to relu2_2 ("22") or
relu5_4 ("54"), on inputs mapped from [0, rgb_range] to [0, 1] and
normalised with the ImageNet mean and std, all in float32; the loss is the
mean squared difference of the output's and the ground truth's features,
the latter without a gradient.

The weights are the JAX package's: an .npz of HWIO kernels `conv{i}` (and
optional biases `bias{i}`) named by `SPEINET_VGG_WEIGHTS`, or else its
deterministic He-initialised bank, drawn from `np.random.default_rng(0)` in
the same order, so both packages hold identical weights with nothing to
convert. The convs are plain `F.conv2d`, as the JAX package runs `lax.conv`
outside any Pallas kernel.
"""

from __future__ import annotations

import functools
import os
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# (out_channels, n_convs) per stage; a 2x2 / 2 max pool follows each stage
VGG19_PLAN: Tuple[Tuple[int, int], ...] = (
    (64, 2), (128, 2), (256, 4), (512, 4), (512, 4))

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def layers_upto(conv_index: str) -> List[Tuple[int, int, bool]]:
    """[(in_ch, out_ch, pool_after), ...] for the convs up to relu{s}_{c}."""
    stage, last = int(conv_index[0]), int(conv_index[1])
    layers = []
    in_ch = 3
    for si, (ch, n_convs) in enumerate(VGG19_PLAN[:stage], start=1):
        n = last if si == stage else n_convs
        for ci in range(1, n + 1):
            layers.append((in_ch, ch, si < stage and ci == n_convs))
            in_ch = ch
    return layers


@functools.lru_cache(maxsize=8)
def _weights(conv_index: str, path: str, device: torch.device):
    """(mean, std, ((OIHW kernel, bias), ...)) as float32 tensors on
    `device`, made once (a copy per call would wait for the card): the
    HWIO kernels and biases of the .npz at `path`, or the seeded He bank
    where `path` is empty."""
    layers = layers_upto(conv_index)
    bank = []
    if path:
        data = np.load(path)
        for i, (cin, cout, _) in enumerate(layers):
            k = np.asarray(data[f"conv{i}"], np.float32)
            if k.shape != (3, 3, cin, cout):
                raise ValueError(f"{path}: conv{i} has shape {k.shape}, the VGG19 "
                                 f"plan needs {(3, 3, cin, cout)}")
            bank.append((k, data[f"bias{i}"] if f"bias{i}" in data else np.zeros(cout)))
    else:
        rng = np.random.default_rng(0)
        for cin, cout, _ in layers:
            std = float(np.sqrt(2.0 / (9 * cin)))
            bank.append((rng.standard_normal((3, 3, cin, cout)).astype(np.float32) * std,
                         np.zeros(cout)))
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    return (to(IMAGENET_MEAN).view(1, 3, 1, 1), to(IMAGENET_STD).view(1, 3, 1, 1),
            tuple((to(k.transpose(3, 2, 0, 1)), to(b)) for k, b in bank))


def vgg_features(x_nchw: torch.Tensor, conv_index: str = "22",
                 rgb_range: float = 255.0) -> torch.Tensor:
    """Features at relu{conv_index} of x [B, 3, H, W] in [0, rgb_range], as
    an NHWC float32 map (the JAX package's layout)."""
    mean, std, weights = _weights(conv_index, os.environ.get("SPEINET_VGG_WEIGHTS", ""),
                                  x_nchw.device)
    x = (x_nchw.float() / rgb_range - mean) / std
    for (k, b), (_, _, pool) in zip(weights, layers_upto(conv_index)):
        x = torch.relu(F.conv2d(x, k, b, padding=1))
        if pool:
            x = F.max_pool2d(x, 2, 2)
    return x.permute(0, 2, 3, 1)


def vgg_loss(out: torch.Tensor, gt: torch.Tensor, conv_index: str = "22",
             rgb_range: float = 255.0) -> torch.Tensor:
    """Mean squared difference in VGG feature space; the ground truth's
    features carry no gradient."""
    f_out = vgg_features(out, conv_index, rgb_range)
    with torch.no_grad():
        f_gt = vgg_features(gt, conv_index, rgb_range)
    return ((f_out - f_gt) ** 2).mean()
