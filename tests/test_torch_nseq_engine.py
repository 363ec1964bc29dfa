"""The port's engines at n_sequence 5 against speinet_tpu, on the CPU.

Same weights on both sides (`test_torch_nseq._weights`); a 12-frame 32x40
tree with sharp labels at frames 0 and 11, 2 windows per chunk. Per-frame
PSNR within 0.01 dB (SSIM within 1e-4 where the JAX engine reports it).
The direct engine is held to the JAX package's direct engine. The JAX
package's cached engine cannot run at n_sequence 5 (it passes two
neighbour streams to a fusion conv built for four), so the port's cached
engine is held to the JAX model's cached methods, window by window, under
the JAX cached engine's routing and anchor rules.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from speinet_tpu.config import Config as JConfig
from speinet_tpu.config import set_template as j_set_template
from speinet_tpu.data.indices import frame_number, gene_seq, gene_seq_nsf
from speinet_tpu.infer import Inference as JInference
from speinet_tpu.models.speinet import SPEINet as JSPEINet
from speinet_tpu.ops.metrics import psnr_uint8_host
from speinet_tpu_torch.config import Config, set_template
from speinet_tpu_torch.infer import Inference
from test_torch_engine import _tree
from test_torch_nseq import _one_torch_thread, _weights  # noqa: F401

N_FRAMES = 12
SMALL = dict(n_feat=8, embed_dim=32, depths=[2], num_heads=[4], n_threads=2,
             n_sequence=5)


@pytest.fixture(scope="module")
def nseq5_tree(tmp_path_factory):
    """A 12-frame 32x40 tree labelled sharp at frames 0 and 11, the weights
    of both sides, and the port's .pt."""
    labels = np.zeros(N_FRAMES, np.int64)
    labels[[0, N_FRAMES - 1]] = 1
    root = _tree(tmp_path_factory.mktemp("nseq5") / "ds", N_FRAMES, labels, h=32, w=40)
    variables, jm, port = _weights(5, seed=5)
    pt = root.parent / "port.pt"
    torch.save(port.state_dict(), pt)
    return root, variables, jm, pt


def _port_engine(root, pt, cache):
    cfg = set_template(Config(template="SPEINet")).replace(**SMALL)
    inf = Inference(cfg, str(root), model_path=str(pt),
                    result_path=str(root.parent / f"res_{cache}"), save_image=False,
                    batch_windows=2, cache_pyramids=cache, device="cpu")
    inf.infer()
    inf.close()
    return inf.total_psnr["video00"], inf.total_ssim["video00"]


def test_direct_engine_nseq5_matches_jax_engine(nseq5_tree, monkeypatch):
    """The JAX direct engine at n_sequence 5 routes every window to the sharp
    search (its flag, frame 3, is a blurry neighbour), and its zero rule
    compares entries 2-4 of the stack, three window frames: the port
    follows both."""
    root, variables, _, pt = nseq5_tree
    monkeypatch.setattr(JInference, "_load_weights", lambda self, path: (
        variables["params"], variables["batch_stats"]))
    cfg_j = j_set_template(JConfig(template="SPEINet")).replace(dp_devices=1, **SMALL)
    inf_j = JInference(cfg_j, str(root), model_path="",
                       result_path=str(root.parent / "res_jax"), save_image=False,
                       batch_windows=2)
    inf_j.infer()
    psnr, ssim = _port_engine(root, pt, cache=False)
    assert len(psnr) == N_FRAMES
    np.testing.assert_allclose(psnr, inf_j.total_psnr["video00"], rtol=0, atol=0.01)
    np.testing.assert_allclose(ssim, inf_j.total_ssim["video00"], rtol=0, atol=1e-4)


def _jax_cached_reference(root, variables, jm):
    """Per-frame PSNR of the JAX model's cached methods under the JAX cached
    engine's window rules (speinet_tpu/infer.py:270-285): each window's
    centre leg, its four neighbours' legs, the sub-sharp anchor (zeros when
    more than 7 frames from the window's last frame), routed 'sharp' when
    its pre-sharp frame is within 7 of that frame, else 'self'."""
    import imageio.v2 as imageio

    blur = sorted(str(p) for p in (root / "blur" / "video00").iterdir())
    gts = sorted(str(p) for p in (root / "gt" / "video00").iterdir())
    labels = np.load(root / "label" / "video00.npy")
    pre, sub = gene_seq_nsf(labels, n_seq=5, border=True)
    seqs, padded = gene_seq(blur, n_seq=5, border=True)
    gt_seqs, _ = gene_seq(gts, n_seq=5, border=True)
    num = lambda p: frame_number(os.path.basename(os.path.dirname(p)) + "."
                                 + os.path.splitext(os.path.basename(p))[0])
    load = lambda p: imageio.imread(p).transpose(2, 0, 1).astype(np.float32) / 255.0
    frames = {p: load(p) for p in dict.fromkeys(padded)}
    keys = list(frames)
    legs = jax.jit(lambda v, f: jm.apply(v, f, method=JSPEINet.encode_window_legs))(
        variables, jnp.asarray(np.stack([frames[p] for p in keys])))
    m, n = ({p: np.asarray(a[k:k + 1]) for k, p in enumerate(keys)} for a in legs)
    anchor = jax.jit(lambda v, f: jm.apply(v, f, method=JSPEINet.anchor_pyramid))
    restore = {r: jax.jit(lambda v, *a, r=r: jm.apply(
        v, *a, routing=r, method=JSPEINet.restore_from_features))
        for r in ("sharp", "self")}
    psnr = []
    for w in range(len(seqs)):
        last = num(padded[w + 4])
        hs = abs(last - num(padded[pre[w][0]])) <= 7
        sub_path = padded[sub[w][4]]
        a = frames[sub_path] if abs(last - num(sub_path)) <= 7 else np.zeros_like(
            frames[sub_path])
        out = restore["sharp" if hs else "self"](
            variables, jnp.asarray(m[padded[w + 2]]),
            tuple(jnp.asarray(n[padded[w + i]]) for i in (0, 1, 3, 4)),
            *anchor(variables, jnp.asarray(a[None])), jnp.asarray([hs]))
        img = np.clip(np.round(np.asarray(out)[0] * 255.0), 0, 255).astype(
            np.uint8).transpose(1, 2, 0)
        psnr.append(psnr_uint8_host(img, imageio.imread(gt_seqs[w][2]), crop_border=4))
    return psnr


def test_cached_engine_nseq5_matches_jax_methods(nseq5_tree):
    root, variables, jm, pt = nseq5_tree
    want = _jax_cached_reference(root, variables, jm)
    psnr, _ = _port_engine(root, pt, cache=True)
    assert len(psnr) == N_FRAMES
    np.testing.assert_allclose(psnr, want, rtol=0, atol=0.01)
