"""The inference engine's scoring of a restored chunk on the CPU.

`ops/metrics.py::chunk_scores` scores a chunk on its device (each frame's
integer sum of squared errors and its SSIM) and `psnr_from_sse` turns the
sum into the PSNR on the host. Both are held with `==` to the float64
numpy PSNR and to `ssim_matlab` frame by frame, a 720p all-0 / all-255
pair included (the largest sum a frame can have). `Inference._score_chunk`
is held to the per-frame scoring it replaced (`_scored_per_frame` below):
the same PSNR, SSIM, log lines and PNG bytes, the frames read back only
when they are saved, and one `engine.score_wait` span a chunk.
"""

import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from speinet_tpu_torch.infer import Inference
from speinet_tpu_torch.ops.metrics import (chunk_scores, psnr_from_sse,
                                           psnr_uint8_host, ssim_matlab)
from speinet_tpu_torch.utils import spans
from speinet_tpu_torch.utils.image_io import imwrite


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.reset()
    yield
    spans.reset()
    torch.set_num_threads(n)


def _psnr_by_mean(img, gt, c=4):
    """The float64 mean of the squared differences, as numpy takes it."""
    a = img[c:-c, c:-c].astype(np.float64)
    b = gt[c:-c, c:-c].astype(np.float64)
    mse = np.mean((a - b) ** 2)
    return float("inf") if mse == 0 else float(20.0 * np.log10(255.0 / np.sqrt(mse)))


def _chunk(rng, h=20, w=28):
    """Frames and ground truths: random, near (noise of a few levels),
    identical, and all 0 against all 255."""
    img = rng.integers(0, 256, (4, h, w, 3), dtype=np.uint8)
    gt = rng.integers(0, 256, (4, h, w, 3), dtype=np.uint8)
    gt[1] = np.clip(img[1].astype(np.int64) + rng.integers(-3, 4, (h, w, 3)), 0, 255)
    gt[2] = img[2]
    img[3], gt[3] = 0, 255
    return img, gt


def test_chunk_scores_equal_the_host_psnr_and_ssim():
    img, gt = _chunk(np.random.default_rng(0))
    scores = chunk_scores(torch.from_numpy(img), torch.from_numpy(gt))
    assert scores.shape == (4, 2) and scores.dtype == torch.float64
    count = img[0, 4:-4, 4:-4].size
    for k in range(len(img)):
        sse, ssim = scores[k].tolist()
        d = img[k, 4:-4, 4:-4].astype(np.int64) - gt[k, 4:-4, 4:-4]
        assert sse == float((d * d).sum())
        psnr = psnr_from_sse(sse, count)
        assert psnr == psnr_uint8_host(img[k], gt[k]) == _psnr_by_mean(img[k], gt[k])
        assert ssim == float(ssim_matlab(torch.from_numpy(gt[k]), torch.from_numpy(img[k])))
    assert psnr_from_sse(scores[2, 0].item(), count) == float("inf")
    assert psnr_from_sse(scores[3, 0].item(), count) == 0.0


def test_psnr_from_sse_divides_as_numpys_mean():
    """Over frames at many noise levels: the PSNR from the integer sum
    equals the float64 mean's, which a product by 1 / count can miss in
    the last bit."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (400, 16, 20, 3), dtype=np.uint8)
    noise = rng.integers(-1, 2, img.shape) * rng.integers(0, 40, (400, 1, 1, 1))
    gt = np.clip(img + noise, 0, 255).astype(np.uint8)
    d = img[:, 4:-4, 4:-4].astype(np.int64) - gt[:, 4:-4, 4:-4]
    for k, sse in enumerate((d * d).sum(axis=(1, 2, 3)).tolist()):
        assert psnr_from_sse(sse, d[k].size) == _psnr_by_mean(img[k], gt[k])


def test_chunk_scores_720p_sum_does_not_overflow():
    """All 0 against all 255 at 720p: 712 x 1272 x 3 x 255**2 = 1.77e11,
    past int32, exact in int64 and float64."""
    img = torch.zeros((1, 720, 1280, 3), dtype=torch.uint8)
    gt = torch.full_like(img, 255)
    scores = chunk_scores(img, gt)
    assert scores[0, 0].item() == 712 * 1272 * 3 * 255 ** 2
    assert psnr_from_sse(scores[0, 0].item(), 712 * 1272 * 3) == \
        psnr_uint8_host(img[0].numpy(), gt[0].numpy()) == 0.0


def _engine(result_path, save_image):
    """An Inference with only what `_score_chunk` reads."""
    inf = Inference.__new__(Inference)
    inf.cfg = SimpleNamespace(rgb_range=1.0)
    inf.device = torch.device("cpu")
    inf.save_image = save_image
    inf.result_path = str(result_path)
    lines = []
    inf.logger = SimpleNamespace(lines=lines, write_log=lines.append)
    return inf


def _scored_per_frame(inf, v, names, out, gts):
    """The per-frame scoring `_score_chunk` replaced: the chunk read back,
    float64 host PSNR, one SSIM call and upload a frame."""
    imgs_dev = torch.clamp(torch.round(out * (255.0 / inf.cfg.rgb_range)),
                           0, 255).to(torch.uint8).permute(0, 2, 3, 1)
    imgs = imgs_dev.cpu().numpy()
    psnrs, ssims = [], []
    for k, filename in enumerate(names):
        psnrs.append(_psnr_by_mean(imgs[k], gts[k]))
        ssims.append(float(ssim_matlab(torch.from_numpy(np.ascontiguousarray(gts[k])),
                                       imgs_dev[k])))
        if inf.save_image:
            os.makedirs(os.path.join(inf.result_path, v), exist_ok=True)
            imwrite(os.path.join(inf.result_path, v, f"{filename}.png"), imgs[k])
        inf.logger.write_log(f"> {v}-{filename} PSNR={psnrs[-1]:.5}, SSIM={ssims[-1]:.4} "
                             "pre_time:")
    return psnrs, ssims


def _restored(rng, n=3, h=24, w=32):
    """A restored chunk [n, 3, H, W] a little outside [0, 1], and ground
    truths near it."""
    out = torch.from_numpy(rng.uniform(-0.05, 1.05, (n, 3, h, w)).astype(np.float32))
    near = out.permute(0, 2, 3, 1).numpy() * 255 + rng.normal(0, 4, (n, h, w, 3))
    gts = np.clip(np.round(near), 0, 255).astype(np.uint8)
    gts[1] = np.clip(np.round(out[1].permute(1, 2, 0).numpy() * 255), 0, 255)
    return out, list(gts)


@pytest.mark.parametrize("save_image", [False, True])
def test_score_chunk_matches_per_frame_scoring(tmp_path, monkeypatch, save_image):
    out, gts = _restored(np.random.default_rng(1))
    names = ["00000004", "00000005", "00000006"]
    want = _engine(tmp_path / "parent", save_image)
    want_psnr, want_ssim = _scored_per_frame(want, "v0", names, out, gts)

    inf = _engine(tmp_path / "change", save_image)
    reads = []
    cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a, **k: reads.append(t.shape)
                        or cpu(t, *a, **k))
    psnr, ssim = [], []
    inf._score_chunk("v0", names, out, [lambda g=g: g for g in gts], 0.0, 0.0, psnr, ssim)
    monkeypatch.undo()

    assert psnr == want_psnr and ssim == want_ssim
    assert want_psnr[1] == float("inf")
    # one line a frame, in order, in the reference's format
    assert [line[:line.index("pre_time:") + 9] for line in inf.logger.lines] == \
        want.logger.lines
    for line in inf.logger.lines:
        assert re.fullmatch(r"> v0-\d{8} PSNR=\S+, SSIM=\S+ pre_time:\S+s, "
                            r"forward_time:\S+s, post_time:\S+s, total_time:\S+s", line)
    # the frames are read back only to be saved, and then in one piece
    assert reads == ([(3, 24, 32, 3)] if save_image else [])
    saved = tmp_path / "change" / "v0"
    pngs = sorted(os.listdir(saved)) if saved.exists() else []
    assert pngs == ([f"{n}.png" for n in names] if save_image else [])
    for name in pngs:
        assert (saved / name).read_bytes() == \
            (tmp_path / "parent" / "v0" / name).read_bytes()


def test_score_chunk_waits_once_a_chunk(tmp_path):
    """Under a profiler each chunk's one readback is an `engine.score_wait`
    span over its frames."""
    rng = np.random.default_rng(2)
    inf = _engine(tmp_path, save_image=False)
    psnr, ssim = [], []
    with profile(activities=[ProfilerActivity.CPU]):
        for n in (3, 2):
            out, gts = _restored(rng, n=n)
            inf._score_chunk("v", [f"{i:08d}" for i in range(n)], out,
                             [lambda g=g: g for g in gts], 0.0, 0.0, psnr, ssim)
    waits = [(s.name, s.n) for s in spans.recorded() if s.name.startswith("engine.")]
    assert waits == [("engine.score_wait", 3), ("engine.score_wait", 2)]
    assert len(psnr) == len(ssim) == len(inf.logger.lines) == 5
