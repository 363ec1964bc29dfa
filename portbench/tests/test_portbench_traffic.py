"""The traffic generators: deterministic by seed, GoProRS's labels with a
fixed count, windows as the program's engine forms them."""

import numpy as np
import pytest
import torch

from portbench.harness.synth import frame_pool, sharp_labels
from portbench.harness.video import Videos
from portbench.reference.windows import windows


def test_frame_pool_follows_the_seed():
    a = frame_pool(3, 16, 24, 2 ** 31 + 3, "cpu")
    b = frame_pool(3, 16, 24, 2 ** 31 + 3, "cpu")
    c = frame_pool(3, 16, 24, 4, "cpu")
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert x.dtype == np.uint8 and x.shape == (16, 24, 3) and np.array_equal(x, y)
    assert not np.array_equal(a[0][0], c[0][0])
    # the blurred frame is the mean of seven horizontal shifts
    sh = torch.from_numpy(a[0][1]).float()
    mean = torch.stack([torch.roll(sh, s, dims=1) for s in range(-3, 4)]).mean(0)
    assert np.array_equal(mean.to(torch.uint8).numpy(), a[1][1])


@pytest.mark.parametrize("ratio,n", [(0.5, 100), (0.1, 100), (0.3, 17)])
def test_labels_fixed_count_last_sharp(ratio, n):
    rng = np.random.default_rng(1)
    labels = [sharp_labels(n, ratio, rng) for _ in range(5)]
    for lab in labels:
        assert lab[-1] == 1 and lab.sum() == max(round(ratio * n), 1)
    assert len({lab.tobytes() for lab in labels}) > 1


def test_videos_follow_the_seed_and_share_the_patterns():
    pool = [np.full((4, 4, 3), i, np.uint8) for i in range(7)]
    tp = {"label_seed": 3, "label_patterns": 2, "frames_per_video": 20, "sharp_ratio": 0.5}
    pats = Videos.patterns_of(tp)
    assert len(pats) == 2 and all(p.sum() == 10 for p in pats)
    assert all(np.array_equal(p, q) for p, q in zip(pats, Videos.patterns_of(tp)))
    a, b, c = (Videos(pool, pool, 20, pats, s) for s in (99, 99, 2 ** 31 + 1))
    for k in range(4):
        assert a.get(k)[0] == b.get(k)[0]
        assert np.array_equal(a.get(k)[1], pats[k % 2]) and np.array_equal(c.get(k)[1], pats[k % 2])
    assert [a.get(k)[0] for k in range(4)] != [c.get(k)[0] for k in range(4)]
    off = a.get(2)[0]
    assert a.load("blur00002/00000005")[0, 0, 0] == (off + 5) % 7


def test_windows_match_the_program_engine():
    from speinet_tpu_torch.data.indices import gene_seq, gene_seq_nsf
    from speinet_tpu_torch.infer import window_metas

    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(3, 40))
        lab = (rng.random(n) < rng.random()).astype(int)
        keys = [f"blur00001/{i:08d}" for i in range(n)]
        pre, sub = gene_seq_nsf(lab, 3)
        _, padded = gene_seq(keys, 3)
        prog = window_metas(padded, pre, sub, 3)
        ours = windows(keys, lab, 3)
        assert [(m[0], m[1], m[2], m[3]) for m in prog] == \
            [(f[1], (f[0], f[2]), hs, a) for f, hs, a in ours]


def test_warmup_covers_every_routing():
    import json

    from portbench.harness.common import HERE

    for path in sorted((HERE / "traffic").glob("*.json")):
        t = json.loads(path.read_text())
        if t["generator"] != "video":
            continue
        tp = t["params"]
        lab = tp["warmup_labels"]
        ws = windows([f"blur00000/{i:08d}" for i in range(len(lab))], lab, 3)
        bw = tp["batch_windows"]
        routes = {"sharp" if all(w[1] for w in ws[s:s + bw]) else
                  "self" if not any(w[1] for w in ws[s:s + bw]) else "mixed"
                  for s in range(0, len(ws), bw)}
        assert routes == {"sharp", "self", "mixed"}
