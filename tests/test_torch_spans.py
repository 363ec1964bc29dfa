"""The port's spans (`speinet_tpu_torch/utils/spans.py`) on the CPU.

Spans are kept only while a torch.profiler session records, and only
those that began and ended inside it; `as_host_spans()` is the shape the
benchmark's trace reduction takes, and its clock is the one that
reduction ties to the device trace. The cached engine records every
`engine.*` and `restore.*` span, and a SWINT epoch of `Trainer.train()`
the loader's and the train step's.
"""

import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.harness.trace import summarize
from speinet_tpu_torch.utils.spans import as_host_spans, recorded, reset, span

SMALL = dict(n_feat=8, embed_dim=32, depths=[2], num_heads=[4], n_threads=2)


@pytest.fixture(autouse=True)
def _fresh_and_one_thread():
    """No spans from an earlier test; one intra-op thread (the tests share
    the machine with other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    reset()
    yield
    reset()
    torch.set_num_threads(n)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_switch_off_keeps_nothing():
    assert span("a") is span("b", n=3, device=True)      # the shared null context
    with span("a"):
        pass
    assert recorded() == [] and as_host_spans() == []


def test_spans_straddling_the_profilers_start_or_stop_are_dropped():
    prof = _cpu_profile()
    with span("straddles.start"):
        prof.start()
        with span("inside", n=3, device=True):
            time.sleep(0.002)
    with span("straddles.stop"):
        prof.stop()
    with span("after"):
        pass
    (s,) = recorded()
    assert (s.name, s.n, s.main_thread, s.device_ms) == ("inside", 3, True, None)
    assert s.end - s.start >= 0.002
    # the span is a range of the session's own trace too
    assert "inside" in {e.name for e in prof.events()}
    (h,) = as_host_spans()
    assert h == (s.name, s.start, s.end, True) and isinstance(h[1], float)
    reset()
    assert recorded() == []


def test_spans_of_many_threads_are_all_kept():
    """Threads racing to keep spans lose none; each is marked off the main
    thread."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(200):
                with span("t"):
                    pass

        with _cpu_profile():
            threads = [threading.Thread(target=work) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    kept = recorded()
    assert len(kept) == 8 * 200 and not any(s.main_thread for s in kept)


def test_idle_gaps_are_labelled_by_the_programs_spans():
    """The program's host spans fed to the benchmark's trace reduction,
    beside synthetic kernels on a device clock offset from the host's and
    the two marker kernels: each idle gap takes the name of the program's
    span it falls in."""
    with _cpu_profile():
        h0 = time.perf_counter()
        with span("engine.restore"):
            time.sleep(0.01)
        with span("engine.score"):
            time.sleep(0.01)
        h1 = time.perf_counter()
    host = as_host_spans()
    assert [h[0] for h in host] == ["engine.restore", "engine.score"]
    (_, r0, r1, _), (_, s0, s1, _) = host
    off = 7e6                                           # device clock - host clock, us
    us = lambda t: t * 1e6 + off
    k = lambda name, a, b: {"ph": "X", "cat": "kernel", "name": name, "ts": us(a),
                            "dur": (b - a) * 1e6}
    ev = [k("at::cuda::spin_kernel(long)", h0, h0 + 1e-6),
          k("at::cuda::spin_kernel(long)", h1, h1 + 20e-6),
          k("conv_kernel", r0, (r0 + r1) / 2),            # the restore's first half busy
          k("reduce_kernel", s0, s0 + 0.1 * (s1 - s0))]   # the score's first tenth
    s = summarize(ev, h0, h1, host)
    idle = s["idle_by_host"]
    assert idle["engine.restore"] == pytest.approx((r1 - r0) / 2 + (s0 - r1), rel=1e-6)
    assert idle["engine.score"] == pytest.approx(0.9 * (s1 - s0) + (h1 - s1) + 20e-6,
                                                 rel=1e-6)


def _frames(n, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return [np.stack([127 + 90 * np.sin(xx / 5.0 + i) * np.cos(yy / 4.0)
                      + 8 * rng.standard_normal((h, w))] * 3, -1)
            .clip(0, 255).astype(np.uint8) for i in range(n)]


@pytest.mark.parametrize("cached", [True, False], ids=["cached", "direct"])
def test_engine_records_its_spans(tmp_path, cached):
    """One 6-frame video at 2 windows a chunk, sharp frames at both ends
    (anchors decoded), profiled whole."""
    from concurrent.futures import ThreadPoolExecutor

    from speinet_tpu_torch.config import Config, set_template
    from speinet_tpu_torch.infer import Inference

    frames = _frames(6)
    store = {f"blur/{i:08d}": f for i, f in enumerate(frames)}
    store.update({f"gt/{i:08d}": f for i, f in enumerate(frames)})
    cfg = set_template(Config(template="SPEINet")).replace(**SMALL)
    inf = Inference(cfg, str(tmp_path), "", str(tmp_path / "res"), save_image=False,
                    batch_windows=2, cache_pyramids=cached, device="cpu")
    labels = np.array([1, 0, 0, 0, 0, 1])
    try:
        with ThreadPoolExecutor(max_workers=2) as pool, _cpu_profile():
            psnr, _ = inf.infer_video("v", sorted(k for k in store if k[0] == "b"),
                                      sorted(k for k in store if k[0] == "g"),
                                      labels, store.__getitem__, pool)
    finally:
        inf.close()
    kept = recorded()
    n_of = lambda name: sum(s.n for s in kept if s.name == name)
    names = {s.name for s in kept}
    engine = {"engine.feed_wait", "engine.upload", "engine.score", "engine.score_wait"}
    restore = {"restore.fusion", "restore.transfer", "restore.search", "restore.decode"}
    assert n_of("engine.score") == n_of("engine.score_wait") == len(psnr) == 6
    assert sum(s.name == "engine.score_wait" for s in kept) == 3   # one wait a chunk
    for name in restore:
        assert n_of(name) == 6, name                    # windows restored
    assert all(s.main_thread and s.device_ms is None for s in kept)
    if cached:
        assert names == engine | restore | {"engine.legs", "engine.anchor",
                                            "engine.restore"}
        assert n_of("engine.restore") == 6 and n_of("engine.legs") == 6
        assert set(inf.stage_seconds) == {"legs", "anchor", "restore"}
        assert all(v > 0 for v in inf.stage_seconds.values())
    else:
        assert names == engine | restore | {"model.forward", "model.legs"}
        assert n_of("model.forward") == n_of("model.legs") == 3   # one call a chunk
        assert not any(inf.stage_seconds.values())


def test_trainer_epoch_records_the_step_and_loader_spans(tmp_path):
    """Two steps of a tiny SWINT's `Trainer.train()`: the train step's
    spans once a step, the loader's once a batch and once more for the
    epoch's end (the producer's last next(), the consumer's wait for it)."""
    from speinet_tpu_torch.config import Config, set_template
    from speinet_tpu_torch.models.swint import SWINT
    from speinet_tpu_torch.training.trainer import Trainer
    from speinet_tpu_torch.utils.logging import Logger

    cfg = set_template(Config(template="SWINT")).replace(
        **SMALL, batch_size=2, patch_size=40, print_every=100,
        experiment_dir=str(tmp_path) + "/", save="s")
    rng = np.random.default_rng(0)

    class Batches:
        def __len__(self):
            return 2

        def __iter__(self):
            for _ in range(2):
                x = rng.random((2, 5, 3, 40, 40), dtype=np.float32)
                yield x, x[:, :3].copy(), np.zeros((2, 5), np.int64), [["a"] * 5] * 2

    trainer = Trainer(cfg, SimpleNamespace(loader_train=Batches(), loader_test=None),
                      SWINT.from_config(cfg), Logger(cfg), device="cpu")
    with _cpu_profile():
        trainer.train()
    counts = {}
    for s in recorded():
        counts[s.name] = counts.get(s.name, 0) + s.n
    assert counts == {"model.forward": 2, "train.loss": 2, "train.backward": 2,
                      "train.optimizer": 2, "loader.batch": 3, "loader.wait": 3}
    assert {s.name for s in recorded() if not s.main_thread} == {"loader.batch"}



@pytest.mark.parametrize("name,n", [("model.legs", 1), ("restore.search", 3)])
def test_speinet_training_forward_records_its_spans(name, n):
    """A tiny SPEINet's training forward over a 'mixed' batch of three
    samples, one of them self-routed (its sharp frame all zero): the legs'
    span once, n 1; the search's once, n 3, since 'mixed' searches every
    sample, each against its own routing's reference. Nothing is kept
    without a profiler."""
    from speinet_tpu_torch.models.speinet import SPEINet, init_weights

    model = init_weights(SPEINet(n_feat=8, embed_dim=32, depths=(2,), num_heads=(4,)),
                         seed=0)
    x = torch.rand(3, 5, 3, 40, 40, generator=torch.Generator().manual_seed(0))
    x[2, 3] = 0
    model(x, train=True)
    assert recorded() == []
    with _cpu_profile():
        model(x, train=True)
    kept = [s for s in recorded() if s.name == name]
    assert [(s.n, s.main_thread) for s in kept] == [(n, True)]
