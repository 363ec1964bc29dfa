"""The readers of the program's spans (`harness/program_spans.py` and the
eleven metrics that use it): None for the other kind of cell, for a run that
kept no span and for a program without the span module; on a planted list
of spans, each normalised by its own spans' `n`."""

import sys

import pytest

import speinet_tpu_torch.utils
from speinet_tpu_torch.utils import spans
from speinet_tpu_torch.utils.spans import Span

from portbench.harness.common import load_reader

VIDEO = ["score_ms.video", "feed_ms.video", "fusion_ms.video", "transfer_ms.video",
         "decode_ms.video"]
TRAIN = ["batch_wait_ms.train", "forward_ms.train", "backward_ms.train",
         "optimizer_ms.train", "batch_build_ms.train", "loss_ms.train"]


def _span(name, ms, n=1, main=True, device_ms=None, at=0.0):
    return Span(name, at, at + ms * 1e-3, main, n, device_ms)


# two chunks of two windows
PLANTED_VIDEO = [
    _span("engine.feed_wait", 4.0, n=3), _span("engine.upload", 1.0, n=3),
    _span("engine.restore", 120.0, n=2), _span("engine.restore", 130.0, n=2),
    _span("restore.fusion", 60.0, n=2, device_ms=62.0),
    _span("restore.fusion", 60.0, n=2, device_ms=58.0),
    _span("restore.transfer", 20.0, n=4, device_ms=24.0),
    _span("restore.decode", 40.0, n=4, device_ms=44.0),
    _span("engine.upload", 3.0), _span("engine.score", 70.0, n=2),
    _span("engine.score", 90.0, n=2),
]
WANT_VIDEO = {"score_ms.video": 40.0, "feed_ms.video": 2.0, "fusion_ms.video": 30.0,
              "transfer_ms.video": 6.0, "decode_ms.video": 11.0}
# one step; the batch built in the producer thread
PLANTED_TRAIN = [
    _span("loader.wait", 12.0), _span("model.forward", 150.0, device_ms=200.0),
    _span("train.loss", 1.0, device_ms=5.0),
    _span("train.backward", 3.0, device_ms=300.0),
    _span("train.optimizer", 90.0, device_ms=100.0),
    _span("loader.batch", 130.0, main=False),
]
WANT_TRAIN = {"batch_wait_ms.train": 12.0, "forward_ms.train": 200.0,
              "backward_ms.train": 300.0, "optimizer_ms.train": 100.0,
              "batch_build_ms.train": 130.0, "loss_ms.train": 5.0}


@pytest.mark.parametrize("name", VIDEO + TRAIN)
def test_reader_reads_the_planted_spans(name, monkeypatch):
    kind = "video" if name in VIDEO else "train"
    planted = PLANTED_VIDEO + PLANTED_TRAIN
    monkeypatch.setattr(spans, "recorded", lambda: planted)
    read = load_reader(name).read
    want = (WANT_VIDEO if kind == "video" else WANT_TRAIN)[name]
    assert read({"kind": kind}) == pytest.approx(want)
    assert read({"kind": "train" if kind == "video" else "video"}) is None


@pytest.mark.parametrize("name", VIDEO + TRAIN)
def test_reader_without_spans_reads_nothing(name, monkeypatch, tmp_path):
    """No span kept; device spans without their events (a run on the CPU);
    a program that has no span module (its package searched in an empty
    directory)."""
    kind = "video" if name in VIDEO else "train"
    read = load_reader(name).read
    monkeypatch.setattr(spans, "recorded", lambda: [])
    assert read({"kind": kind}) is None
    no_events = [s._replace(device_ms=None) for s in PLANTED_VIDEO + PLANTED_TRAIN]
    monkeypatch.setattr(spans, "recorded", lambda: no_events)
    device = {"fusion_ms.video", "transfer_ms.video", "decode_ms.video",
              "forward_ms.train", "backward_ms.train", "optimizer_ms.train",
              "loss_ms.train"}
    assert (read({"kind": kind}) is None) == (name in device)
    monkeypatch.delattr(speinet_tpu_torch.utils, "spans")
    monkeypatch.delitem(sys.modules, "speinet_tpu_torch.utils.spans")
    monkeypatch.setattr(speinet_tpu_torch.utils, "__path__", [str(tmp_path)])
    assert read({"kind": kind}) is None
