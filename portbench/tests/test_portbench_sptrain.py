"""The SPEINet training cell's readers (`legs_ms.sptrain`,
`search_ms.sptrain`, `k5_roofline.sptrain`, `mfu.sptrain`): on planted
spans and a planted trace; None for a video cell, for a run that kept no
span and for a program without the span module (the parent of the spans
`model.legs` and `restore.search`); K5's count against the operations of
the correlation it stands for."""

import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import speinet_tpu_torch.utils
from speinet_tpu_torch.kernels.corr import correlation_argmax_lds_plain
from speinet_tpu_torch.utils import spans
from speinet_tpu_torch.utils.spans import Span

from portbench.harness.common import Manifest, bound_s, load_reader

NAMES = ["legs_ms.sptrain", "search_ms.sptrain", "k5_roofline.sptrain", "mfu.sptrain"]
K5 = "void corr_unfold_kernel<true>(bf16 const*, float*, int)"


def _span(name, device_ms, n=1):
    return Span(name, 0.0, 1e-3, True, n, device_ms)


# two profiled steps of a batch of 20
PLANTED = [_span("model.forward", 400.0), _span("model.legs", 60.0),
           _span("restore.search", 9.0, n=20),
           _span("model.forward", 420.0), _span("model.legs", 64.0),
           _span("restore.search", 11.0, n=20)]


def _ctx(kind="train", k5_s=0.002):
    return {"kind": kind, "traced_steps": 2, "step_flops": 3e13,
            "trace": {"window_s": 2.5, "device_by_name": {K5: k5_s, "gemm": 1.0}}}


def test_readers_read_the_planted_spans(monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: PLANTED)
    read = {n: load_reader(n).read for n in NAMES}
    assert read["legs_ms.sptrain"](_ctx()) == pytest.approx(62.0)
    assert read["search_ms.sptrain"](_ctx()) == pytest.approx(10.0)
    assert read["mfu.sptrain"](_ctx()) == pytest.approx(
        load_reader("mfu.train").read(_ctx())) == pytest.approx(100 * 6e13 / 2.5 / 989e12)
    cfg = Manifest().config("speinet_reds")
    l, d = (cfg["patch_size"] // 4) ** 2, 36 * cfg["n_feat"]
    least = max(2.0 * 40 * l * l * d / 989e12,
                40 * (2 * d * l * 2 + 12 * l) / 3.35e12)
    assert read["k5_roofline.sptrain"](_ctx()) == pytest.approx(100 * least / 0.002)
    assert read["k5_roofline.sptrain"](_ctx(k5_s=0.0)) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_without_its_spans_reads_nothing(name, monkeypatch, tmp_path):
    """A video cell; no span kept; a program that has no span module (its
    package searched in an empty directory): None, never an error. The
    whole-step share needs no span and reads on a train cell."""
    read = load_reader(name).read
    monkeypatch.setattr(spans, "recorded", lambda: PLANTED)
    assert read(_ctx("video")) is None
    monkeypatch.setattr(spans, "recorded", lambda: [])
    assert (read(_ctx()) is None) == (name != "mfu.sptrain")
    monkeypatch.setattr(spans, "recorded",
                        lambda: [s._replace(device_ms=None) for s in PLANTED])
    assert (read(_ctx()) is None) == (name in ("legs_ms.sptrain", "search_ms.sptrain"))
    monkeypatch.delattr(speinet_tpu_torch.utils, "spans")
    monkeypatch.delitem(sys.modules, "speinet_tpu_torch.utils.spans")
    monkeypatch.setattr(speinet_tpu_torch.utils, "__path__", [str(tmp_path)])
    assert (read(_ctx()) is None) == (name != "mfu.sptrain")


def test_k5_count_is_the_correlations_operations():
    """2 B L Lr D at a small shape: the count of the plain correlation's
    product, which K5 computes, by torch's own FLOP counter."""
    k5_work = load_reader("k5_roofline.sptrain").k5_work
    b, d, l, lr = 3, 72, 40, 24
    g = torch.Generator().manual_seed(0)
    q, ref = torch.randn(b, d, l, generator=g), torch.randn(b, d, lr, generator=g)
    inv = torch.rand(b, lr, generator=g) + 0.5
    with FlopCounterMode(display=False) as fc:
        correlation_argmax_lds_plain(q, ref, inv)
    assert k5_work(b, l, lr, d)[0] == 2 * b * l * lr * d == fc.get_total_flops()
    assert k5_work(b, l, lr, d)[1] == b * (2 * d * l + 2 * d * lr + 4 * lr + 8 * l)
    assert bound_s(*k5_work(b, l, lr, d)) > 0
