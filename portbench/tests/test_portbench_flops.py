"""FlopCounterMode's count over the reference against a count by hand."""

import json

import torch

from portbench.harness import flops
from portbench.harness.flops import FlopCounterMode, _meta_params
from portbench.reference.model import Net, Ops
from portbench.tests.tiny import tiny


def conv(cout, cin, k, h, w):
    return 2 * cout * cin * k * k * h * w


def resblock(c, h, w):
    return (2 * conv(c, c, 5, h, w) + 2 * 2 * c * (c // 4)
            + conv(1, 2, 7, h, c) + conv(1, 2, 5, c, w))


def test_encoder_count_by_hand():
    cfg = tiny()
    net, p = Net(cfg, Ops()), _meta_params(cfg)
    with FlopCounterMode(display=False) as fc:
        net.encode_pyramid(p, torch.empty((1, 3, 16, 16), device="meta"))
    hand = (conv(8, 3, 5, 16, 16) + resblock(8, 16, 16)
            + conv(16, 8, 5, 8, 8) + resblock(16, 8, 8)
            + conv(32, 16, 5, 4, 4) + resblock(32, 4, 4))
    assert fc.get_total_flops() == hand


def test_video_parts_are_positive_and_ordered():
    parts = flops._video_parts(json.dumps(tiny(), sort_keys=True), 32, 48)
    assert 0 < parts["anchor"] < parts["legs"]
    # legs = three encoder passes of a frame plus the RL passes' box filters
    assert parts["legs"] >= 3 * parts["anchor"]
    assert parts["sharp"] > 0 and parts["self"] > parts["sharp"] * 0.9


def test_train_step_counts_forward_and_backward():
    cfg = json.dumps(tiny(), sort_keys=True)
    f = flops.train_step_flops(cfg, 2, 32, 1)
    assert f > 0
    assert flops.train_step_flops(cfg, 4, 32, 2) > 1.9 * f
