"""The check must come out false for its control and for each fault a cell
can have. The control (the reference with float8 operands in the
program's place) and the faults planted in the reference are read on the
card at each cell's own size (`control.py`'s readings, marked cuda: the
limits were set from them); the faults planted in the program are driven
under a whole run of the harness on the CPU at a tiny size (the check for
a card skipped), against each cell's own limits."""

import json

import pytest
import torch

from portbench.harness import controls, train, video
from portbench.harness.common import HERE, Checks, Manifest
from portbench.tests.tiny import one_thread, tiny


@pytest.fixture(autouse=True)
def _threads():
    one_thread()


def _traffic(name: str, **params) -> dict:
    t = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    t["params"].update(params)
    return t


VIDEO = dict(height=48, width=64, frames_per_video=12, pool_frames=6)
TRAIN = dict(height=64, width=80, videos=8, frames_per_video=16, pool_frames=6,
             loader_threads=2)


def _correct(limits: dict, readings: dict) -> bool:
    """The check's verdict on readings; a number a source does not read
    (an unchanged state reads only its change) reads 0, as it would
    where the program agreed with the reference exactly."""
    checks = Checks(limits)
    for k in limits:
        checks.add(k, readings.get(k, 0.0))
    return checks.correct()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the control is read at the cell's own size, on the card "
                    "(python3 -m pytest portbench/tests -m cuda)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in Manifest().data["workloads"]])
def test_control_and_faults_fail_at_the_cells_size(card, cell):
    """The control and each planted fault, on three seeds, at the cell's
    own size, fail one of the numbers its check compares."""
    m = Manifest()
    w = m.cell(cell)
    cfg, traffic, limits = m.config(w["config"]), m.traffic(w["traffic"]), m.limits(cell)
    for seed in (5, 6, 7):
        if traffic["generator"] == "video":
            r = controls.video_readings(cfg, traffic, seed, card)
            for source in ("control", "answer_altered", "quadrant_altered"):
                assert not _correct(limits, {k: r[k][source] for k in limits}), \
                    (seed, source, r)
        else:
            r = controls.train_readings(cfg, traffic, seed, card)
            for source in ("control", "half_batch", "half_loss", "state_unchanged"):
                assert not _correct(limits, r[source]), (seed, source, r)


def _video_run(cell, monkeypatch=None):
    checks = Checks(Manifest().limits(cell))
    video.run(tiny(), _traffic("vid720-r05", **VIDEO), 2 ** 31 + 11, 3.0, False,
              torch.device("cpu"), 0.0, checks)
    return checks


def _train_run(cell, model):
    checks = Checks(Manifest().limits(cell))
    train.run(tiny(model), _traffic("train-b20", **TRAIN), 2 ** 31 + 11, 2.0, False,
              torch.device("cpu"), 0.0, checks)
    return checks


def test_video_run_is_correct_and_catches_an_altered_answer(monkeypatch):
    assert _video_run("speinet-vid720-r05").correct()
    from speinet_tpu_torch.models.speinet import SPEINet

    restore = SPEINet.restore_from_features

    def altered(self, *a, **k):
        out = restore(self, *a, **k)
        out[0] = out[0].flip(-1)            # one restored frame changed
        return out

    def quadrant(self, *a, **k):
        out = restore(self, *a, **k)
        h, w = out.shape[-2] // 2, out.shape[-1] // 2
        out[0, :, :h, :w] = out[0, :, :h, :w].flip(-1)   # a quarter of one frame
        return out

    for fault in (altered, quadrant):
        with monkeypatch.context() as m:
            m.setattr(SPEINet, "restore_from_features", fault)
            checks = _video_run("speinet-vid720-r05")
            assert not checks.correct(), (fault.__name__, checks.table())


TRAIN_CELLS = [(w["name"], Manifest().config(w["config"])["model"])
               for w in Manifest().data["workloads"] if w["traffic"] == "train-b20"]


@pytest.mark.parametrize("cell,model", TRAIN_CELLS)
def test_train_run_catches_faults(cell, model, monkeypatch):
    assert _train_run(cell, model).correct()
    import speinet_tpu_torch.training.trainer as trainer_mod

    step = trainer_mod.train_step

    def half_batch(model_, opt, loss, inp, gt, *a, **k):
        n = inp.shape[0] // 2
        return step(model_, opt, loss, inp[:n], gt[:n], *a, **k)

    with monkeypatch.context() as m:
        m.setattr(trainer_mod, "train_step", half_batch)
        assert not _train_run(cell, model).correct()
    from speinet_tpu_torch.training.loss import LossComputer

    loss = LossComputer.__call__

    def half_loss(self, out, gt, *a, **k):  # the whole batch forwarded, half in the loss
        n = out.shape[0] // 2
        return loss(self, out[:n], gt[:n], *a, **k)

    with monkeypatch.context() as m:
        m.setattr(LossComputer, "__call__", half_loss)
        checks = _train_run(cell, model)
        assert not checks.correct(), checks.table()
        assert checks.values["out1_rel"] <= checks.limits["out1_rel"]
    with monkeypatch.context() as m:
        m.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
        assert not _train_run(cell, model).correct()
