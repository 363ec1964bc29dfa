"""The frozen reference against the program's plain CPU path at a tiny
size: inference windows in every routing, and three training steps of
each model (losses, the first gradient, the parameters after Adam)."""

import pytest
import torch

from portbench.reference.model import Net, make_weights, param_spec, speinet_windows
from portbench.reference.train import train_steps
from portbench.tests.tiny import one_thread, port_model, tiny


@pytest.fixture(autouse=True)
def _threads():
    one_thread()


def test_param_spec_names_the_program_state():
    for model in ("SPEINet", "SWINT"):
        cfg = tiny(model)
        m = port_model(cfg, make_weights(cfg, 3, "cpu"))
        spec = {name: tuple(shape) for name, shape, _ in param_spec(cfg)}
        assert spec == {k: tuple(v.shape) for k, v in m.state_dict().items()}


def test_weights_follow_the_seed():
    cfg = tiny()
    a, b, c = (make_weights(cfg, s, "cpu") for s in (5, 5, 2 ** 31 + 9))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["swin.conv_first.weight"], c["swin.conv_first.weight"])


@pytest.mark.parametrize("h,w", [(32, 48), (40, 40)])
def test_inference_windows_match_program(h, w):
    cfg = tiny()
    p = make_weights(cfg, 123, "cpu")
    m = port_model(cfg, p).eval()
    g = torch.Generator().manual_seed(h * w)
    x = torch.rand((3, 5, 3, h, w), generator=g)
    x[1, 3] = 0                                    # no pre-sharp frame: 'self'
    out_p = m(x)
    with torch.no_grad():
        out_r = speinet_windows(p, Net(cfg), x[:, :3], x[:, 4], [True, False, True])
    assert (out_p - out_r).abs().max() <= 1e-5 * out_r.abs().max()


@pytest.mark.parametrize("model", ["SPEINet", "SWINT"])
def test_train_steps_match_program(model):
    _train_steps_match(tiny(model))


@pytest.mark.parametrize("model", ["SPEINet", "SWINT"])
def test_train_steps_match_program_six_blocks_a_layer(model):
    """Three block pairs a layer, as the templates have: each pair's
    DropPath masks are its own blocks'."""
    _train_steps_match(dict(tiny(model), depths=[6, 6]))


def _train_steps_match(cfg: dict):
    from speinet_tpu_torch.training.loss import LossComputer
    from speinet_tpu_torch.training.train_state import make_optimizer, train_step

    from portbench.harness.train import compare_steps
    from portbench.harness.video import port_config

    p = make_weights(cfg, 7, "cpu")
    m = port_model(cfg, p)
    pc = port_config(cfg)
    opt, lc = make_optimizer(pc, m), LossComputer(pc.loss, rgb_range=1.0)
    g = torch.Generator().manual_seed(11)
    gx = torch.Generator().manual_seed(1)
    batches = []
    for s in range(3):
        x = torch.rand((4, 5, 3, 40, 40), generator=gx)
        x[s, 3] = 0
        batches.append((x, torch.rand((4, 3, 40, 40), generator=gx)))
    losses = []
    names = {id(q): n for n, q in m.named_parameters()}
    fwd = m.forward
    outs = []
    m.forward = lambda *a, **k: outs.append(fwd(*a, **k)) or outs[-1]
    for t, (x, gt) in enumerate(batches):
        losses.append(float(train_step(m, opt, lc, x, gt, g)[0]))
        if t == 0:
            grad1 = {names[id(q)]: s["exp_avg"] / 0.1 for q, s in opt.state.items()}
    p_end = {n: q.detach() for n, q in m.named_parameters()}
    ref = train_steps(Net(cfg), p, batches, 11, lr=1e-4)
    gaps = compare_steps(losses, grad1, p_end, p, ref, outs[0].detach())
    assert gaps["loss_rel"] < 1e-5 and gaps["grad1_leaf"] < 1e-4 and gaps["out1_rel"] < 1e-5, gaps
    assert gaps["change_leaf"] < 1e-3, gaps
