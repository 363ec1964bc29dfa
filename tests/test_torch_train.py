"""The port's training path against speinet_tpu's, on the CPU.

Same weights on both sides (the seeded port init through the JAX
package's converter, BatchNorm statistics and gate affines perturbed, back
through `from_flax_params`), same numpy inputs. The JAX side runs with
`_fused_enabled` patched to True and every pallas_call in interpret mode, so
its train step reaches K5 and its custom VJP, as on the TPU. Tiny model
(n_feat 8, embed_dim 32, one depth-2 RSTB, 4 heads), 40x40, float32.
Each tensor of a train step is held to max|port - jax| <= 1e-4 max|jax| +
1e-6, on a batch whose TripletAttention max-pools hold no near ties (see
`_min_pool_gap`); the parameters after Adam have the exception stated in
`_assert_adam_close`. The main_train CLI is driven on a synthetic tree as
tests/test_end_to_end.py drives the JAX one.
"""

import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from speinet_tpu.config import Config as JConfig
from speinet_tpu.config import set_template as j_set_template
from speinet_tpu.models.speinet import SPEINet as JSPEINet
from speinet_tpu.training.train_state import TrainState
from speinet_tpu.training.train_state import make_optimizer as j_make_optimizer
from speinet_tpu.training.train_state import make_train_step as j_make_train_step
from speinet_tpu.training.train_state import \
    recalibrate_batch_stats as j_recalibrate
from speinet_tpu_torch.config import Config, set_template
from speinet_tpu_torch.models.speinet import SPEINet
from speinet_tpu_torch.training.loss import LossComputer
from speinet_tpu_torch.training.train_state import (make_optimizer,
                                                    recalibrate_batch_stats,
                                                    train_step)
from speinet_tpu_torch.utils.convert import from_flax_params
from test_end_to_end import TINY_ARGS, make_tree
from test_torch_dist import group2  # noqa: F401
from test_torch_dist import min_pool_gap as _min_pool_gap
from test_torch_kernels import interpret  # noqa: F401
from test_torch_models import TINY, _frames, shared  # noqa: F401

DEPTHS = TINY["depths"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the tests share the machine with other test
    workers, and torch's spinning thread pool slows ~10x when the cores
    are oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fused(monkeypatch, interpret):  # noqa: F811
    """The JAX package's TPU dispatch, Pallas in interpret mode."""
    import speinet_tpu.models.swinir as swinir_mod

    monkeypatch.setattr(swinir_mod, "_fused_enabled", lambda: True)


def _port_copy(port, **kw):
    """A fresh port model holding `port`'s weights and statistics."""
    m = SPEINet(**TINY, **kw)
    m.load_state_dict(port.state_dict(), strict=True)
    return m


def _batch(seed=40):
    """[2, 5, 3, 40, 40] windows (sample 1 routed to the self reference)
    and the centre ground truth [2, 3, 40, 40]."""
    x = np.stack([_frames(5, 40, 40, seed=seed + k) for k in range(2)])
    x[1, 3] = 0.0
    gt = np.clip(x[:, 1] * 1.05 - 0.02, 0.0, 1.0).astype(np.float32)
    return x, gt


def _as_port(params, batch_stats):
    return from_flax_params(jax.device_get(params), jax.device_get(batch_stats),
                            depths=DEPTHS)


def _assert_tensors_close(got: dict, want: dict, what: str):
    """Per tensor: max|got - want| <= 1e-4 max|want| + 1e-6."""
    assert want
    for name, w in want.items():
        g = got[name].detach().numpy()
        w = w.numpy()
        lim = 1e-4 * np.abs(w).max() + 1e-6
        err = np.abs(g - w).max()
        assert err <= lim, f"{what} {name}: {err} > {lim}"


# The TripletAttention gates max-pool every feature map over W and over H,
# and the pooled gradient goes to the winning element alone. Where the top
# two of a pooled line lie closer than the two sides' rounding, either may
# win, and the gradients of the whole encoder then differ by much more than
# rounding: on the batch of seed 40 (smallest top-2 gap 2.8e-7 of the map's
# scale) the JAX package's own two compilations of this gradient disagree
# that way. The step test takes a batch whose smallest gap is above
# POOL_MARGIN and asserts it (`_min_pool_gap`, test_torch_dist.py).
STEP_SEED = 30
POOL_MARGIN = 1e-6


def _assert_adam_close(got: dict, want: dict, before: dict, grads: dict,
                       lr: float):
    """Parameters after one Adam step. The first step moves each element by
    lr g / (|g| + 1e-8), about lr sign(g): where a gradient lies within its
    tolerance (1e-4 max|g| + 1e-6) of zero, the two sides' sums may round
    to opposite signs, and each side's step is only bounded by lr.
    Everywhere else the parameters are held to 1e-4 max|p| + 1e-6."""
    for name, w in want.items():
        g, w = got[name].detach().numpy(), w.numpy()
        err = np.abs(g - w)
        if name in grads:
            gj = np.abs(grads[name].numpy())
            band = gj <= 1e-4 * gj.max() + 1e-6
            assert np.abs(g - before[name].numpy())[band].max(initial=0) <= lr * 1.001
            assert np.abs(w - before[name].numpy())[band].max(initial=0) <= lr * 1.001
            err = err[~band]
        lim = 1e-4 * np.abs(w).max() + 1e-6
        assert err.max(initial=0) <= lim, f"after the step {name}: {err.max()} > {lim}"


def _jax_cfg(**kw):
    return j_set_template(JConfig(template="SPEINet")).replace(
        n_feat=8, embed_dim=32, depths=list(DEPTHS), num_heads=[4],
        drop_path_rate=0.0, **kw)


@pytest.fixture(scope="module")
def jax_step(shared):  # noqa: F811
    """The JAX package's train step on `_batch(STEP_SEED)`, loss 1*L1,
    drop_path_rate 0, compiled once for the tests that read it, with Pallas
    in interpret mode and `_fused_enabled` patched to True (as `fused`):
    (the step's gradient, read from Adam's first moment, the gradient of
    the step's loss_fn compiled apart, the state after the step, the loss).
    """
    from jax.experimental import pallas as pl
    import speinet_tpu.models.swinir as swinir_mod

    variables, _ = shared
    x, gt = _batch(seed=STEP_SEED)
    jcfg = _jax_cfg(loss="1*L1", lr=1e-4)
    jm = JSPEINet.from_config(jcfg)
    tx = j_make_optimizer(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    bstats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=bstats, opt_state=tx.init(params),
                       lr=jnp.asarray(jcfg.lr, jnp.float32))

    def loss_fn(p):     # the step's loss_fn (train_state.py:81-89), compiled apart
        # (before the step, which donates `state`)
        out, _ = jm.apply({"params": p, "batch_stats": bstats}, jnp.asarray(x),
                          train=True, mutable=["batch_stats"],
                          rngs={"droppath": jax.random.PRNGKey(0)})
        return jnp.mean(jnp.abs(out - jnp.asarray(gt)))

    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        k.pop("compiler_params", None)
        return orig(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", interp)
        mp.setattr(swinir_mod, "_fused_enabled", lambda: True)
        j_grads_apart = jax.jit(jax.grad(loss_fn))(params)
        new_state, j_total, _ = j_make_train_step(jcfg, jm, tx)(
            state, jnp.asarray(x), jnp.asarray(gt), jax.random.PRNGKey(0))
    # the gradient this step took, from Adam's first moment: mu = (1 - b1) g
    adam = next(s for s in new_state.opt_state if hasattr(s, "mu"))
    j_grads = jax.tree_util.tree_map(lambda m: m / (1.0 - jcfg.beta1), adam.mu)
    return j_grads, j_grads_apart, new_state, float(j_total)


def _jax_wants(variables, port, j_grads):
    """The JAX step's gradients as port tensors, for the parameters that
    take one."""
    want = _as_port(j_grads, variables["batch_stats"])
    params = dict(port.named_parameters())
    return {n: t for n, t in want.items() if n in params
            and not n.startswith("search23.")}


def _assert_step_matches_jax(variables, port, jax_step, total, grads, got, cfg):
    """A port step's loss, gradients and weights after Adam against the JAX
    step's, and every running statistic moved."""
    j_grads, _, new_state, j_total = jax_step
    want = _jax_wants(variables, port, j_grads)
    assert set(grads) == set(want)
    np.testing.assert_allclose(total, j_total, rtol=1e-5)
    _assert_tensors_close(grads, want, "gradient")
    after = _as_port(new_state.params, new_state.batch_stats)
    before = port.state_dict()
    _assert_adam_close(got, {
        n: t for n, t in after.items() if not n.endswith("num_batches_tracked")},
        before, want, cfg.lr)
    # every running statistic moved (new = 0.99 old + 0.01 batch)
    stats = [n for n in got if n.endswith(("running_mean", "running_var"))]
    assert stats and not any(torch.equal(got[n], before[n]) for n in stats)


def test_train_step_matches_jax(shared, jax_step):  # noqa: F811
    """One step, loss 1*L1, drop_path_rate 0: the loss, every parameter's
    gradient, the parameters after Adam and the BatchNorm running statistics
    against `make_train_step`. The batch keeps every max-pool's top two at
    least POOL_MARGIN apart, and the JAX package's own gradient, compiled
    apart from the step, must agree with the step's at the same limit."""
    variables, port = shared
    x, gt = _batch(seed=STEP_SEED)
    cfg = set_template(Config(template="SPEINet")).replace(loss="1*L1", lr=1e-4)
    model = _port_copy(port, drop_path_rate=0.0)
    out = {}

    def step():
        out["total"], out["comps"] = train_step(
            model, make_optimizer(cfg, model), LossComputer(cfg.loss),
            torch.from_numpy(x), torch.from_numpy(gt),
            torch.Generator().manual_seed(0))

    gap = _min_pool_gap(model, step)
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    want = _jax_wants(variables, port, jax_step[0])
    apart = _as_port(jax_step[1], variables["batch_stats"])
    rel = lambda a: max((a[n] - w).abs().max().item() / w.abs().max().item()
                        for n, w in want.items() if w.abs().max() > 0)
    print(f"smallest top-2 gap {gap:.3e}; largest per-tensor |g - g_jax| / "
          f"max|g_jax|: port {rel(grads):.3e}, JAX apart {rel(apart):.3e}")
    assert gap >= POOL_MARGIN, gap
    assert set(out["comps"]) == {"L1"}
    _assert_tensors_close(apart, want, "the reference's gradient compiled apart")
    _assert_step_matches_jax(variables, port, jax_step, out["total"].item(), grads,
                             model.state_dict(), cfg)


def test_dp_train_step_matches_jax(shared, jax_step, group2):  # noqa: F811
    """The same step on two ranks of a gloo group, one sample each: rank 0
    holds sample 0 (routed to the sharp search), rank 1 sample 1 (routed to
    the self reference). The gates' statistics and the gradient are
    all-reduced, so every rank's loss mean, gradients, Adam update and
    running statistics are the JAX step's on the whole batch, at
    `test_train_step_matches_jax`'s limits and with its pool-gap guard."""
    from test_torch_dist import step_on_rows

    variables, port = shared
    x, gt = _batch(seed=STEP_SEED)
    assert x[0, 3].any() and not x[1, 3].any()
    cfg = set_template(Config(template="SPEINet")).replace(loss="1*L1", lr=1e-4)
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    ranks = group2.run(step_on_rows, dict(TINY, drop_path_rate=0.0), state, x, gt,
                       cfg.loss, cfg.lr, 0)
    gap = min(r["gap"] for r in ranks)
    print(f"smallest top-2 gap over the ranks {gap:.3e}")
    assert gap >= POOL_MARGIN, gap
    total = np.mean([r["total"] for r in ranks])
    for r in ranks:
        _assert_step_matches_jax(
            variables, port, jax_step, total,
            {n: torch.from_numpy(g) for n, g in r["grads"].items()},
            {n: torch.from_numpy(v) for n, v in r["state"].items()}, cfg)


def test_recalibrate_batch_stats_matches_jax(shared, fused):  # noqa: F811
    """The running statistics become the average of two batches' statistics
    under the current weights, as `recalibrate_batch_stats` computes them
    (from one training-form apply per batch)."""
    variables, port = shared
    xs = [_batch(seed=s)[0] for s in (50, 60)]
    jm = JSPEINet(**TINY, drop_path_rate=0.0)
    want = j_recalibrate(jm, variables["params"], variables["batch_stats"],
                         [jnp.asarray(a) for a in xs], jax.random.PRNGKey(1))
    model = _port_copy(port, drop_path_rate=0.0)
    params_before = {n: p.detach().clone() for n, p in model.named_parameters()}
    recalibrate_batch_stats(model, [torch.from_numpy(a) for a in xs])
    got = model.state_dict()
    stats = {n: t for n, t in _as_port(variables["params"], want).items()
             if n.endswith(("running_mean", "running_var"))}
    _assert_tensors_close(got, stats, "recalibrated")
    for n, p in model.named_parameters():
        assert torch.equal(p, params_before[n]), n
    assert not any(torch.equal(got[n], port.state_dict()[n]) for n in stats)


def _video_tree(root):
    """Two videos of 20 random RGB frames. video00 is sharp only at frames
    0 and 15, so some windows lie more than 7 frames from their pre-sharp
    frame, which the dataset zeroes; video01 is sharp every 4 frames."""
    import imageio.v2 as imageio

    rng = np.random.default_rng(5)
    os.makedirs(root / "label")
    for v, sharp in enumerate(([0, 15], list(range(0, 20, 4)))):
        for kind in ("blur", "gt"):
            os.makedirs(root / kind / f"video{v:02d}")
        for i in range(20):
            for kind in ("blur", "gt"):
                imageio.imwrite(root / kind / f"video{v:02d}" / f"{i:08d}.png",
                                rng.integers(0, 256, (24, 28, 3), np.uint8))
        labels = np.zeros(20, np.int64)
        labels[sharp] = 1
        np.save(root / "label" / f"video{v:02d}.npy", labels)
    return root


@pytest.mark.parametrize("split", ["train", "test"])
def test_loader_matches_jax(tmp_path, split):
    """One epoch of the train or the test loader, built by each package's
    `Data` from the same tree and seed: the same crops, augmentations,
    zeroed pre-sharp frames, labels and names, batch for batch."""
    from speinet_tpu.data.loader import Data as JData
    from speinet_tpu_torch.data.loader import Data

    root = str(_video_tree(tmp_path / "ds"))
    kw = dict(dir_data=root, dir_data_test=root, patch_size=16, batch_size=3,
              n_frames_per_video=20, n_threads=2, seed=11)
    loaders = [getattr(d(set_template(c(template="SPEINet")).replace(**kw)),
                       f"loader_{split}")
               for d, c in ((JData, JConfig), (Data, Config))]
    want, got = (list(it) for it in loaders)
    assert len(want) == len(got) == len(loaders[1])
    assert len(got) == (24 if split == "train" else 34)
    for w, g in zip(want, got):
        assert len(w) == len(g) == 4
        for a, b in zip(w[:3], g[:3]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        assert w[3] == g[3]
    zeroed = [not b[0][i, 3].any() for b in got for i in range(len(b[0]))]
    assert any(zeroed) and not all(zeroed)


@pytest.mark.parametrize("process_index", [0, 1, 2])
def test_loader_process_stride_matches_jax(tmp_path, process_index):
    """One process's share of each global batch (batch 6 over 3 processes),
    as JAX's BatchIterator(process_index=r, process_count=3) loads it: the
    same samples, crops and names, batch for batch; the shares of the three
    processes are the global batch. Both refuse a batch that does not divide
    over the processes, and a loader that keeps a short last batch."""
    from speinet_tpu.config import Config as JConfig
    from speinet_tpu.data.loader import BatchIterator as JBatchIterator
    from speinet_tpu.data.loader import make_dataset as j_make_dataset
    from speinet_tpu_torch.data.loader import BatchIterator, make_dataset

    root = str(_video_tree(tmp_path / "ds"))
    kw = dict(dir_data=root, dir_data_test=root, patch_size=16, batch_size=6,
              n_frames_per_video=20, n_threads=2, seed=11)
    jds = j_make_dataset(j_set_template(JConfig(template="SPEINet")).replace(**kw),
                         "DVD_NFS", True)
    ds = make_dataset(set_template(Config(template="SPEINet")).replace(**kw),
                      "DVD_NFS", True)
    it = dict(batch_size=6, shuffle=True, seed=11, n_threads=2, drop_last=True)
    want = list(JBatchIterator(jds, process_index=process_index, process_count=3,
                               **it))
    got = list(BatchIterator(ds, process_index=process_index, process_count=3, **it))
    whole = list(BatchIterator(ds, **it))
    assert len(got) == len(want) == len(whole) == len(ds) // 6 > 1
    for w, g, a in zip(want, got, whole):
        assert g[0].shape[0] == 2
        for u, v in zip(w[:3], g[:3]):
            np.testing.assert_array_equal(u, v)
        assert w[3] == g[3] == a[3][process_index::3]
        np.testing.assert_array_equal(g[0], a[0][process_index::3])
    for cls, d in ((JBatchIterator, jds), (BatchIterator, ds)):
        with pytest.raises(ValueError, match="divide evenly"):
            cls(d, 4, True, 11, process_index=0, process_count=3, drop_last=True)
        with pytest.raises(ValueError, match="drop_last"):
            cls(d, 6, True, 11, process_index=0, process_count=3)


def test_main_train_one_epoch_and_resume(tmp_path):
    """The CLI on the CPU: one epoch writes the JAX trainer's files and log
    lines; a resume continues from the checkpoint and the metric log."""
    from speinet_tpu_torch.main_train import main

    root = make_tree(tmp_path / "ds")
    exp = tmp_path / "exp"
    argv = ["--device", "cpu", "--template", "SPEINet", "--dir_data", str(root),
            "--dir_data_test", str(root), "--experiment_dir", str(exp) + "/",
            "--save", "run1", "--epochs", "1"] + TINY_ARGS
    main(argv)

    d = exp / "run1"
    assert (d / "log.txt").exists() and (d / "config.txt").exists()
    assert (d / "model" / "model_latest").exists()
    assert (d / "model" / "model_best").exists()      # epoch 1 is best
    assert (d / "psnr.npy").exists() and (d / "psnr.pdf").exists()
    psnr = np.load(d / "psnr.npy")
    assert len(psnr) == 1 and np.isfinite(psnr[0])
    comp = np.load(d / "loss_components.npy")
    names = (d / "loss_components_names.txt").read_text().split()
    assert names == ["L1", "HEM", "Total"]
    assert comp.shape == (1, 3) and np.isfinite(comp).all()
    assert abs(comp[0, 0] + comp[0, 1] - comp[0, 2]) < 1e-4
    for n in names:
        assert (d / f"loss_loss_{n}.pdf").exists()
    log = (d / "log.txt").read_text()
    assert "Epoch   1 with Lr 1.00e-04" in log
    assert "average PSNR" in log
    assert "[4/20]\tLoss : [total:" in log
    assert glob.glob(str(d / "result" / "DVD_NFS" / "*" / "*_deblur_iter1.png"))
    ckpt = torch.load(d / "model" / "model_latest", weights_only=True)
    assert ckpt["epoch"] == 1 and ckpt["step"] == 10 and ckpt["optimizer"]["state"]

    argv2 = ["--device", "cpu", "--template", "SPEINet", "--dir_data", str(root),
             "--dir_data_test", str(root), "--experiment_dir", str(exp) + "/",
             "--save", "run1", "--load", "run1", "--resume", "true",
             "--epochs", "2"] + TINY_ARGS
    main(argv2)
    psnr2 = np.load(d / "psnr.npy")
    assert len(psnr2) == 2 and psnr2[0] == psnr[0]
    comp2 = np.load(d / "loss_components.npy")
    assert comp2.shape == (2, 3)
    np.testing.assert_allclose(comp2[0], comp[0])   # resume kept epoch-1 row
    log = (d / "log.txt").read_text()
    assert "Restored checkpoint at step 10" in log and "Epoch   2 with" in log
    assert torch.load(d / "model" / "model_latest", weights_only=True)["step"] == 20


def test_training_needs_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    """The CLI and the Trainer run on the card by default and raise without
    one; on a card they take bfloat16 only."""
    from speinet_tpu_torch.main_train import main
    from speinet_tpu_torch.training.trainer import Trainer
    from speinet_tpu_torch.utils.logging import Logger

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = make_tree(tmp_path / "ds", n_frames=6)
    argv = ["--template", "SPEINet", "--dir_data", str(root), "--dir_data_test",
            str(root), "--experiment_dir", str(tmp_path / "exp") + "/"] + TINY_ARGS
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)
    assert not os.path.exists(tmp_path / "exp")
    cfg = set_template(Config(template="SPEINet")).replace(
        experiment_dir=str(tmp_path / "exp") + "/", save="t")
    logger = Logger(cfg)
    model = SPEINet(**TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, None, model, logger)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="bfloat16"):
        Trainer(cfg, None, model, logger)
    logger.done()
