"""The port's SWINT, model registry and main_swint against speinet_tpu's, on
the CPU.

Same weights on both sides: a seeded port init carried to the flax tree by
the JAX package's `convert_state_dict` (which leaves SWINT's 1x1 fusion
conv `conv` alone, so the test sets it with `conv_kernel`), BatchNorm
statistics perturbed, back through `swint_from_flax`. Tiny model (n_feat
8, embed_dim 32, one depth-2 RSTB, 4 heads), 40x40, float32, rtol/atol
1e-4; the train step holds each tensor to 1e-4 max|jax| + 1e-6 on a batch
whose TripletAttention max-pools hold no near ties (tests/test_torch_train.py
says why).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from speinet_tpu.config import Config as JConfig
from speinet_tpu.config import set_template as j_set_template
from speinet_tpu.models.recons_video import ReconsVideo as JRecons
from speinet_tpu.models.swint import SWINT as JSWINT
from speinet_tpu.training.train_state import TrainState
from speinet_tpu.training.train_state import make_optimizer as j_make_optimizer
from speinet_tpu.training.train_state import make_train_step as j_make_train_step
from speinet_tpu.utils.convert import conv_kernel, convert_recons, convert_state_dict
from speinet_tpu_torch.config import Config, set_template
from speinet_tpu_torch.models import make_model
from speinet_tpu_torch.models.recons_video import ReconsVideo
from speinet_tpu_torch.models.speinet import SPEINet, init_weights
from speinet_tpu_torch.models.swint import SWINT
from speinet_tpu_torch.training.loss import LossComputer
from speinet_tpu_torch.training.train_state import make_optimizer, train_step
from speinet_tpu_torch.utils.convert import (flax_model_name, flax_model_shape,
                                             swint_from_flax)
from test_end_to_end import TINY_ARGS, make_tree
from test_torch_models import TINY, _frames
from test_torch_train import (POOL_MARGIN, _assert_adam_close,
                              _assert_tensors_close, _min_pool_gap,
                              _one_torch_thread)  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
DEPTHS = TINY["depths"]
# a batch whose max-pools keep their top two >= POOL_MARGIN apart
STEP_SEED = 170


def _weights(ns: int, seed: int = 3):
    """(flax variables, port SWINT) for window length `ns`, same weights."""
    jm = JSWINT(n_sequence=ns, **TINY, drop_path_rate=0.0)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, ns, 3, 40, 40))))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    port = init_weights(SWINT(n_sequence=ns, **TINY), seed=seed)
    sd = port.state_dict()
    params, bstats = convert_state_dict(sd, template, depths=DEPTHS, n_resblock=3)
    params["conv"] = {"kernel": conv_kernel(sd["conv.weight"]),
                      "bias": sd["conv.bias"].numpy()}
    rng = np.random.default_rng(seed)
    bstats = jax.tree_util.tree_map_with_path(
        lambda p, a: ((0.1 * rng.standard_normal(a.shape)) if "mean" in
                      jax.tree_util.keystr(p) else 0.5 + rng.random(a.shape)
                      ).astype(a.dtype), bstats)
    port.load_state_dict(swint_from_flax(params, bstats, depths=DEPTHS), strict=True)
    return {"params": params, "batch_stats": bstats}, jm, port.eval()


@pytest.fixture(scope="module")
def swint3():
    return _weights(3)


def _batch(ns: int, seed: int, samples: int = 2):
    """[samples, ns + 2, 3, 40, 40]: the window and the loader's two sharp
    frames, which SWINT does not read."""
    return np.stack([_frames(ns + 2, 40, 40, seed=seed + k) for k in range(samples)])


def test_swint_from_flax_round_trip(swint3):
    """port state_dict -> the JAX converter (+ conv) -> swint_from_flax gives
    the same tensors, and the tree reads as a SWINT of the tiny shape."""
    variables, _, port = swint3
    sd = port.state_dict()
    p2, b2 = convert_state_dict(sd, jax.tree_util.tree_map(np.array, variables),
                                depths=DEPTHS, n_resblock=3)
    p2["conv"] = {"kernel": conv_kernel(sd["conv.weight"]),
                  "bias": sd["conv.bias"].numpy()}
    back = swint_from_flax(p2, b2, depths=DEPTHS)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    assert flax_model_name(variables["params"]) == "SWINT"
    assert flax_model_shape(variables["params"]) == dict(
        n_feat=8, n_sequence=3, embed_dim=32, depths=[2], n_resblock=3)


@pytest.mark.parametrize("ns,fuse", [(3, True), (1, True), (3, False)],
                         ids=["nseq3", "nseq1", "nseq3_split"])
def test_forward_matches_jax(swint3, ns, fuse):
    """The eval forward, batched encoder legs (K1's plain version here),
    against the JAX model on a 2-window batch; `split` runs the blocks as
    K8 + K9's plain versions (swin_fuse_block=False)."""
    variables, jm, port = swint3 if ns == 3 else _weights(ns)
    if not fuse:
        split = SWINT(n_sequence=ns, **TINY, swin_fuse_block=False)
        split.load_state_dict(port.state_dict(), strict=True)
        port = split.eval()
    x = _batch(ns, seed=60)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x[:, :ns]))
    got = port(torch.from_numpy(x))
    assert got.shape == (2, 3, 40, 40) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_train_step_matches_jax(swint3):
    """One step (loss 1*L1, drop_path_rate 0) against `make_train_step`: the
    loss, every gradient, the parameters after Adam and the BatchNorm running
    statistics, which each gate updates once per frame, centre first, then
    the neighbours (the port encodes the frames one by one in training)."""
    variables, _, port = swint3
    x = _batch(3, seed=STEP_SEED)
    gt = np.clip(x[:, 1] * 1.05 - 0.02, 0.0, 1.0).astype(np.float32)
    jcfg = j_set_template(JConfig(template="SWINT")).replace(
        n_feat=8, embed_dim=32, depths=list(DEPTHS), num_heads=[4],
        drop_path_rate=0.0, loss="1*L1", lr=1e-4)
    jm = JSWINT.from_config(jcfg)
    tx = j_make_optimizer(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                          variables["batch_stats"]),
                       opt_state=tx.init(params), lr=jnp.asarray(jcfg.lr, jnp.float32))
    new_state, j_total, _ = j_make_train_step(jcfg, jm, tx)(
        state, jnp.asarray(x), jnp.asarray(gt), jax.random.PRNGKey(0))
    adam = next(s for s in new_state.opt_state if hasattr(s, "mu"))
    j_grads = jax.tree_util.tree_map(lambda m: m / (1.0 - jcfg.beta1), adam.mu)

    cfg = set_template(Config(template="SWINT")).replace(loss="1*L1", lr=1e-4)
    model = SWINT(**TINY, drop_path_rate=0.0)
    model.load_state_dict(port.state_dict(), strict=True)
    out = {}

    def step():
        out["total"], _ = train_step(model, make_optimizer(cfg, model),
                                     LossComputer(cfg.loss), torch.from_numpy(x),
                                     torch.from_numpy(gt), torch.Generator().manual_seed(0))

    gap = _min_pool_gap(model, step)
    print(f"smallest top-2 gap {gap:.3e}")
    assert gap >= POOL_MARGIN, gap
    np.testing.assert_allclose(out["total"].item(), float(j_total), rtol=1e-5)
    as_port = lambda p, b: swint_from_flax(jax.device_get(p), jax.device_get(b),
                                           depths=DEPTHS)
    grads = {n: p.grad for n, p in model.named_parameters()}
    want = {n: t for n, t in as_port(j_grads, variables["batch_stats"]).items()
            if n in grads}
    assert set(grads) == set(want)
    _assert_tensors_close(grads, want, "gradient")
    after = as_port(new_state.params, new_state.batch_stats)
    before, got = port.state_dict(), model.state_dict()
    _assert_adam_close(got, {n: t for n, t in after.items()
                             if n in grads}, before, want, cfg.lr)
    stats = {n: t for n, t in after.items() if n.endswith(("running_mean", "running_var"))}
    assert stats
    _assert_tensors_close(got, stats, "BatchNorm statistic after the step")
    # every statistic moved: the encoder's gates once per frame, the
    # decoder's once
    assert not any(torch.equal(got[n], before[n]) for n in stats)
    counts = {n: int(v) for n, v in got.items() if n.endswith("num_batches_tracked")}
    assert counts and all(v == (3 if n.startswith(("recons_net.inBlock.",
                                                   "recons_net.encoder_")) else 1)
                          for n, v in counts.items()), counts


def test_make_model_and_recons_video_forward():
    """The registry maps the three names (any case) to the port's classes
    and refuses others; ReconsVideo.forward, the whole hourglass on NHWC
    input, matches the JAX ReconsVideo.__call__."""
    base = set_template(Config(template="SWINT")).replace(
        n_feat=8, embed_dim=32, depths=[2], num_heads=[4])
    assert type(make_model(base)) is SWINT
    assert type(make_model(base.replace(model="speinet"))) is SPEINet
    split = SWINT.from_config(base, swin_fuse_block=False)
    assert not split.swin.layers[0].residual_group.blocks[0].fuse_block
    recons = make_model(base.replace(model="RECONS_VIDEO"))
    assert type(recons) is ReconsVideo
    with pytest.raises(NotImplementedError, match="NOPE"):
        make_model(base.replace(model="NOPE"))

    init_weights(recons, seed=5).eval()
    jm = JRecons(n_feat=8)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 40, 40, 3))))
    params, bstats = (jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                             shapes[col])
                      for col in ("params", "batch_stats"))
    convert_recons(recons.state_dict(), "", params, bstats, "", n_resblock=3)
    x = np.random.default_rng(8).random((2, 40, 40, 3)).astype(np.float32)
    want = jax.jit(jm.apply)({"params": params, "batch_stats": bstats},
                             jnp.asarray(x))
    got = recons(torch.from_numpy(x))
    assert got.shape == (2, 40, 40, 3) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_main_swint_one_epoch(tmp_path):
    """main_swint on the CPU for one epoch of a tiny tree: the SWINT
    template, a finite PSNR and the best checkpoint."""
    from speinet_tpu_torch.main_swint import main

    root = make_tree(tmp_path / "ds")
    exp = tmp_path / "exp"
    main(["--device", "cpu", "--dir_data", str(root), "--dir_data_test", str(root),
          "--experiment_dir", str(exp) + "/", "--save", "swint", "--epochs", "1"]
         + TINY_ARGS)
    d = exp / "swint"
    psnr = np.load(d / "psnr.npy")
    assert len(psnr) == 1 and np.isfinite(psnr[0])
    assert (d / "model" / "model_best").exists()
    ckpt = torch.load(d / "model" / "model_best", weights_only=True)
    assert "conv.weight" in ckpt["model"] and not any(
        k.startswith("conv_lv") for k in ckpt["model"])
    assert '"model": "SWINT"' in (d / "config.txt").read_text()
