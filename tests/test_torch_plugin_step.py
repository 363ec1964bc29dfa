"""One train step of the port with the VGG and GAN loss plugins against
speinet_tpu's `make_train_step`, on the CPU.

Loss 1*L1 + 0.1*VGG22 + 0.01*GAN (the plugin weights of
tests/test_loss_plugins.py), drop_path_rate 0, the JAX package's XLA path;
the weights, batch and whole-step rule of tests/test_torch_train.py, the
discriminator carried across by `discriminator_from_flax`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import speinet_tpu.training.adversarial as jadv
from speinet_tpu.models.speinet import SPEINet as JSPEINet
from speinet_tpu.training.train_state import TrainState
from speinet_tpu.training.train_state import make_optimizer as j_make_optimizer
from speinet_tpu.training.train_state import make_train_step as j_make_train_step
from speinet_tpu_torch.config import Config, set_template
from speinet_tpu_torch.training.loss import LossComputer
from speinet_tpu_torch.training.train_state import (make_gan_state, make_optimizer,
                                                    train_step)
from speinet_tpu_torch.utils.convert import discriminator_from_flax
from test_torch_models import shared  # noqa: F401
from test_torch_train import (STEP_SEED, _as_port, _assert_adam_close,
                              _assert_tensors_close, _batch, _jax_cfg,
                              _one_torch_thread, _port_copy)  # noqa: F401


def test_gan_vgg_train_step_matches_jax(shared):  # noqa: F811
    """One step of loss 1*L1 + 0.1*VGG22 + 0.01*GAN (drop_path_rate 0, the
    XLA path on the JAX side): loss and components, every gradient, the
    parameters after Adam, and D's loss and parameters after its own step,
    against `make_train_step` with the same D."""
    variables, port = shared
    x, gt = _batch(seed=STEP_SEED)
    spec = "1*L1+0.1*VGG22+0.01*GAN"
    jcfg = _jax_cfg(loss=spec, lr=1e-4)
    jm = JSPEINet.from_config(jcfg)
    tx = j_make_optimizer(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    bstats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    # create_train_state's gan subtree (train_state.py:44-51) beside the
    # shared weights; its flax init of the model is left out (a minute here)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=bstats, opt_state=tx.init(params),
                       lr=jnp.asarray(jcfg.lr, jnp.float32),
                       gan=jadv.init_gan_state(jax.random.fold_in(
                           jax.random.PRNGKey(0), 7), (1, 3, 40, 40)))
    d_before = discriminator_from_flax(jax.device_get(state.gan["params"]))
    new_state, j_total, j_comps = j_make_train_step(jcfg, jm, tx)(
        state, jnp.asarray(x), jnp.asarray(gt), jax.random.PRNGKey(0))
    mu = lambda opt: next(s for s in opt if hasattr(s, "mu")).mu
    j_grads = jax.tree_util.tree_map(lambda m: m / (1.0 - jcfg.beta1),
                                     mu(new_state.opt_state))
    d_grads = discriminator_from_flax(jax.device_get(jax.tree_util.tree_map(
        lambda m: m / 0.1, mu(new_state.gan["opt"]))))

    cfg = set_template(Config(template="SPEINet")).replace(loss=spec, lr=1e-4)
    model = _port_copy(port, drop_path_rate=0.0)
    gan = make_gan_state(cfg, device="cpu")
    gan.dis.load_state_dict(d_before, strict=True)
    total, comps = train_step(model, make_optimizer(cfg, model),
                              LossComputer(cfg.loss, rgb_range=cfg.rgb_range),
                              torch.from_numpy(x), torch.from_numpy(gt),
                              torch.Generator().manual_seed(0), gan)
    assert set(comps) == {"L1", "VGG22", "GAN", "DIS", "Total"} == set(j_comps)
    for k, v in comps.items():
        np.testing.assert_allclose(v.item(), float(j_comps[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(total.item(), float(j_total), rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    want = {n: t for n, t in _as_port(j_grads, variables["batch_stats"]).items()
            if n in grads}
    assert set(grads) == set(want)
    _assert_tensors_close(grads, want, "gradient")
    after = _as_port(new_state.params, new_state.batch_stats)
    _assert_adam_close(model.state_dict(), {
        n: t for n, t in after.items() if not n.endswith("num_batches_tracked")},
        port.state_dict(), want, cfg.lr)
    d_after = discriminator_from_flax(jax.device_get(new_state.gan["params"]))
    _assert_adam_close(gan.dis.state_dict(), d_after, d_before, d_grads, cfg.lr)
    assert not any(torch.equal(gan.dis.state_dict()[n], d_before[n]) for n in d_before)
