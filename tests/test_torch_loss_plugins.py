"""The port's VGG and GAN loss plugins against speinet_tpu's, on the CPU.

- VGG22 / VGG54 features and loss with the JAX package's default bank (drawn
  alike in both packages, nothing converted) and with an .npz named by
  SPEINET_VGG_WEIGHTS; a kernel of the wrong shape is refused.
- The discriminator's logits, `generator_loss` and its gradient, and two
  `discriminator_step`s (Adam's bias correction at steps 1 and 2) against
  the flax discriminator and optax, with its weights converted by
  `discriminator_from_flax`.
- One train step with both plugins: tests/test_torch_plugin_step.py.
- Checkpoints carry the discriminator and its Adam state; one without them
  restores the rest and keeps a fresh discriminator.
float32, rtol/atol 1e-4 unless stated.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import speinet_tpu.training.adversarial as jadv
import speinet_tpu.training.perceptual as jvgg
from speinet_tpu_torch.training import adversarial, perceptual
from speinet_tpu_torch.training.loss import LossComputer
from speinet_tpu_torch.config import Config
from speinet_tpu_torch.training.train_state import make_gan_state
from speinet_tpu_torch.utils.checkpoint import CheckpointManager
from speinet_tpu_torch.utils.convert import discriminator_from_flax
from test_torch_train import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)


def _images(seed, b=2, h=32, w=32):
    return (np.random.default_rng(seed).random((b, 3, h, w)) * 255).astype(np.float32)


@pytest.fixture
def vgg_env(monkeypatch):
    """Sets SPEINET_VGG_WEIGHTS; the JAX package caches its bank per layer
    name, so its cache is cleared around the test."""
    jvgg._weights.cache_clear()
    yield lambda path: monkeypatch.setenv("SPEINET_VGG_WEIGHTS", str(path))
    jvgg._weights.cache_clear()


@pytest.mark.parametrize("bank", ["default", "npz"])
@pytest.mark.parametrize("conv_index", ["22", "54"])
def test_vgg_matches_jax(tmp_path, vgg_env, conv_index, bank):
    if bank == "npz":
        rng = np.random.default_rng(int(conv_index))
        layers = jvgg._layers_upto(conv_index)
        arrays = {f"conv{i}": (0.1 * rng.standard_normal((3, 3, ci, co))).astype(np.float32)
                  for i, (ci, co, _) in enumerate(layers)}
        arrays.update({f"bias{i}": (0.01 * rng.standard_normal(co)).astype(np.float32)
                       for i, (_, co, _) in enumerate(layers) if i % 2})
        np.savez(tmp_path / "vgg.npz", **arrays)
        vgg_env(tmp_path / "vgg.npz")
    out, gt = _images(1), _images(2)
    want = jvgg.vgg_features(jnp.asarray(out), conv_index)
    got = perceptual.vgg_features(torch.from_numpy(out), conv_index)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * float(jnp.abs(want).max()))
    t_out = torch.from_numpy(out).requires_grad_(True)
    loss = perceptual.vgg_loss(t_out, torch.from_numpy(gt), conv_index)
    j_loss, j_grad = jax.jit(jax.value_and_grad(jvgg.vgg_loss), static_argnums=2)(
        jnp.asarray(out), jnp.asarray(gt), conv_index)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-4)
    loss.backward()
    if conv_index == "54":
        # through 16 convs XLA's CPU gradient is 3.7e-3 of its max off a
        # float64 evaluation (the port's 4e-6): hold the port to float64
        j_grad = _vgg_grad_f64(out, gt, conv_index)
    np.testing.assert_allclose(t_out.grad.numpy(), np.asarray(j_grad), rtol=1e-4,
                               atol=1e-4 * float(np.abs(j_grad).max()))


def _vgg_grad_f64(out, gt, conv_index):
    """d vgg_loss / d out in float64, with the JAX package's bank and plan."""
    import torch.nn.functional as F

    def feats(x):
        x = (x / 255.0 - torch.tensor(jvgg._IMAGENET_MEAN, dtype=torch.float64).view(
            1, 3, 1, 1)) / torch.tensor(jvgg._IMAGENET_STD, dtype=torch.float64).view(
            1, 3, 1, 1)
        for (k, b), (_, _, pool) in zip(jvgg._weights(conv_index),
                                        jvgg._layers_upto(conv_index)):
            x = torch.relu(F.conv2d(x, torch.from_numpy(k.transpose(3, 2, 0, 1)).double(),
                                    torch.from_numpy(b).double(), padding=1))
            x = F.max_pool2d(x, 2, 2) if pool else x
        return x

    t = torch.from_numpy(out).double().requires_grad_(True)
    with torch.no_grad():
        f_gt = feats(torch.from_numpy(gt).double())
    ((feats(t) - f_gt) ** 2).mean().backward()
    return t.grad.numpy()


def test_vgg_npz_of_wrong_shape_is_refused(tmp_path, vgg_env):
    np.savez(tmp_path / "bad.npz", conv0=np.zeros((3, 3, 3, 32), np.float32))
    vgg_env(tmp_path / "bad.npz")
    with pytest.raises(ValueError, match="conv0 has shape"):
        perceptual.vgg_features(torch.zeros((1, 3, 8, 8)))


def _gan_pair(seed=1, h=32, w=32):
    """(the JAX gan state, the port's GanState) holding the same weights."""
    j_gan = jadv.init_gan_state(jax.random.PRNGKey(seed), (2, 3, h, w))
    gan = adversarial.init_gan_state(torch.Generator().manual_seed(0), device="cpu")
    gan.dis.load_state_dict(discriminator_from_flax(jax.device_get(j_gan["params"])),
                            strict=True)
    return j_gan, gan


def test_discriminator_and_generator_loss_match_jax():
    j_gan, gan = _gan_pair()
    out = _images(3)
    want = jax.jit(jadv.Discriminator().apply)({"params": j_gan["params"]},
                                               jadv._prep(jnp.asarray(out), 255.0))
    got = gan.dis(adversarial.prep(torch.from_numpy(out), 255.0))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    j_loss, j_grad = jax.jit(jax.value_and_grad(
        lambda o: jadv.generator_loss(j_gan, o)))(jnp.asarray(out))
    t_out = torch.from_numpy(out).requires_grad_(True)
    loss = adversarial.generator_loss(gan, t_out)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    loss.backward()
    np.testing.assert_allclose(t_out.grad.numpy(), np.asarray(j_grad), rtol=1e-4,
                               atol=1e-4 * float(jnp.abs(j_grad).max()))
    assert all(p.grad is None for p in gan.dis.parameters())   # D frozen


def test_discriminator_steps_match_optax():
    """Two Adam updates at rate 1e-3 on different batches: D's parameters
    after each within 1e-5 of optax's, and the loss before each alike. As
    in tests/test_torch_train.py::_assert_adam_close, an element whose
    bias-corrected first moment lies within 1e-4 of its tensor's max (+
    1e-6) of zero moves by lr times a ratio that rounding may swing, even
    in sign: there each side's move is only held to lr, and the element is
    left out of later comparisons, since the two sides now start apart."""
    j_gan, gan = _gan_pair(seed=2)
    loose = {}
    for k in range(2):
        before = {n: p.clone() for n, p in gan.dis.state_dict().items()}
        out, gt = _images(10 + k), _images(20 + k)
        j_gan, j_loss = jax.jit(jadv.discriminator_step)(j_gan, jnp.asarray(out),
                                                         jnp.asarray(gt), lr=1e-3)
        loss = adversarial.discriminator_step(gan, torch.from_numpy(out),
                                              torch.from_numpy(gt), lr=1e-3)
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
        want = discriminator_from_flax(jax.device_get(j_gan["params"]))
        m_hat = discriminator_from_flax(jax.device_get(jax.tree_util.tree_map(
            lambda m: m / (1 - 0.9 ** (k + 1)), j_gan["opt"][0].mu)))
        for name, p in gan.dis.state_dict().items():
            w, m = want[name], m_hat[name].abs()
            b = m <= 1e-4 * m.max() + 1e-6
            for side in (p, w):
                assert (side - before[name])[b].abs().numpy().max(initial=0) <= 1.001e-3
            b = loose[name] = b | loose.get(name, b)
            np.testing.assert_allclose(p[~b].numpy(), w[~b].numpy(), rtol=0,
                                       atol=1e-5, err_msg=f"step {k + 1} {name}")


def test_loss_spec_dispatch():
    lc = LossComputer("1*L1+0.1*VGG54+0.01*GAN")
    assert lc.names == ["L1", "VGG54", "GAN", "DIS", "Total"] and lc.has_gan
    with pytest.raises(ValueError, match="discriminator state"):
        lc(torch.zeros((1, 3, 16, 16)), torch.zeros((1, 3, 16, 16)))
    with pytest.raises(NotImplementedError):
        LossComputer("1*SSIM")


def _trained_gan():
    gan = make_gan_state(Config(loss="1*L1+0.01*GAN"), device="cpu")
    adversarial.discriminator_step(gan, torch.from_numpy(_images(4)),
                                   torch.from_numpy(_images(5)), lr=1e-3)
    return gan


def test_checkpoint_round_trip_with_discriminator(tmp_path):
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(model.parameters())
    gan = _trained_gan()
    ckpt = CheckpointManager(str(tmp_path / "model"))
    ckpt.save(model, opt, step=7, epoch=1, gan=gan)
    fresh = adversarial.init_gan_state(torch.Generator().manual_seed(9), device="cpu")
    assert ckpt.restore(torch.nn.Linear(3, 2), torch.optim.Adam(model.parameters()),
                        gan=fresh) == 7
    for name, p in gan.dis.state_dict().items():
        assert torch.equal(fresh.dis.state_dict()[name], p), name
    want, got = gan.opt.state_dict(), fresh.opt.state_dict()
    assert want["param_groups"] == got["param_groups"]
    for k, s in want["state"].items():
        for field, v in s.items():
            assert torch.equal(got["state"][k][field], v), (k, field)


def test_checkpoint_without_discriminator_keeps_a_fresh_one(tmp_path):
    model = torch.nn.Linear(3, 2)
    ckpt = CheckpointManager(str(tmp_path / "model"))
    ckpt.save(model, torch.optim.Adam(model.parameters()), step=3, epoch=1)
    fresh = adversarial.init_gan_state(torch.Generator().manual_seed(9), device="cpu")
    before = {k: v.clone() for k, v in fresh.dis.state_dict().items()}
    restored = torch.nn.Linear(3, 2)
    assert ckpt.restore(restored, torch.optim.Adam(restored.parameters()),
                        gan=fresh) == 3
    assert torch.equal(restored.weight, model.weight)
    for name, p in fresh.dis.state_dict().items():
        assert torch.equal(p, before[name]), name
    assert not fresh.opt.state_dict()["state"]
