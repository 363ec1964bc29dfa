"""`orbax_to_torch.py` on checkpoints the JAX package writes, on the CPU.

A tiny JAX model's weights (BatchNorm statistics perturbed) are saved by
`speinet_tpu.utils.checkpoint.CheckpointManager` twice: an inference
checkpoint (`model_best` of a state without a discriminator, converted
through the script's `main`) and a training one (`model_latest` with Adam
and a GAN discriminator, converted through `convert`). The port loads
each .pt strictly, and its forward matches the JAX model's at rtol/atol
1e-4. (Other window lengths convert alike: tests/test_torch_nseq.py reads
n_sequence 1 and 5 off converted trees.)
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import orbax_to_torch
from speinet_tpu.config import Config as JConfig
from speinet_tpu.training.adversarial import init_gan_state
from speinet_tpu.training.train_state import TrainState, make_optimizer
from speinet_tpu.utils.checkpoint import CheckpointManager
from speinet_tpu_torch.models.speinet import SPEINet
from test_torch_models import TINY, _frames
from test_torch_nseq import _one_torch_thread, _weights  # noqa: F401


@pytest.fixture(scope="module")
def jax_side():
    """The JAX model's weights and its output on a 2-window batch (sample 1
    routed to the self reference), computed once for both checkpoints."""
    variables, jm, _ = _weights(3, seed=7)
    x = np.stack([_frames(5, 32, 32, seed=50 + k) for k in range(2)])
    x[1, 3] = 0.0
    return variables, x, np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["inference", "training"])
def test_orbax_checkpoint_converts_and_loads(tmp_path, capsys, jax_side, kind):
    variables, x, want = jax_side
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = make_optimizer(JConfig(weight_decay=0.0))
    state = TrainState(step=jnp.asarray(12, jnp.int32), params=params,
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(params), lr=jnp.asarray(1e-4, jnp.float32),
                       gan=None if kind == "inference" else init_gan_state(
                           jax.random.PRNGKey(3), (1, 3, 32, 32)))
    ckpt = CheckpointManager(str(tmp_path / "model"))
    ckpt.save(state, epoch=1, is_best=True)
    pt = tmp_path / "port.pt"
    if kind == "inference":
        assert orbax_to_torch.main([str(tmp_path / "model" / "model_best"), str(pt)]) == 0
        assert '"n_sequence": 3' in capsys.readouterr().out
    else:
        name, shape = orbax_to_torch.convert(str(tmp_path / "model" / "model_latest"),
                                             str(pt))
        assert name == "SPEINet" and shape == dict(n_feat=8, n_sequence=3, embed_dim=32, depths=[2],
                             n_resblock=3)
    port = SPEINet(**TINY)
    port.load_state_dict(torch.load(pt, weights_only=True), strict=True)
    got = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
