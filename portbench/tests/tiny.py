"""Small shapes for the CPU tests: one tiny model configuration of each
kind, the template's structure at narrow widths."""

import torch

TINY = dict(model="SPEINet", n_sequence=3, n_feat=8, n_resblock=1, n_colors=3,
            embed_dim=32, depths=[2, 2], num_heads=[4, 4], window_size=5,
            mlp_ratio=2.0, drop_path_rate=0.1, patch_size=32, batch_size=4,
            loss="1*L1+2*HEM", lr=1e-4, size_must_mode=4, rgb_range=1.0,
            compute_dtype="float32", n_threads=2)


def tiny(model: str = "SPEINet") -> dict:
    return dict(TINY, model=model)


def port_model(cfg: dict, weights: dict):
    """The program's model of `cfg` with `weights`."""
    from speinet_tpu_torch.models import make_model

    from portbench.harness.video import port_config

    m = make_model(port_config(cfg))
    m.load_state_dict(weights, strict=True)
    return m


def one_thread():
    torch.set_num_threads(1)
