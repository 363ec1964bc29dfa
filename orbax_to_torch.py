#!/usr/bin/env python3
"""Convert an orbax checkpoint of the JAX package to the PyTorch port's
weights.

    python orbax_to_torch.py <checkpoint dir> <out.pt>

The checkpoint is what `speinet_tpu.utils.checkpoint.CheckpointManager`
writes (`model_latest`, `model_best`, `model_{epoch}`), or any orbax tree
with `params` and `batch_stats`, as `speinet_tpu.infer --model_path` reads
it. It is restored on the CPU with `ocp.StandardCheckpointer().restore`, and
its SPEINet or SWINT parameters and BatchNorm statistics are written as
the port's `state_dict` (`speinet_tpu_torch.utils.convert.from_flax_params`
or `swint_from_flax`, chosen by the tree's keys): the file
`speinet_tpu_torch.infer --model_path` and `main_train --pre_train` take.
The model's name and the configuration the tree was built with (n_feat,
n_sequence, embed_dim, depths, n_resblock) are read off its keys and shapes
and printed; pass the same to the port. A GAN discriminator in the checkpoint is not carried over.

The script needs orbax (and so JAX) where it runs; the port itself does
not, so it lives outside `speinet_tpu_torch/`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402
import torch  # noqa: E402

from speinet_tpu_torch.utils.convert import (flax_model_name,  # noqa: E402
                                             flax_model_shape, from_flax_params,
                                             swint_from_flax)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def convert(checkpoint: str, out: str) -> tuple[str, dict]:
    """Restore `checkpoint`, write the port's state_dict to `out`; returns
    the model's name and the configuration read off the tree's shapes."""
    tree = ocp.StandardCheckpointer().restore(os.path.abspath(checkpoint))
    params = _numpy_tree(tree["params"])
    batch_stats = _numpy_tree(tree.get("batch_stats", {}))
    shape = flax_model_shape(params)
    name = flax_model_name(params)
    to_port = swint_from_flax if name == "SWINT" else from_flax_params
    torch.save(to_port(params, batch_stats, depths=shape["depths"],
                       n_resblock=shape["n_resblock"]), out)
    return name, shape


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("checkpoint", help="orbax checkpoint directory")
    p.add_argument("out", help="the port's state_dict (.pt) to write")
    args = p.parse_args(argv)
    name, shape = convert(args.checkpoint, args.out)
    print(f"wrote {args.out}; model {name} {json.dumps(shape)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
