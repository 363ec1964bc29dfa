"""Halo-exchange spatial sharding (port of `speinet_tpu/parallel/halo.py`).

The H axis of [B, H, W, C] is split over the process group in contiguous
row blocks, rank order top to bottom; each rank receives `halo` rows from
each neighbour so that a convolution sees a real halo instead of
recomputing an overlap as the 4-tile chop does. The JAX package exchanges
the rows with two `ppermute`s inside `shard_map`; here each rank posts its
sends and receives to its neighbours as one `batch_isend_irecv`. Neither
package's model runs on this path: `sharded_conv2d` shows the pattern end
to end.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F

from speinet_tpu_torch.parallel.mesh import active, rank, world


def halo_exchange(x: torch.Tensor, halo: int) -> torch.Tensor:
    """[B, H_loc, W, C] -> [B, H_loc + 2 halo, W, C]: this rank's rows with
    the previous rank's last `halo` rows above and the next rank's first
    `halo` rows below, zeros at the global borders (parity: halo.py:25-44)."""
    if halo > x.shape[1]:
        raise ValueError(f"halo {halo} exceeds the {x.shape[1]} local rows")
    top = torch.zeros_like(x[:, :halo])
    bottom = torch.zeros_like(x[:, :halo])
    ops = []
    if active():
        r, p = rank(), world()
        if r > 0:
            ops += [dist.P2POp(dist.isend, x[:, :halo].contiguous(), r - 1),
                    dist.P2POp(dist.irecv, top, r - 1)]
        if r < p - 1:
            ops += [dist.P2POp(dist.isend, x[:, -halo:].contiguous(), r + 1),
                    dist.P2POp(dist.irecv, bottom, r + 1)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([top, x, bottom], dim=1)


def sharded_conv2d(kernel: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """The H-sharded depthwise SAME convolution with kernel [kh, kw]: maps a
    rank's rows [B, H_loc, W, C] to its rows of the unsharded
    `ops.filters.depthwise_conv2d`, zero padding included (parity:
    halo.py:47-69)."""
    kh, kw = kernel.shape
    halo = kh // 2

    def local_conv(x: torch.Tensor) -> torch.Tensor:
        xh = halo_exchange(x, halo).permute(0, 3, 1, 2)
        c = xh.shape[1]
        w = kernel.to(device=x.device, dtype=x.dtype).expand(c, 1, kh, kw)
        y = F.conv2d(xh, w, padding=(0, kw // 2), groups=c)
        return y.permute(0, 2, 3, 1)

    return local_conv
