"""Data parallelism over torch.distributed (port of
`speinet_tpu/parallel/mesh.py`; parity: the reference's
`nn.DataParallel(range(n_GPUs))`).

The JAX package shards the batch of frame windows over a 1-D 'dp' device
mesh, replicates the parameters and lets XLA's partitioner all-reduce the
gradient. The port runs one process per card, launched by `torchrun`, in
one process group whose backend follows the device: nccl for CUDA tensors,
gloo for CPU tensors. Each process holds its contiguous rows of the global
batch, which is the ranks' rows concatenated in rank order, as
`jax.make_array_from_process_local_data` assembles it.

Without a group (a plain `python -m ...` run) `world()` is 1, `rank()` is 0
and nothing here calls a collective. Under a group of any size, one
included, every collective runs.

`--dp_devices` 0 means the whole group; any other value must equal its
size. A process group cannot shrink to the largest divisor of the batch as
`make_mesh_for_batch` shrinks the mesh, so the two differ there.
"""

from __future__ import annotations

import atexit
import os
from typing import Callable, Iterable

import torch
import torch.distributed as dist

from speinet_tpu_torch.utils.device import resolve_device


def active() -> bool:
    """Whether a process group is open."""
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    """Processes in the group; 1 without one."""
    return dist.get_world_size() if active() else 1


def rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if active() else 0


def is_main() -> bool:
    """Whether this process writes files and logs (rank 0)."""
    return rank() == 0


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def maybe_init_distributed(device="cuda") -> torch.device:
    """The device this process runs on, with the process group opened when
    the process was launched by torchrun (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR / MASTER_PORT in the environment), as
    `jax.distributed.initialize` reads its own cluster variables. On the
    card that device is cuda:LOCAL_RANK and the backend nccl; with
    device='cpu' the CPU and gloo. A group the caller opened already is
    kept; its backend must be the device's."""
    dev = resolve_device(device)
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if dev.type == "cuda" and (launched or active()):
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if active():
        if dist.get_backend() != _backend_for(dev):
            raise ValueError(f"the process group's backend is {dist.get_backend()}; "
                             f"{dev.type} tensors take {_backend_for(dev)}")
    elif launched:
        kw = {"device_id": dev} if dev.type == "cuda" else {}
        dist.init_process_group(_backend_for(dev), init_method="env://", **kw)
        atexit.register(close_group)
    return dev


def close_group() -> None:
    """Destroy the process group if one is open."""
    if active():
        dist.destroy_process_group()


def dp_world(dp_devices: int) -> int:
    """The data-parallel size `--dp_devices` asks for: 0 is the whole group;
    any other value must be the group's size."""
    n = world()
    if dp_devices and dp_devices != n:
        raise ValueError(
            f"--dp_devices {dp_devices}: this run has {n} process(es), and a "
            f"process group cannot shrink as the JAX package's mesh does; launch "
            f"{dp_devices} with torchrun --nproc_per_node {dp_devices}, or pass 0")
    return n


def check_batch(batch_size: int) -> None:
    """Raise unless the global batch divides over the group (parity:
    speinet_tpu/data/loader.py:46-50)."""
    if batch_size % world():
        raise ValueError(f"batch_size {batch_size} must divide evenly over "
                         f"{world()} processes")


def batch_slice(n_global: int) -> slice:
    """This rank's contiguous rows of a global batch of n_global rows."""
    check_batch(n_global)
    b = n_global // world()
    return slice(rank() * b, (rank() + 1) * b)


def gather_batch(t: torch.Tensor) -> torch.Tensor:
    """Every rank's t (one shape on all) concatenated along axis 0 in rank
    order; t itself without a group."""
    if not active():
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(world())]
    dist.all_gather(parts, t)
    return torch.cat(parts)


def shard_rows(fn: Callable, *tensors: torch.Tensor) -> torch.Tensor:
    """fn over this rank's rows of `tensors` (one leading size n), the
    results gathered back in row order: [n, ...]. n is padded to a multiple
    of the group by repeating the last row, and the padding's results are
    dropped, as the JAX trainer pads an eval batch to the mesh
    (speinet_tpu/training/trainer.py:154-160). fn(*tensors) without a
    group."""
    if not active():
        return fn(*tensors)
    n, p = tensors[0].shape[0], world()
    m = -(-n // p) * p
    if m != n:
        tensors = tuple(torch.cat([t, t[-1:].expand(m - n, *t.shape[1:])])
                        for t in tensors)
    rows = batch_slice(m)
    return gather_batch(fn(*(t[rows] for t in tensors)))[:n]


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group whose backward sums the gradient over the group:
    each rank's input reaches every rank's loss."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of t over the group, differentiable; t without a group."""
    return _AllReduceSum.apply(t) if active() else t


@torch.no_grad()
def mean_over_group(t: torch.Tensor) -> torch.Tensor:
    """The mean of t over the group (not differentiable); t without one."""
    if not active():
        return t
    t = t.clone()
    dist.all_reduce(t)
    return t / world()


@torch.no_grad()
def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace every gradient that is not None by its mean over the group,
    one flattened all-reduce per dtype: the gradient all-reduce of the JAX
    package's data-parallel step (speinet_tpu/training/train_state.py:
    74-117). Every rank must hold gradients for the same parameters, which
    the model's data-independent training graph gives."""
    if not active():
        return
    by_dtype: dict = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat /= world()
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
