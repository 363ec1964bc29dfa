"""Plain float32 reference of the training step: forward in training form,
the loss `1*L1+2*HEM`, autograd's backward, Adam. It follows the program
through its first steps from the same weights, batches and seed, and
redraws the step's random numbers (DropPath, HEM's random pixels) from a
generator seeded alike, in the order the published training loop draws
them: every DropPath mask of a forward, then HEM's draw."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from portbench.reference.model import Net, Params

BUFFERS = ("running_mean", "running_var", "num_batches_tracked")
HARD_P, RANDOM_P = 0.5, 0.1


def is_param(name: str) -> bool:
    return not name.endswith(BUFFERS)


def hem_loss(x: torch.Tensor, y: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Hard-example mining: L1 over the pixels whose residual is above the
    [HARD_P HW]-th largest, or whose uniform draw is above the
    [RANDOM_P HW]-th largest draw; the mean over every element."""
    b, _, h, w = x.shape
    with torch.no_grad():
        res = (x - y).abs().sum(dim=1).reshape(b, h * w)
        thre = torch.sort(res, dim=1, descending=True).values[:, int(HARD_P * h * w)]
        u_thre = torch.sort(u, dim=1, descending=True).values[:, int(RANDOM_P * h * w)]
        mask = ((res > thre[:, None]) | (u > u_thre[:, None])).to(x.dtype)
        mask = mask.reshape(b, 1, h, w)
    return (x * mask - y * mask).abs().mean()


def loss_fn(out: torch.Tensor, gt: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return (out - gt).abs().mean() + 2.0 * hem_loss(out, gt, u)


def forward(net: Net, p: Params, x: torch.Tensor, generator,
            has_sharp=None) -> torch.Tensor:
    """The model's training forward with its DropPath masks drawn first
    (per block, [2, batch of the Swin call]: every neighbour stream)."""
    b = x.shape[0]
    drops = net.draw_drops((net.cfg["n_sequence"] - 1) * b, generator,
                           generator.device if generator is not None else x.device)
    if net.cfg["model"].lower() == "swint":
        return net.swint_forward(p, x, True, drops)
    return net.speinet_train_forward(p, x, drops, has_sharp)


def train_steps(net: Net, p0: Params, batches: Sequence[tuple], seed: int,
                lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                loss=loss_fn) -> dict:
    """Steps on `batches` [(input [B, n + 2, 3, H, W], centre gt [B, 3, H,
    W]), ...] from the weights p0 with Adam, minimising `loss(out, gt, HEM's
    draw)`. Returns {"losses": [...], "gt1" and "u1": the first step's
    ground truth and HEM draw,
    "out1": the first step's restored frames, "grad1": {name: the first
    step's gradient}, "p_end": {name: the parameters after the last step}}. Parameters that get no gradient are
    left alone, as torch's Adam leaves them."""
    dev = next(iter(p0.values())).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = {k: v.detach().clone().requires_grad_(is_param(k) and v.is_floating_point())
              for k, v in p0.items()}
    m: Dict[str, torch.Tensor] = {}
    v: Dict[str, torch.Tensor] = {}
    losses: List[float] = []
    grad1 = {}
    out1 = u1 = None
    for t, (x, gt) in enumerate(batches, 1):
        out = forward(net, params, x, gen)
        if t == 1:
            out1 = out.detach().clone()
        b, _, h, w = out.shape
        u = torch.rand((b, h * w), generator=gen, device=dev)
        if t == 1:
            u1 = u
        loss_t = loss(out, gt, u)
        names = [k for k, p in params.items() if p.requires_grad]
        grads = torch.autograd.grad(loss_t, [params[k] for k in names], allow_unused=True)
        losses.append(float(loss_t.detach()))
        del out, loss_t
        with torch.no_grad():
            for k, g in zip(names, grads):
                if g is None:
                    continue
                if t == 1:
                    grad1[k] = g.clone()
                if k not in m:
                    m[k] = torch.zeros_like(g)
                    v[k] = torch.zeros_like(g)
                m[k].mul_(betas[0]).add_(g, alpha=1 - betas[0])
                v[k].mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
                c1, c2 = 1 - betas[0] ** t, 1 - betas[1] ** t
                denom = (v[k].sqrt() / c2 ** 0.5).add_(eps)
                params[k].addcdiv_(m[k], denom, value=-lr / c1)
        del grads
    return {"losses": losses, "out1": out1, "grad1": grad1, "gt1": batches[0][1], "u1": u1,
            "p_end": {k: p.detach() for k, p in params.items() if is_param(k)}}
