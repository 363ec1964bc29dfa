"""K10 wrapper: batched row gather (`csrc/row_gather.cu`).

Replaces `speinet_tpu/ops/pallas_gather.py::row_gather`, the drop-in for
the `take_along_axis` of the texture transfer's gather-fold; here it does
the row gather of `ops/patch_ops.py::gather_fold3_nhwc`. The output is an
exact copy. A CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from speinet_tpu_torch.kernels import _lib


def row_gather_plain(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows[b, idx[b, l]] by advanced indexing."""
    bidx = torch.arange(rows.shape[0], device=rows.device)[:, None]
    return rows[bidx, idx]


def _launch(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    dev = rows.device
    _lib.require_cuda_tensor(rows, "rows", torch.bfloat16, dev)
    _lib.require_cuda_tensor(idx, "idx", idx.dtype, dev)
    b, t, r = rows.shape
    l = idx.shape[1]
    if r % 8 or rows.data_ptr() % 16 or max(t, l) >= 2 ** 31:
        raise ValueError(f"row_gather kernel takes 16-byte aligned rows of a "
                         f"multiple of 8 bf16 and T, L < 2^31; got R {r}, T {t}, "
                         f"L {l}")
    out = torch.empty((b, l, r), dtype=rows.dtype, device=dev)
    lib = _lib.library()
    _lib.check(lib.speinet_row_gather(rows.data_ptr(), idx.data_ptr(),
                                      out.data_ptr(), b, t, r, l,
                                      idx.element_size(), _lib.stream_ptr(rows)),
               "row_gather")
    _lib.LAUNCHES["row_gather"] += 1
    return out


def row_scatter_add(g: torch.Tensor, idx: torch.Tensor, t: int) -> torch.Tensor:
    """The gather's VJP: d[b, idx[b, l]] += g[b, l] into zeros [B, T, R],
    summed in float32 and cast to g's dtype."""
    b, l, r = g.shape
    flat = (idx.long() + torch.arange(b, device=idx.device)[:, None] * t).reshape(-1)
    d = torch.zeros((b * t, r), dtype=torch.float32, device=g.device)
    d.index_add_(0, flat, g.reshape(b * l, r).float())
    return d.view(b, t, r).to(g.dtype)


class RowGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, idx):
        ctx.save_for_backward(idx)
        ctx.t = rows.shape[1]
        if rows.device.type == "cpu":
            return row_gather_plain(rows, idx)
        return _launch(rows, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return row_scatter_add(g, idx, ctx.t), None


def row_gather(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows [B, T, R], idx [B, L] int64 or int32 in [0, T) -> [B, L, R] with
    out[b, l] = rows[b, idx[b, l]]. Index values are not checked (that would
    cost a sync): the caller builds them in range."""
    if rows.ndim != 3 or idx.ndim != 2 or idx.shape[0] != rows.shape[0]:
        raise ValueError(f"row_gather takes rows [B, T, R] and idx [B, L], got "
                         f"{tuple(rows.shape)} and {tuple(idx.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"row_gather: idx has dtype {idx.dtype}, not int32 / int64")
    if not (rows.is_contiguous() and idx.is_contiguous()):
        raise ValueError("row_gather: rows and idx must be contiguous")
    _lib.dispatch_device(rows, "row_gather")
    return RowGather.apply(rows, idx)
