"""Richardson–Lucy edge branch (port of `speinet_tpu/ops/filters.py`).

Only the filters the cached-video path runs: `box_kernel`,
`box_blur_separable`, the Laplacian shift form and `richardson_lucy`
(reference `model/rcl.py:18-51`). NCHW tensors, as in the JAX module.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_LAPLACIAN_RL = ((0.0, -1.0, 0.0), (-1.0, 4.0, -1.0), (0.0, -1.0, 0.0))


def box_kernel(kernel_size: int = 5, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Normalized box blur kernel [k, k] (parity: rcl.py:18-20)."""
    k = torch.ones((kernel_size, kernel_size), dtype=dtype, device=device)
    return k / (kernel_size ** 2)


def depthwise_conv2d(x: torch.Tensor, kernel2d: torch.Tensor) -> torch.Tensor:
    """One odd 2-D kernel applied to every channel of [B, C, H, W], zero
    'SAME' padding."""
    c = x.shape[1]
    kh, kw = kernel2d.shape
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"odd kernel expected, got {tuple(kernel2d.shape)}")
    w = kernel2d.to(x.dtype).expand(c, 1, kh, kw)
    return F.conv2d(x, w, padding=(kh // 2, kw // 2), groups=c)


def box_blur_separable(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Uniform box blur as two 1-D window sums with zero 'SAME' padding:
    the same values as `depthwise_conv2d(x, box_kernel(k))`."""
    k = kernel_size
    p = k // 2
    h, w = x.shape[-2:]
    xp = F.pad(x, (p, p))
    y = xp[..., 0:w]
    for d in range(1, k):
        y = y + xp[..., d:d + w]
    yp = F.pad(y, (0, 0, p, p))
    z = yp[..., 0:h, :]
    for d in range(1, k):
        z = z + yp[..., d:d + h, :]
    return z / (k * k)


def _laplacian_rl_shift(x: torch.Tensor) -> torch.Tensor:
    """[[0,-1,0],[-1,4,-1],[0,-1,0]] with zero 'SAME' padding as four
    shifted adds."""
    xp = F.pad(x, (1, 1, 1, 1))
    return (4.0 * x - xp[:, :, :-2, 1:-1] - xp[:, :, 2:, 1:-1]
            - xp[:, :, 1:-1, :-2] - xp[:, :, 1:-1, 2:])


def richardson_lucy(image: torch.Tensor, kernel2d: torch.Tensor,
                    num_iterations: int = 1,
                    regularization_strength: float = 0.01,
                    box_size: int | None = None) -> torch.Tensor:
    """Laplacian-regularized Richardson–Lucy iterations (rcl.py:22-51):

        blurred   = conv(deblurred, kernel)
        ratio     = image / blurred, NaN -> 0 and negatives -> 0 (+-inf stay)
        deblurred = ratio * (deblurred + lam * laplacian(deblurred))

    image: [B, C, H, W]. With `box_size` the kernel is declared to be
    `box_kernel(box_size)` and the blur runs separably (same values)."""
    # the box path needs no kernel tensor (a copy from the host would
    # synchronise the stream)
    lap = (None if box_size is not None else
           torch.tensor(_LAPLACIAN_RL, dtype=image.dtype, device=image.device))
    out = image
    for _ in range(num_iterations):
        if box_size is not None:
            blurred = box_blur_separable(out, box_size)
            lap_out = _laplacian_rl_shift(out)
        else:
            blurred = depthwise_conv2d(out, kernel2d)
            lap_out = depthwise_conv2d(out, lap)
        ratio = image / blurred
        ratio = torch.where(torch.isnan(ratio), torch.zeros_like(ratio), ratio)
        ratio = torch.where(ratio < 0, torch.zeros_like(ratio), ratio)
        out = ratio * (out + regularization_strength * lap_out)
    return out
