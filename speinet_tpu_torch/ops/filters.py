"""Classical filters (port of `speinet_tpu/ops/filters.py`; parity: the
reference's filter library model/rcl.py). NCHW tensors, as in the JAX
module, computed on the tensor's device.

- `box_kernel`, `box_blur_separable`, the Laplacian shift form and
  `richardson_lucy`: the edge-information branch the model runs
  (rcl.py:18-51);
- `sobel_magnitude` (rcl.py:54-72), `laplacian_filter` (rcl.py:76-104),
  `mean_filter` (util/utils.py:116-123) and `wiener_deconv`
  (rcl.py:405-454): utility filters the model does not run;
- `psf2otf`: a PSF's transfer function, which `wiener_deconv` and the FFT
  solvers of `ops/smoothing.py` share.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_LAPLACIAN_RL = ((0.0, -1.0, 0.0), (-1.0, 4.0, -1.0), (0.0, -1.0, 0.0))
_LAPLACIAN_8 = ((1.0, 1.0, 1.0), (1.0, -8.0, 1.0), (1.0, 1.0, 1.0))
_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SOBEL_Y = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))


def box_kernel(kernel_size: int = 5, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Normalized box blur kernel [k, k] (parity: rcl.py:18-20)."""
    k = torch.ones((kernel_size, kernel_size), dtype=dtype, device=device)
    return k / (kernel_size ** 2)


def depthwise_conv2d(x: torch.Tensor, kernel2d: torch.Tensor) -> torch.Tensor:
    """One 2-D kernel applied to every channel of [B, C, H, W] with zero
    'SAME' padding (XLA's: an even kernel pads one more after than before)."""
    c = x.shape[1]
    kh, kw = kernel2d.shape
    w = kernel2d.to(x.dtype).expand(c, 1, kh, kw)
    if kh % 2 and kw % 2:
        return F.conv2d(x, w, padding=(kh // 2, kw // 2), groups=c)
    xp = F.pad(x, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    return F.conv2d(xp, w, groups=c)


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


def _kernel(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def sobel_magnitude(x: torch.Tensor) -> torch.Tensor:
    """Per-channel Sobel gradient magnitude (parity: rcl.py:54-72)."""
    gx = depthwise_conv2d(x, _kernel(_SOBEL_X, x))
    gy = depthwise_conv2d(x, _kernel(_SOBEL_Y, x))
    return torch.sqrt(gx ** 2 + gy ** 2)


def laplacian_filter(x: torch.Tensor) -> torch.Tensor:
    """8-neighbour Laplacian (parity: rcl.py:76-104)."""
    return depthwise_conv2d(x, _kernel(_LAPLACIAN_8, x))


def mean_filter(x: torch.Tensor, kernel_size: int = 11) -> torch.Tensor:
    """Box mean filter (parity: util/utils.py:116-123)."""
    return depthwise_conv2d(x, box_kernel(kernel_size, x.dtype, x.device))


def psf2otf(psf: torch.Tensor, shape) -> torch.Tensor:
    """The transfer function of `psf` [kh, kw] on an [H, W] grid: the PSF
    zero-padded to `shape`, its centre rolled to the origin, then FFT'd
    (complex, on the PSF's device)."""
    kh, kw = psf.shape
    pad = torch.zeros(tuple(shape), dtype=psf.dtype, device=psf.device)
    pad[:kh, :kw] = psf
    return torch.fft.fft2(torch.roll(pad, (-(kh // 2), -(kw // 2)), dims=(0, 1)))


def wiener_deconv(image: torch.Tensor, kernel2d: torch.Tensor,
                  snr: float = 0.01) -> torch.Tensor:
    """FFT Wiener deconvolution per channel (parity: rcl.py:405-454) of
    image [B, C, H, W] by the PSF kernel2d [kh, kw], centred at the origin
    (circular boundary); in the image's dtype."""
    h = psf2otf(kernel2d.to(image.dtype), image.shape[-2:])
    g = torch.conj(h) / (h.abs() ** 2 + snr)
    return torch.fft.ifft2(torch.fft.fft2(image) * g).real.to(image.dtype)
