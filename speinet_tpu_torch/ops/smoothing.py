"""Classical smoothing and deconvolution (port of
`speinet_tpu/ops/smoothing.py`; parity: the reference's filter utilities in
model/rcl.py, which the model does not run):

- `l0_smoothing`: FFT-based L0 gradient minimization (rcl.py:109-225);
- `ftvd`: TV / L2 deconvolution by alternating directions (rcl.py:529-711);
- `rl_deconv`: plain multi-iteration Richardson-Lucy (rcl.py:462-523);
- `rtv_smooth`: relative-total-variation smoothing (rcl.py:238-399), a
  host scipy sparse solve as in the JAX package (the reference uses MKL's
  pardiso).

The FFT methods run with `torch.fft` on the tensor's device; the JAX
module's `_psf2otf` is `ops/filters.py::psf2otf`, which `wiener_deconv`
shares. Images are [H, W, C] (or [H, W] for `ftvd`, [B, C, H, W] for
`rl_deconv`) floats in [0, 1].
"""

from __future__ import annotations

import numpy as np
import torch

from speinet_tpu_torch.ops.filters import depthwise_conv2d, psf2otf


def _difference_otfs(like: torch.Tensor, shape):
    """The transfer functions of the forward differences along W and H."""
    dx = torch.tensor([[1.0, -1.0]], dtype=like.dtype, device=like.device)
    return psf2otf(dx, shape), psf2otf(dx.T, shape)


def l0_smoothing(img: torch.Tensor, lam: float = 2e-2, kappa: float = 2.0,
                 beta_max: float = 1e5) -> torch.Tensor:
    """L0 gradient minimization (Xu et al.) of img [H, W, C]: a hard
    threshold on the gradients alternates with an FFT quadratic solve, beta
    growing by `kappa` each iteration (semantics of rcl.py:109-225)."""
    hh, ww, _ = img.shape
    fx, fy = _difference_otfs(img, (hh, ww))
    denom_grad = (fx.abs() ** 2 + fy.abs() ** 2)[..., None]
    normin1 = torch.fft.fft2(img, dim=(0, 1))
    n_iter = int(np.ceil(np.log(beta_max / (2 * lam)) / np.log(kappa))) + 1
    s = img
    beta = 2 * lam
    for _ in range(n_iter):
        gx = torch.roll(s, -1, dims=1) - s
        gy = torch.roll(s, -1, dims=0) - s
        keep = (gx ** 2 + gy ** 2).sum(dim=2, keepdim=True) >= lam / beta
        gx = torch.where(keep, gx, 0.0)
        gy = torch.where(keep, gy, 0.0)
        div = (torch.roll(gx, 1, dims=1) - gx) + (torch.roll(gy, 1, dims=0) - gy)
        num = normin1 + beta * torch.fft.fft2(div, dim=(0, 1))
        s = torch.fft.ifft2(num / (1.0 + beta * denom_grad), dim=(0, 1)).real
        beta *= kappa
        if beta > beta_max:
            break
    return s


def ftvd(blurred: torch.Tensor, psf: torch.Tensor, mu: float = 500.0,
         beta: float = 10.0, n_iter: int = 20) -> torch.Tensor:
    """TV / L2 deconvolution (FTVd, rcl.py:529-711) of blurred [H, W] or
    [H, W, C] by psf [kh, kw]: min_u TV(u) + mu / 2 ||K u - f||^2 by
    gradient splitting, isotropic shrinkage and an FFT solve."""
    squeeze = blurred.ndim == 2
    f = blurred[..., None] if squeeze else blurred
    hh, ww, _ = f.shape
    otf = psf2otf(psf.to(f.dtype), (hh, ww))[..., None]
    fx, fy = _difference_otfs(f, (hh, ww))
    ktf = torch.conj(otf) * torch.fft.fft2(f, dim=(0, 1))
    denom = otf.abs() ** 2 + (beta / mu) * (fx.abs() ** 2 + fy.abs() ** 2)[..., None]
    u = f
    for _ in range(n_iter):
        ux = torch.roll(u, -1, dims=1) - u
        uy = torch.roll(u, -1, dims=0) - u
        mag = torch.sqrt(ux ** 2 + uy ** 2)
        shrink = torch.clamp(mag - 1.0 / beta, min=0.0) / torch.clamp(mag, min=1e-12)
        wx, wy = ux * shrink, uy * shrink
        div = (torch.roll(wx, 1, dims=1) - wx) + (torch.roll(wy, 1, dims=0) - wy)
        rhs = ktf + (beta / mu) * torch.fft.fft2(div, dim=(0, 1))
        u = torch.fft.ifft2(rhs / denom, dim=(0, 1)).real
    return u[..., 0] if squeeze else u


def rl_deconv(image: torch.Tensor, psf: torch.Tensor, n_iter: int = 10) -> torch.Tensor:
    """Richardson-Lucy with the flipped-kernel correction (rcl.py:462-523
    RL_Deconv) of image [B, C, H, W] by psf [kh, kw], from a flat 0.5."""
    est = torch.full_like(image, 0.5)
    psf_flip = psf.flip(0, 1)
    for _ in range(n_iter):
        ratio = image / torch.clamp(depthwise_conv2d(est, psf), min=1e-12)
        est = est * depthwise_conv2d(ratio, psf_flip)
    return est


def rtv_smooth(img: np.ndarray, lam: float = 0.01, sigma: float = 3.0,
               sharpness: float = 0.02, n_iter: int = 4) -> np.ndarray:
    """Relative total variation smoothing (Xu et al. 2012; semantics of
    rcl.py:238-399 `tsmooth`) of img [H, W, C] in [0, 1], float64 on the
    host: per iteration, texture weights from Gaussian-filtered gradients,
    then one sparse 5-point solve per channel."""
    from scipy.ndimage import gaussian_filter1d
    from scipy.sparse import csr_matrix, spdiags
    from scipy.sparse.linalg import spsolve

    x = np.asarray(img, np.float64)
    h, w, c = x.shape
    n = h * w
    lp_filter = lambda v, axis: gaussian_filter1d(v, sigma, axis=axis, mode="nearest")
    for _ in range(n_iter):
        fx = np.concatenate([np.diff(x, axis=1), x[:, :1] - x[:, -1:]], axis=1)
        fy = np.concatenate([np.diff(x, axis=0), x[:1] - x[-1:]], axis=0)
        wto = np.maximum(np.sqrt(lp_filter(fx, 1).mean(2) ** 2
                                 + lp_filter(fy, 0).mean(2) ** 2), sharpness) ** -1
        wtbx = np.maximum(np.abs(lp_filter(fx.mean(2), 1)), 1e-3) ** -1
        wtby = np.maximum(np.abs(lp_filter(fy.mean(2), 0)), 1e-3) ** -1
        dx = lam * (wtbx * wto).reshape(-1)
        dy = lam * (wtby * wto).reshape(-1)
        d = 1 + dx + dy + np.roll(dx, w) + np.roll(dy, 1)
        a = spdiags(np.vstack([-dx, -dy]), [-w, -1], n, n)
        mat = csr_matrix(a + a.T + spdiags(d, 0, n, n))
        out = np.empty_like(x)
        for ci in range(c):
            out[..., ci] = spsolve(mat, x[..., ci].reshape(-1)).reshape(h, w)
        x = out
    return x
