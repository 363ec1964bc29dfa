"""The precisions of the check: float32 with TF32 off for the reference,
and float8 e4m3 operands with a per-tensor scale for its control."""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0   # largest finite float8 e4m3fn value


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 after scaling its largest magnitude to the
    format's largest value, and scaled back, in t's dtype."""
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


@contextlib.contextmanager
def strict_float32():
    """Matmuls and convolutions in true float32 (no TF32) inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])
