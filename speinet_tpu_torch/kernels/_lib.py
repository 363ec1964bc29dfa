"""Build, load and count the hand-written Hopper kernels.

All sources under `speinet_tpu_torch/csrc/` are compiled by `nvcc` for
`sm_90a` into one shared library with a plain C interface, bound with
`ctypes`. The build runs at the first kernel launch of a process (never at
import: the CPU tests import every module), one `nvcc` per source, all
started together, into `speinet_tpu_torch/build/`, which `.gitignore`
lists. The library's file name carries a hash of the sources, headers and
flags, so an edited source is rebuilt and an unchanged one is reused.

Every exported C function launches on the stream it is given and returns
`cudaGetLastError()`; `check` turns a non-zero code into an exception.
`LAUNCHES` counts, per kernel, the launches its wrapper made;
`BACKWARD_LAUNCHES` counts those of them made in a backward pass.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
SOURCES = ("conv.cu", "swin_block.cu", "roll.cu", "corr_banded.cu",
           "corr_unfold.cu", "row_gather.cu", "swin_attn.cu", "swin_mlp.cu")
HEADERS = ("tensor_core.cuh", "swin_wgmma.cuh", "hopper.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo")

# launches per kernel wrapper since the last reset_launches()
LAUNCHES = {"conv2d": 0, "swin_block": 0, "roll2d": 0, "banded_corr_argmax": 0,
            "correlation_argmax_lds": 0, "correlation_argmax_ld": 0,
            "correlation_argmax": 0, "window_cross_attention": 0, "ln_mlp": 0,
            "row_gather": 0}
# of those, the launches made by a backward pass (K3's VJP is K3 itself)
BACKWARD_LAUNCHES = {"roll2d": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# argument types of every exported function, by name
SIGNATURES = {
    "speinet_conv2d": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "speinet_conv2d_fits": [_I, _I, _I, _I],
    "speinet_swin_block": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _F, _P],
    "speinet_roll2d": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    "speinet_banded_corr": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "speinet_corr_unfold": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "speinet_corr_rows": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "speinet_swin_attn": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                          _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "speinet_swin_mlp": [_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _P],
    "speinet_row_gather": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_lib = None


def reset_launches() -> None:
    for counts in (LAUNCHES, BACKWARD_LAUNCHES):
        for k in counts:
            counts[k] = 0


def refuse_grad(what: str, *tensors) -> None:
    """Raise where autograd would need a backward this kernel does not have:
    its launch returns tensors without a gradient function, so a gradient
    would stop there without a word."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} has no backward: call it under "
                           f"torch.no_grad() or on tensors that need no gradient")


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if not yet built for these sources); return the
    shared library's path."""
    so = BUILD / f"libspeinet_kernels_{_build_key()}.so"
    if so.exists():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            objs.append(str(obj))
            procs.append((name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC / name),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        errors, logs = [], []
        for name, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {name}\n{out}")
            if p.returncode != 0:
                errors.append(f"nvcc {name} (exit {p.returncode}):\n{out}")
        if errors:
            raise RuntimeError("kernel build failed\n" + "\n".join(errors))
        # ptxas' register / shared-memory / spill report of every kernel
        (BUILD / f"ptxas_{so.stem}.log").write_text("\n".join(logs))
        tmp_so = Path(tmp) / so.name
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o",
                               str(tmp_so)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"kernel link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_so, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.speinet_error_string.argtypes = [ctypes.c_int]
        lib.speinet_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    if code != 0:
        msg = library().speinet_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                        device: torch.device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor on `device`."""
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dispatch_device(t: torch.Tensor, what: str) -> str:
    """'cpu' or 'cuda' from the tensor's device alone; anything else raises."""
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"{what}: no kernel and no plain version for device "
                     f"{t.device}")
