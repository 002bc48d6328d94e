"""The lane-permutation kernel: its CUDA build, binding, wrapper and
plain version.

``lane_perm(x2d, idx2d)`` computes ``out[r, j] = x2d[r, idx2d[r, j]]``
over ``[T, 128]`` arrays with uint8 indices: one stage of a Clos route.
It replaces ``protocol_tpu/ops/clos.py::_lane_perm_pallas``. The CUDA
source is ``protocol_tpu_torch/csrc/lane_perm.cu`` (its header says
what bounds it and how it is laid out); it is compiled with ``nvcc`` for
``sm_90a`` into ``protocol_tpu_torch/build/`` at the first launch and
bound with ctypes.

A CPU tensor takes the plain version, ``torch.gather``; a CUDA tensor
launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from pathlib import Path

import torch

from ..._build import build_shared_library

LANES = 128

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "lane_perm.cu"
_DTYPES = {torch.float32: 0, torch.float64: 1, torch.int32: 2}

# launches of the CUDA kernel since the last reset_launches(): the proof
# that a run went through the kernel and not the plain version
LAUNCHES = {"lane_perm": 0}

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def lane_perm_plain(x2d: torch.Tensor, idx2d: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel (CPU tests, and the
    kernel's yardstick on the card)."""
    return torch.gather(x2d, 1, idx2d.long())


def _nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("lane_perm: nvcc not found (set CUDA_HOME)")
    return found


def build() -> Path:
    """Compile the kernel (no-op when built); returns the library path."""
    cmd = [_nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
    return build_shared_library("lane_perm", _SRC, cmd)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.lane_perm.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int64, ctypes.c_void_p]
            lib.lane_perm.restype = ctypes.c_int
            lib.lane_perm_error_string.argtypes = [ctypes.c_int]
            lib.lane_perm_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    # the kernel moves 16-byte words; a fresh allocation always is aligned
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def lane_perm(x2d: torch.Tensor, idx2d: torch.Tensor) -> torch.Tensor:
    """One routing stage: ``out[r, j] = x2d[r, idx2d[r, j]]``.

    ``x2d`` is ``[T, 128]`` float32, float64 or int32; ``idx2d`` is a
    uint8 array of the same shape on the same device."""
    if x2d.dim() != 2 or x2d.shape[1] != LANES:
        raise ValueError(f"lane_perm: x must be [T, {LANES}], got "
                         f"{tuple(x2d.shape)}")
    if idx2d.shape != x2d.shape or idx2d.dtype != torch.uint8:
        raise ValueError("lane_perm: idx must be uint8 of x's shape")
    if idx2d.device != x2d.device:
        raise ValueError("lane_perm: x and idx on different devices")
    if x2d.device.type == "cpu":
        return lane_perm_plain(x2d, idx2d)
    if x2d.device.type != "cuda":
        raise ValueError(f"lane_perm: unsupported device {x2d.device}")
    if x2d.dtype not in _DTYPES:
        raise ValueError(f"lane_perm: unsupported dtype {x2d.dtype}")
    x = _aligned(x2d)
    idx = _aligned(idx2d)
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.lane_perm(_DTYPES[x.dtype], x.data_ptr(), idx.data_ptr(),
                           out.data_ptr(), x.shape[0], stream)
    if rc != 0:
        raise RuntimeError(
            f"lane_perm launch failed: "
            f"{lib.lane_perm_error_string(rc).decode()}")
    LAUNCHES["lane_perm"] += 1
    return out
