"""The Clos route-stage kernel: its CUDA build, binding, wrapper and
plain version.

``route_stage(x2d, idx2d, form, m)`` runs one stage of a Clos route over
``[T, 128]`` arrays with uint8 indices, in one of three forms (with
``T = B·m``):

- ``FORWARD``: ``out[b, j, r] = x[b, r, idx[b, r, j]]``, the gather
  inside each row followed by the ``(B, m, 128) → (B, 128, m)``
  transpose;
- ``MIDDLE``: ``out[t, j] = x[t, idx[t, j]]``, the gather alone
  (``lane_perm(x2d, idx2d)``);
- ``REVERSE``: ``out[b, r, l] = x[b, idx[b, r, l], r]`` over x viewed
  as ``(B, 128, m)``, the transpose back followed by the gather.

``x`` may also be a topic batch ``[K, T, 128]`` sharing one index array
(the reference ``vmap``s the sweep, giving its Pallas kernel a batch grid
axis): each form then applies to each of the K arrays, in one launch.

It replaces ``protocol_tpu/ops/clos.py::_lane_perm_pallas`` and the
transposes between its calls. The CUDA source is
``protocol_tpu_torch/csrc/lane_perm.cu`` (its header says what bounds it
and how it is laid out); it is compiled with ``nvcc`` for ``sm_90a``
into ``protocol_tpu_torch/build/`` at the first launch and bound with
ctypes.

A CPU tensor takes the plain version, ``torch.gather`` with the
reference's reshapes and transposes; a CUDA tensor launches the kernel
or raises. There is no fallback between the two.
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

FORWARD, MIDDLE, REVERSE = 0, 1, 2

# launches of the CUDA kernel (every form) since the last
# reset_launches(): the proof that a run went through the kernel and not
# the plain version
LAUNCHES = {"lane_perm": 0}

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def route_stage_plain(x2d: torch.Tensor, idx2d: torch.Tensor, form: int,
                      m: int = 1) -> torch.Tensor:
    """The plain PyTorch version of the kernel (CPU, and the kernel's
    yardstick on the card): ``torch.gather`` and the reference's
    reshapes and transposes, over ``[T, 128]`` or a ``[K, T, 128]``
    batch."""
    lead, T = x2d.shape[:-2], x2d.shape[-2]
    if form == REVERSE:
        x2d = x2d.view(lead + (T // m, LANES, m)).transpose(-1, -2) \
            .contiguous().view(lead + (T, LANES))
    y = torch.gather(x2d, -1, idx2d.long().expand_as(x2d))
    if form == FORWARD:
        y = y.view(lead + (T // m, m, LANES)).transpose(-1, -2) \
            .contiguous().view(lead + (T, LANES))
    return y


def lane_perm_plain(x2d: torch.Tensor, idx2d: torch.Tensor) -> torch.Tensor:
    """The middle form's plain version."""
    return route_stage_plain(x2d, idx2d, MIDDLE)


def _nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("lane_perm: nvcc not found (set CUDA_HOME)")
    return found


def build() -> Path:
    """Compile the kernel (no-op when built); returns the library path.
    ``build_log`` of it holds ptxas's registers and spills per form."""
    cmd = [_nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler",
           "-fPIC"]
    return build_shared_library("lane_perm", _SRC, cmd)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.route_stage.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            lib.route_stage.restype = ctypes.c_int
            lib.route_stage_error_string.argtypes = [ctypes.c_int]
            lib.route_stage_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    # the kernel moves 16-byte words; a fresh allocation always is aligned
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def route_stage(x2d: torch.Tensor, idx2d: torch.Tensor, form: int,
                m: int = 1) -> torch.Tensor:
    """One route stage in one launch (see the module's docstring).

    ``x2d`` is ``[T, 128]``, or a topic batch ``[K, T, 128]``, of
    float32, float64 or int32; ``idx2d`` is a uint8 ``[T, 128]`` array on
    the same device. ``m`` is the forward or reverse form's rows per
    subproblem, a power of two ≥ 2 that divides T; the middle form
    ignores it."""
    if x2d.dim() not in (2, 3) or x2d.shape[-1] != LANES:
        raise ValueError(f"route_stage: x must be [T, {LANES}] or "
                         f"[K, T, {LANES}], got {tuple(x2d.shape)}")
    if idx2d.shape != x2d.shape[-2:] or idx2d.dtype != torch.uint8:
        raise ValueError("route_stage: idx must be uint8 [T, 128] of x's T")
    if idx2d.device != x2d.device:
        raise ValueError("route_stage: x and idx on different devices")
    if form not in (FORWARD, MIDDLE, REVERSE):
        raise ValueError(f"route_stage: unknown form {form}")
    T = x2d.shape[-2]
    if form != MIDDLE and (m < 2 or m & (m - 1) or T % m):
        raise ValueError(f"route_stage: m = {m} must be a power of two "
                         f"≥ 2 dividing T = {T}")
    if x2d.device.type == "cpu":
        return route_stage_plain(x2d, idx2d, form, m)
    if x2d.device.type != "cuda":
        raise ValueError(f"route_stage: unsupported device {x2d.device}")
    if x2d.dtype not in _DTYPES:
        raise ValueError(f"route_stage: unsupported dtype {x2d.dtype}")
    batch = x2d.shape[0] if x2d.dim() == 3 else 1
    if batch > 65535:
        raise ValueError(f"route_stage: a batch of {batch} is past 65,535")
    x = _aligned(x2d)
    idx = _aligned(idx2d)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.route_stage(_DTYPES[x.dtype], form, x.data_ptr(),
                             idx.data_ptr(), out.data_ptr(), T,
                             m.bit_length() - 1, batch, stream)
    if rc != 0:
        raise RuntimeError(
            f"route_stage launch failed: "
            f"{lib.route_stage_error_string(rc).decode()}")
    LAUNCHES["lane_perm"] += 1
    return out


def lane_perm(x2d: torch.Tensor, idx2d: torch.Tensor) -> torch.Tensor:
    """The middle form: ``out[r, j] = x2d[r, idx2d[r, j]]``."""
    return route_stage(x2d, idx2d, MIDDLE)
