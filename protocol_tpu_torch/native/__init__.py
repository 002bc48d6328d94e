"""ctypes binding for the port's C++ Clos planner (``csrc/clos_plan.cpp``).

The source is the reference's planner, copied; it is compiled with g++
into ``protocol_tpu_torch/build/`` the first time a plan is asked for.
Like the reference binding, everything degrades to the pure-Python
planner: ``available()`` is False when no compiler exists or the build
fails, and ``clos_plan``/``clos_apply_route`` then return None.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path

import numpy as np

from .._build import build_shared_library

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "clos_plan.cpp"
_CMD = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        "-pthread", "-w"]

_lock = threading.Lock()
_lib = None
_build_failed = False


def build() -> Path:
    """Compile the planner (no-op when built); returns the library path.
    Raises when no build succeeds."""
    try:
        return build_shared_library("clos_plan", _SRC, _CMD)
    except RuntimeError:
        # toolchains without -march=native: retry portable rather than
        # losing the native planner
        return build_shared_library(
            "clos_plan", _SRC, [a for a in _CMD if a != "-march=native"])


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError, subprocess.TimeoutExpired):
            _build_failed = True
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.clos_plan.argtypes = [i32p, ctypes.c_int64, i32p,
                                  ctypes.c_int32, u8p]
        lib.clos_plan.restype = ctypes.c_int
        lib.clos_apply_route.argtypes = [u8p, ctypes.c_int64, i32p,
                                         ctypes.c_int32, i32p, i32p]
        lib.clos_apply_route.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def clos_plan(perm: np.ndarray, bits) -> np.ndarray | None:
    """Plan the route of ``perm`` (int32, power-of-two length ≥ 128):
    flat uint8 stage array of shape ((2·len(bits)−1)·E,). None when the
    library is unavailable; raises on invalid input."""
    lib = _load()
    if lib is None:
        return None
    perm = np.ascontiguousarray(perm, dtype=np.int32)
    bits_arr = np.ascontiguousarray(bits, dtype=np.int32)
    E = len(perm)
    out = np.empty((2 * len(bits_arr) - 1) * E, dtype=np.uint8)
    rc = lib.clos_plan(
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), E,
        bits_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(bits_arr),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc == 1:
        raise ValueError("clos_plan: input is not a permutation")
    if rc != 0:
        raise ValueError("clos_plan: invalid length or level bits")
    return out


def clos_apply_route(stages, bits, x: np.ndarray) -> np.ndarray | None:
    """Replay a finished plan on int32 data (the numpy twin is
    ``ops.clos.apply_route_np``): the plan validation's fast path.
    ``stages`` is the per-stage list or the flat uint8 array. None when
    the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    if isinstance(stages, (list, tuple)):
        views = [np.asarray(s) for s in stages]
        base = views[0].base if views else None
        if (base is not None and base.dtype == np.uint8
                and all(v.base is base and v.dtype == np.uint8
                        for v in views)
                and all(v.ctypes.data == base.ctypes.data
                        + sum(len(u) for u in views[:i])
                        for i, v in enumerate(views))
                and sum(len(v) for v in views) == len(base)):
            # native plans are adjacent views of ONE flat buffer: replay
            # through it without a concatenated copy
            stages = base
        else:
            stages = np.concatenate([np.asarray(s, dtype=np.uint8)
                                     for s in views])
    stages = np.ascontiguousarray(stages, dtype=np.uint8)
    bits_arr = np.ascontiguousarray(bits, dtype=np.int32)
    out = np.ascontiguousarray(x, dtype=np.int32).copy()
    tmp = np.empty_like(out)
    rc = lib.clos_apply_route(
        stages.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(out),
        bits_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(bits_arr),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        tmp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise ValueError("clos_apply_route: invalid length or bits")
    return out
