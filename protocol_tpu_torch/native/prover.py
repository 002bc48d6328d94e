"""ctypes binding for the port's C++ prover core (``csrc/prover_native.cpp``).

The source is the reference's prover core (``native/protocol_native.cpp``,
its prover entry points), copied: Montgomery field kernels, NTT, Pippenger
MSM, PLONK grand products and the quotient kernel. It is compiled with g++
into ``protocol_tpu_torch/build/`` at first use (``_build``), as a second
library beside the Clos planner's; the Python surface is the reference
binding's (``protocol_tpu/native/__init__.py``): ``FieldKernel``,
``g1_msm``, ``g1_msm_multi``, ``g1_fixed_base_muls``, ``ints_to_limbs``,
``limbs_to_ints``, ``points_to_limbs`` and ``apply_msm_tuning``.
``available()`` is False when no compiler exists or the build fails.

Data layout at the boundary: little-endian 4×uint64 limb arrays
(numpy, shape (n, 4), standard — not Montgomery — form).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from .._build import build_shared_library

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "prover_native.cpp"
_CMD = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        "-pthread", "-w"]

_lock = threading.Lock()
_lib = None
_build_failed = False


def build() -> Path:
    """Compile the prover core (no-op when built); returns the library
    path. Raises when no build succeeds."""
    try:
        return build_shared_library("prover_native", _SRC, _CMD)
    except RuntimeError:
        # toolchains without -march=native: retry portable rather than
        # losing the native prover
        return build_shared_library(
            "prover_native", _SRC, [a for a in _CMD if a != "-march=native"])


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
        _bind(lib, ctypes.POINTER(ctypes.c_uint64))
        # per-box MSM window tune: env writes happen HERE, under the
        # loader lock, before any caller can be inside a native getenv
        _apply_msm_tuning_locked()
        _lib = lib
        return _lib


def _bind(lib, u64p) -> None:
    lib.fr_vec_op.argtypes = [u64p, ctypes.c_int, u64p, u64p, u64p,
                              ctypes.c_long]
    lib.ntt.argtypes = [u64p, u64p, ctypes.c_long, u64p, ctypes.c_int]
    lib.coset_scale.argtypes = [u64p, u64p, ctypes.c_long, u64p,
                                ctypes.c_int]
    lib.poly_eval_many.argtypes = [u64p, u64p, ctypes.c_long,
                                   ctypes.c_long, u64p, u64p]
    lib.batch_inverse.argtypes = [u64p, u64p, ctypes.c_long]
    lib.g1_msm.argtypes = [u64p, u64p, u64p, ctypes.c_long, u64p]
    lib.g1_msm_multi.argtypes = [u64p, u64p, u64p,
                                 ctypes.POINTER(ctypes.c_uint8),
                                 ctypes.c_long, ctypes.c_long, u64p]
    lib.perm_grand_product.argtypes = [u64p, u64p, ctypes.c_int, u64p,
                                       u64p, u64p, u64p, u64p,
                                       ctypes.c_long, u64p]
    lib.perm_grand_product.restype = ctypes.c_int
    lib.logup_running_sum.argtypes = [u64p, u64p, u64p, u64p, u64p,
                                      ctypes.c_long, u64p]
    lib.logup_running_sum.restype = ctypes.c_int
    lib.quotient_eval2.argtypes = [u64p] + [u64p] * 13 + [u64p] * 5 \
        + [ctypes.c_long, u64p]
    lib.fr_vec_scalar_op.argtypes = [u64p, ctypes.c_int, u64p, u64p,
                                     u64p, ctypes.c_long]
    lib.fr_poly_divide_linear.argtypes = [u64p, u64p, ctypes.c_long,
                                          u64p, u64p]
    lib.g1_fixed_base_muls.argtypes = [u64p, u64p, u64p, ctypes.c_long,
                                       u64p]


def available() -> bool:
    return _load() is not None


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _require_inplace(arr: np.ndarray) -> np.ndarray:
    """Kernels that mutate their argument must see the caller's real
    buffer — a silent ``ascontiguousarray`` copy would leave the
    caller's array untransformed."""
    if not arr.flags["C_CONTIGUOUS"] or arr.dtype != np.uint64:
        raise ValueError(
            "in-place kernel requires a C-contiguous uint64 array")
    return arr


# --- conversions -----------------------------------------------------------

def ints_to_limbs(values) -> np.ndarray:
    """Python ints (each < 2^256) → (n, 4) uint64 array."""
    blob = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(blob, dtype="<u8").reshape(-1, 4).copy()


def limbs_to_ints(arr: np.ndarray) -> list:
    data = np.ascontiguousarray(arr, dtype="<u8").tobytes()
    return [int.from_bytes(data[i * 32 : (i + 1) * 32], "little")
            for i in range(len(data) // 32)]


def _scalar(v: int) -> np.ndarray:
    return ints_to_limbs([v])


# --- per-box MSM window tune ----------------------------------------------

_tune_applied = False


def apply_msm_tuning() -> int | None:
    """One-time application of the cached per-box Pippenger window size
    (``<assets>/msm_tune.json``, written by ``tools/probe_msm_prims.py
    --tune`` — the r4 manual c=16→15 retune, mechanized). An explicit
    ``PN_MSM_C`` env always wins; without a cache file the kernel's
    built-in ladder stands. Applied automatically when the library
    first LOADS, inside the loader lock — mutating ``os.environ``
    while another thread sits in native ``getenv`` (pool workers run
    MSMs concurrently with the GIL released) is undefined behavior in
    glibc, so the env writes must land before any native call can be
    in flight. Returns the applied c, if any.

    The assets dir resolves like ``cli.fs.assets_dir``'s env tier:
    ``EIGEN_ASSETS`` or ``./assets`` (a ``--assets`` CLI flag exports
    the env before proving starts)."""
    with _lock:
        return _apply_msm_tuning_locked()


def _apply_msm_tuning_locked() -> int | None:
    global _tune_applied
    if _tune_applied:
        return None
    _tune_applied = True
    if os.environ.get("PN_MSM_C") or os.environ.get("PN_MSM_C_MULTI"):
        return None  # explicit override preserved
    path = Path(os.environ.get("EIGEN_ASSETS", "assets")) / "msm_tune.json"
    try:
        data = json.loads(path.read_text())
        c = int(data["c"])
    except (OSError, ValueError, KeyError, TypeError):
        return None
    applied = None
    if 2 <= c <= 20:
        os.environ["PN_MSM_C"] = str(c)
        applied = c
    # the multi kernel's optimum can sit one window size up (its
    # vector reduce repriced the bucket count — see g1_msm_multi)
    try:
        cm = int(data.get("c_multi", 0))
    except (ValueError, TypeError):
        cm = 0
    if 2 <= cm <= 20:
        os.environ["PN_MSM_C_MULTI"] = str(cm)
    return applied


# --- MSMs over row ranges on all cores -------------------------------------
# An MSM is a sum over rows, so Σ_i s_i·B_i splits into contiguous row
# ranges whose partial sums add up to the same group element: each range
# runs the single-core Pippenger kernel on its own thread (the ctypes
# call releases the GIL) and the few partial points are added on the
# host. The affine result, and so every commitment byte, is the one the
# unsplit call gives. One range a core this process may run on, none
# below MSM_SPLIT_MIN_ROWS rows, so small MSMs stay on one core.

MSM_SPLIT_MIN_ROWS = 1 << 16
_POOL = None
_POOL_LOCK = threading.Lock()


def msm_threads() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def _row_ranges(n: int) -> list:
    parts = min(msm_threads(), n // MSM_SPLIT_MIN_ROWS)
    if parts <= 1:
        return [(0, n)]
    return [(n * i // parts, n * (i + 1) // parts) for i in range(parts)]


def _map_ranges(fn, n: int) -> list:
    """``fn(a, b)`` over ``_row_ranges(n)``, on the pool when split."""
    ranges = _row_ranges(n)
    if len(ranges) == 1:
        return [fn(*ranges[0])]
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            from concurrent.futures import ThreadPoolExecutor

            _POOL = ThreadPoolExecutor(max_workers=msm_threads(),
                                       thread_name_prefix="pn-msm")
    return [f.result() for f in [_POOL.submit(fn, a, b) for a, b in ranges]]


def _affine_add(p1, p2, modulus: int):
    """Affine sum on y² = x³ + b over GF(modulus); None is the identity."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    (x1, y1), (x2, y2) = p1, p2
    if x1 == x2:
        if (y1 + y2) % modulus == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, modulus) % modulus
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, modulus) % modulus
    x3 = (lam * lam - x1 - x2) % modulus
    return (x3, (lam * (x1 - x3) - y1) % modulus)


def _sum_points(parts: list, modulus: int):
    total = None
    for pt in parts:
        total = _affine_add(total, pt, modulus)
    return total


def g1_msm(base_modulus: int, bases: np.ndarray, scalars: np.ndarray):
    """Pippenger MSM. Point arithmetic runs over the curve's BASE field
    (``base_modulus`` — Fq for BN254 G1); scalars are plain 256-bit
    integers. bases: (n, 8) affine standard form (zeros = identity);
    scalars: (n, 4). Returns an affine (x, y) tuple or None. Large MSMs
    run over row ranges on all cores (see ``_row_ranges``)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    bases = np.ascontiguousarray(bases)
    scalars = np.ascontiguousarray(scalars)
    parts = _map_ranges(lambda a, b: _g1_msm_one(
        lib, base_modulus, bases[a:b], scalars[a:b]), len(bases))
    return _sum_points(parts, base_modulus)


def _g1_msm_one(lib, base_modulus: int, bases: np.ndarray,
                scalars: np.ndarray):
    out = np.empty(8, dtype="<u8")
    lib.g1_msm(_ptr(_scalar(base_modulus)), _ptr(bases), _ptr(scalars),
               len(bases), _ptr(out))
    vals = limbs_to_ints(out.reshape(2, 4))
    if vals[0] == 0 and vals[1] == 0:
        return None
    return (vals[0], vals[1])


def g1_msm_multi(base_modulus: int, bases: np.ndarray,
                 scalars: np.ndarray, flips: np.ndarray | None = None
                 ) -> list:
    """K-column MSM sharing ONE signed-digit window pass: per column k,
    out[k] = Σᵢ scalars[k, i]·bases[i] — bit-exact with K serial
    :func:`g1_msm` calls, but the base parse/Montgomery conversion, the
    window counting sorts and the batch-affine inversion levels are
    amortized across the K columns (native ``g1_msm_multi``; see the
    kernel comment for the full cost model). bases: (n, 8) affine
    standard form (zeros = identity); scalars: (K, n, 4); ``flips``
    ((K, n) uint8, optional) negates base i's y for column k only —
    the scalar-balancing hook. Returns K affine points (None =
    identity). Large MSMs run over row ranges on all cores (see
    ``_row_ranges``)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    bases = np.ascontiguousarray(bases)
    scalars = np.ascontiguousarray(scalars)
    if scalars.ndim != 3 or scalars.shape[2] != 4:
        raise ValueError("scalars must be (K, n, 4)")
    kcols, n = scalars.shape[0], scalars.shape[1]
    if n != len(bases):
        raise ValueError("scalar columns do not match the base count")
    if kcols > 64:
        raise ValueError("g1_msm_multi is capped at 64 columns per call")
    if flips is not None:
        flips = np.ascontiguousarray(flips, dtype=np.uint8)
        if flips.shape != (kcols, n):
            raise ValueError("flips must be (K, n)")
    parts = _map_ranges(lambda a, b: _g1_msm_multi_one(
        lib, base_modulus, bases[a:b],
        np.ascontiguousarray(scalars[:, a:b]),
        None if flips is None else np.ascontiguousarray(flips[:, a:b])), n)
    return [_sum_points([p[k] for p in parts], base_modulus)
            for k in range(kcols)]


def _g1_msm_multi_one(lib, base_modulus: int, bases: np.ndarray,
                      scalars: np.ndarray, flips) -> list:
    kcols, n = scalars.shape[0], scalars.shape[1]
    fptr = None
    if flips is not None:
        fptr = flips.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    out = np.empty((kcols, 8), dtype="<u8")
    lib.g1_msm_multi(_ptr(_scalar(base_modulus)), _ptr(bases),
                     _ptr(scalars), fptr, n, kcols, _ptr(out))
    vals = limbs_to_ints(out.reshape(-1, 4))
    points = []
    for k in range(kcols):
        x, y = vals[2 * k], vals[2 * k + 1]
        points.append(None if x == 0 and y == 0 else (x, y))
    return points


def g1_fixed_base_muls(base_modulus: int, base_pt, scalars: np.ndarray
                       ) -> np.ndarray:
    """out[i] = scalars[i]·base (affine standard form, (n, 8)); identity
    rows are zeros. Windowed fixed-base — the SRS powers-of-τ kernel."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    base = ints_to_limbs([base_pt[0], base_pt[1]]).reshape(8)
    scalars = np.ascontiguousarray(scalars)
    out = np.empty((len(scalars), 8), dtype="<u8")
    lib.g1_fixed_base_muls(_ptr(_scalar(base_modulus)), _ptr(base),
                           _ptr(scalars), len(scalars), _ptr(out))
    return out


def points_to_limbs(points) -> np.ndarray:
    """Affine (x, y) tuples (None = identity) → (n, 8) uint64 array."""
    flat = []
    for pt in points:
        if pt is None:
            flat.extend((0, 0))
        else:
            flat.extend((pt[0], pt[1]))
    return ints_to_limbs(flat).reshape(-1, 8)


# --- array-level API -------------------------------------------------------

class FieldKernel:
    """Kernels over one prime modulus; all arrays are (n, 4) uint64."""

    def __init__(self, modulus: int):
        self.lib = _load()
        if self.lib is None:
            raise RuntimeError("native library unavailable")
        self.modulus = modulus
        self.mod_arr = _scalar(modulus)

    def vec_mul(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        a = np.ascontiguousarray(a)
        b = np.ascontiguousarray(b)
        out = np.empty_like(a)
        self.lib.fr_vec_op(_ptr(self.mod_arr), 2, _ptr(out), _ptr(a),
                           _ptr(b), len(a))
        return out

    def vec_add(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        a = np.ascontiguousarray(a)
        b = np.ascontiguousarray(b)
        out = np.empty_like(a)
        self.lib.fr_vec_op(_ptr(self.mod_arr), 0, _ptr(out), _ptr(a),
                           _ptr(b), len(a))
        return out

    def vec_sub(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        a = np.ascontiguousarray(a)
        b = np.ascontiguousarray(b)
        out = np.empty_like(a)
        self.lib.fr_vec_op(_ptr(self.mod_arr), 1, _ptr(out), _ptr(a),
                           _ptr(b), len(a))
        return out

    def scalar_add(self, a: np.ndarray, s: int) -> np.ndarray:
        a = np.ascontiguousarray(a)
        out = np.empty_like(a)
        self.lib.fr_vec_scalar_op(_ptr(self.mod_arr), 0, _ptr(out), _ptr(a),
                                  _ptr(_scalar(s)), len(a))
        return out

    def scalar_sub(self, a: np.ndarray, s: int) -> np.ndarray:
        a = np.ascontiguousarray(a)
        out = np.empty_like(a)
        self.lib.fr_vec_scalar_op(_ptr(self.mod_arr), 1, _ptr(out), _ptr(a),
                                  _ptr(_scalar(s)), len(a))
        return out

    def scalar_mul(self, a: np.ndarray, s: int) -> np.ndarray:
        a = np.ascontiguousarray(a)
        out = np.empty_like(a)
        self.lib.fr_vec_scalar_op(_ptr(self.mod_arr), 2, _ptr(out), _ptr(a),
                                  _ptr(_scalar(s)), len(a))
        return out

    def poly_divide_linear(self, coeffs: np.ndarray, z: int) -> np.ndarray:
        """(f(X) − f(z)) / (X − z); coeffs (n, 4) → (n−1, 4)."""
        coeffs = np.ascontiguousarray(coeffs)
        n = len(coeffs)
        if n <= 1:
            return np.zeros((0, 4), dtype="<u8")
        out = np.empty((n - 1, 4), dtype="<u8")
        self.lib.fr_poly_divide_linear(_ptr(self.mod_arr), _ptr(coeffs), n,
                                       _ptr(_scalar(z)), _ptr(out))
        return out

    def ntt(self, data: np.ndarray, omega: int, inverse: bool = False
            ) -> np.ndarray:
        data = _require_inplace(data)
        self.lib.ntt(_ptr(self.mod_arr), _ptr(data), len(data),
                     _ptr(_scalar(omega)), 1 if inverse else 0)
        return data

    def coset_scale(self, data: np.ndarray, shift: int,
                    invert: bool = False) -> np.ndarray:
        data = _require_inplace(data)
        self.lib.coset_scale(_ptr(self.mod_arr), _ptr(data), len(data),
                             _ptr(_scalar(shift)), 1 if invert else 0)
        return data

    def poly_eval_many(self, polys: np.ndarray, x: int) -> list:
        """polys: (n_polys, n, 4) contiguous; returns ints."""
        polys = np.ascontiguousarray(polys)
        n_polys, n = polys.shape[0], polys.shape[1]
        out = np.empty((n_polys, 4), dtype="<u8")
        self.lib.poly_eval_many(_ptr(self.mod_arr), _ptr(polys), n_polys, n,
                                _ptr(_scalar(x)), _ptr(out))
        return limbs_to_ints(out)

    def batch_inverse(self, data: np.ndarray) -> np.ndarray:
        data = _require_inplace(data)
        self.lib.batch_inverse(_ptr(self.mod_arr), _ptr(data), len(data))
        return data

    def perm_grand_product(self, wires: np.ndarray, sigma: np.ndarray,
                           shifts: list, omegas: np.ndarray, beta: int,
                           gamma: int) -> np.ndarray:
        """wires/sigma: (num_wires, n, 4); returns z (n, 4)."""
        wires = np.ascontiguousarray(wires)
        sigma = np.ascontiguousarray(sigma)
        n = wires.shape[1]
        z = np.empty((n, 4), dtype="<u8")
        rc = self.lib.perm_grand_product(
            _ptr(self.mod_arr), _ptr(wires), wires.shape[0], _ptr(sigma),
            _ptr(ints_to_limbs(shifts)), _ptr(np.ascontiguousarray(omegas)),
            _ptr(_scalar(beta)), _ptr(_scalar(gamma)), n, _ptr(z))
        if rc != 0:
            raise ValueError("permutation grand product does not wrap")
        return z

    def logup_running_sum(self, a_col: np.ndarray, table: np.ndarray,
                          m_col: np.ndarray, beta: int) -> np.ndarray:
        n = len(a_col)
        phi = np.empty((n, 4), dtype="<u8")
        rc = self.lib.logup_running_sum(
            _ptr(self.mod_arr), _ptr(np.ascontiguousarray(a_col)),
            _ptr(np.ascontiguousarray(table)),
            _ptr(np.ascontiguousarray(m_col)), _ptr(_scalar(beta)), n,
            _ptr(phi))
        if rc != 0:
            raise ValueError("lookup running sum does not wrap")
        return phi

    def quotient_eval(self, wires_e, z_e, zw_e, m_e, phi_e, phiw_e, uv_e,
                      fixed_e, sigma_e, pi_e, xs, zh_inv, l0, beta, gamma,
                      beta_lk, alpha, shifts) -> np.ndarray:
        """z-split quotient identity on the 4n coset; ``uv_e`` is the
        (4, ext_n, 4) stack of [u1, u2, v1, v2] extension values."""
        ext_n = len(z_e)
        out = np.empty((ext_n, 4), dtype="<u8")
        args = [np.ascontiguousarray(a) for a in
                (wires_e, z_e, zw_e, m_e, phi_e, phiw_e, uv_e, fixed_e,
                 sigma_e, pi_e, xs, zh_inv, l0)]
        self.lib.quotient_eval2(
            _ptr(self.mod_arr), *[_ptr(a) for a in args],
            _ptr(_scalar(beta)), _ptr(_scalar(gamma)),
            _ptr(_scalar(beta_lk)), _ptr(_scalar(alpha)),
            _ptr(ints_to_limbs(shifts)), ext_n, _ptr(out))
        return out
