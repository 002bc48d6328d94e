"""The field kernels: their CUDA build, binding, wrappers and plain
versions, and the limb helpers the plain versions are made of.

Field elements are rows of ``NUM_LIMBS`` little-endian limbs of
``LIMB_BITS`` bits in int32 (``ops/fieldops.py``); a batch is an
``(n, NUM_LIMBS)`` tensor. Three kernels, in ``csrc/field.cu``:

- ``mont_mul(x, y, ctx)``: x·y·R⁻¹ mod p with R = 2^264, the CIOS
  Montgomery product. It replaces
  ``protocol_tpu/ops/pallas_kernels.py::_mont_mul_kernel``;
- ``add_mod(x, y, ctx)`` and ``sub_mod(x, y, ctx)``: (x ± y) mod p, one
  launch each where the plain versions take dozens of torch launches.

``ctx`` is a ``fieldops.FieldCtx`` (its ``modulus``, ``p_limbs`` and
``p_inv_neg``). The source's header says what bounds each kernel and
how the kernels stage their rows through shared memory (``TILE_ROWS``
rows a block). It is compiled with ``nvcc`` for
``sm_90a`` into ``protocol_tpu_torch/build/`` at the first launch and
bound with ctypes.

An operand may be one row broadcast to every lane (stride ``(0, 1)``, as
``fieldops.const_rows`` makes it): the kernels read that row as it is.
Any other layout is made contiguous first.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. There is no fallback between the two.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from pathlib import Path

import torch
import torch.nn.functional as F

from ..._build import build_shared_library
from .lane_perm_kernel import _nvcc_path

LIMB_BITS = 12
NUM_LIMBS = 22
BASE = 1 << LIMB_BITS
MASK = BASE - 1

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "field.cu"
TILE_ROWS = 64  # rows of a block: kRows in field.cu
_OPS = {"mont_mul": 0, "add_mod": 1, "sub_mod": 2}

# launches of each CUDA kernel since the last reset_launches(): the proof
# that a run went through the kernels and not the plain versions
LAUNCHES = {name: 0 for name in _OPS}

_lock = threading.Lock()
_lib = None
_c_moduli: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --- limb helpers (plain torch) ----------------------------------------------

_rows: dict = {}

# 0-d CPU tensors (one, the mask, the shift, the base) for the helpers'
# elementwise ops, one set per dtype: an op takes them as scalars on any
# device, without wrapping a Python number or converting a dtype on
# every call. (``torch.where`` would copy a CPU one to the card each
# time: its zero is a 0-d tensor on the operand's device, ``_zero``.)
_SCALARS = {dt: tuple(torch.tensor(v, dtype=dt)
                      for v in (1, MASK, LIMB_BITS, BASE))
            for dt in (torch.int32, torch.int64)}


def _zero(dtype, device) -> torch.Tensor:
    return _const(("zero", dtype), torch.device(device),
                  lambda: torch.tensor(0, dtype=dtype))


def _const(key, device, make) -> torch.Tensor:
    t = _rows.get((key, device))
    if t is None:
        t = _rows[(key, device)] = make().to(device)
    return t


def limb_row(value: int, device) -> torch.Tensor:
    """The (NUM_LIMBS,) int32 limbs of a non-negative int below 2^264,
    kept once per device."""
    return _const(("row", value), torch.device(device), lambda: torch.tensor(
        [(value >> (LIMB_BITS * j)) & MASK for j in range(NUM_LIMBS)],
        dtype=torch.int32))


def _bias(width: int, dtype, device) -> torch.Tensor:
    # (2·2^12, 2·(2^12 − 1), …): a limb vector whose value is 2^(12·width+1)
    # ≡ 0 mod 2^(12·width), so adding it lifts every limb ≥ −8190 to ≥ 0
    return _const(("bias", width, dtype), torch.device(device),
                  lambda: torch.tensor([2 * BASE] + [2 * MASK] * (width - 1),
                                       dtype=dtype))


def _index(width: int, device) -> torch.Tensor:
    return _const(("arange", width), torch.device(device),
                  lambda: torch.arange(width))


def _bits(width: int, device) -> torch.Tensor:
    return _const(("bits", width), torch.device(device),
                  lambda: torch.ones(width, dtype=torch.int64)
                  << torch.arange(width))


def ripple(t: torch.Tensor, passes: int | None = None) -> torch.Tensor:
    """Normalise limb rows: the value mod 2^(12·width), every limb in
    [0, 2^12). The same function as the reference's 22-pass
    ``fieldops._ripple``, in a fraction of the launches.

    Limbs may lie in [−8190, 2^31 − 8192) in int32 (borrows of a
    subtract, lazy sums and CIOS accumulators all do), or below 2^46 in
    int64. A bias that is 0 mod 2^(12·width) makes every limb
    non-negative; carry passes then bring every limb to at most 8190
    (``passes`` overrides the count where the caller knows a tighter
    bound), so each limb's carry out is 0 or 1, and a carry-lookahead
    resolves the chains of 4095s those run through: with one bit per
    limb, the carries into the limbs are the carries of the binary sum
    (starts | passes) + starts, where a limb ≥ 4096 starts a carry and a
    limb of 4095 passes one on."""
    width = t.shape[1]
    if passes is None:
        passes = 2 if t.dtype == torch.int32 else 3
    _, mask, shift, base = _SCALARS[t.dtype]
    t = t + _bias(width, t.dtype, t.device)
    for _ in range(passes):
        # each limb's carry moves one limb up; the top one drops out
        t = (t & mask) + F.pad(t >> shift, (1, -1))
    bits = _bits(width, t.device)
    zero64, one64 = _zero(torch.int64, t.device), _SCALARS[torch.int64][0]
    starts = t >= base
    a = torch.where(starts | (t == mask), bits, zero64).sum(1)
    g = torch.where(starts, bits, zero64).sum(1)
    carry = (((a + g) ^ a ^ g)[:, None] >> _index(width, t.device)) & one64
    return (t + carry.to(t.dtype)) & mask


def geq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rowwise a >= b on limb rows, compared from the top limb down; b
    may be a (L,) row or an (n, L) batch."""
    # one bit per limb where a is greater, one where b is: the highest
    # limb that differs decides, and it is the highest bit of the two
    bits = _bits(a.shape[1], a.device)
    zero64 = _zero(torch.int64, a.device)
    return (torch.where(a > b, bits, zero64).sum(1)
            >= torch.where(a < b, bits, zero64).sum(1))


def cond_sub_p(t: torch.Tensor, ctx) -> torch.Tensor:
    """One conditional subtract of p (inputs normalised, in [0, 2p))."""
    p_row = limb_row(ctx.modulus, t.device)
    sub = geq(t, p_row)
    zero = _zero(torch.int32, t.device)
    return ripple(t - torch.where(sub[:, None], p_row, zero), passes=1)


# --- plain versions -----------------------------------------------------------

def _diagonals(device) -> torch.Tensor:
    # column j + k of the limb product a_j · b_k, for a (22 × 22) flattening
    return _const(("diag",), torch.device(device), lambda: (
        torch.arange(NUM_LIMBS)[:, None] + torch.arange(NUM_LIMBS)).reshape(-1))


def _limb_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a · b as 44 unnormalised int64 columns (a: (n, 22), b: (n, 22) or
    (22,))."""
    prod = (a[:, :, None] * b[..., None, :]).reshape(a.shape[0], -1)
    out = torch.zeros(a.shape[0], 2 * NUM_LIMBS, dtype=torch.int64,
                      device=a.device)
    return out.index_add_(1, _diagonals(a.device), prod)


def mont_mul_plain(x: torch.Tensor, y: torch.Tensor, ctx) -> torch.Tensor:
    """The plain torch version of the Montgomery kernel. It computes the
    same function as the CIOS of ``fieldops.mont_mul``, in whole-number
    steps rather than 22 digit steps: the CIOS's quotient digits u_i
    form the one m in [0, R) with x·y + m·p ≡ 0 (mod R), so

        m = (x·y mod R) · (−p⁻¹ mod R) mod R,   t = (x·y + m·p) / R,

    and one conditional subtract of p, exactly as the kernel does."""
    dev = x.device
    r = 1 << (LIMB_BITS * NUM_LIMBS)
    q_row = _const(("q64", ctx.modulus), torch.device(dev), lambda: limb_row(
        -pow(ctx.modulus, -1, r) % r, "cpu").long())  # −p⁻¹ mod R
    p_row = _const(("p64", ctx.modulus), torch.device(dev), lambda: limb_row(
        ctx.modulus, "cpu").long())
    t = _limb_product(x.long(), y.long())  # columns < 2^29
    m = ripple(_limb_product(t[:, :NUM_LIMBS], q_row)[:, :NUM_LIMBS])
    t = ripple(t + _limb_product(m, p_row))  # t ≡ 0 mod R: low half is 0
    return cond_sub_p(t[:, NUM_LIMBS:].int(), ctx)


def add_mod_plain(x: torch.Tensor, y: torch.Tensor, ctx) -> torch.Tensor:
    """(x + y) mod p on normalised rows: ``_cond_sub_p(_ripple(x + y))``."""
    return cond_sub_p(ripple(x + y, passes=1), ctx)


def sub_mod_plain(x: torch.Tensor, y: torch.Tensor, ctx) -> torch.Tensor:
    """(x − y) mod p on normalised rows: add p where x < y, then ripple."""
    need_p = ~geq(x, y)
    p_row = limb_row(ctx.modulus, x.device)
    zero = _zero(torch.int32, x.device)
    return ripple(x - y + torch.where(need_p[:, None], p_row, zero), passes=1)


_PLAIN = {"mont_mul": mont_mul_plain, "add_mod": add_mod_plain,
          "sub_mod": sub_mod_plain}


# --- the CUDA kernels -----------------------------------------------------------

def build() -> Path:
    """Compile the kernels (no-op when built); returns the library path.
    ``build_log`` of it holds ptxas's registers and spills per kernel."""
    cmd = [_nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler",
           "-fPIC"]
    return build_shared_library("field", _SRC, cmd)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.field_launch.argtypes = [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
                ctypes.c_void_p]
            lib.field_launch.restype = ctypes.c_int
            lib.field_error_string.argtypes = [ctypes.c_int]
            lib.field_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _c_limbs(ctx):
    arr = _c_moduli.get(ctx.modulus)
    if arr is None:
        arr = _c_moduli[ctx.modulus] = (ctypes.c_int32 * NUM_LIMBS)(
            *ctx.p_limbs)
    return arr


def _rows_of(t: torch.Tensor) -> tuple:
    """(t, its row stride in int32) as the kernels take it: 0 for one row
    broadcast to every lane (``fieldops.const_rows``), read as it is;
    else a contiguous copy where t is not contiguous already."""
    if t.stride() == (0, 1):
        return t, 0
    return t.contiguous(), NUM_LIMBS


def _launch(name: str, x: torch.Tensor, y: torch.Tensor, ctx) -> torch.Tensor:
    if x.dim() != 2 or x.shape[1] != NUM_LIMBS:
        raise ValueError(f"{name}: x must be (n, {NUM_LIMBS}), got "
                         f"{tuple(x.shape)}")
    if y.shape != x.shape:
        raise ValueError(f"{name}: y {tuple(y.shape)} differs from x "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.int32 or y.dtype != torch.int32:
        raise ValueError(f"{name}: limbs must be int32, got {x.dtype} and "
                         f"{y.dtype}")
    if x.device != y.device:
        raise ValueError(f"{name}: x and y on different devices")
    if x.device.type == "cpu":
        return _PLAIN[name](x, y, ctx)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    x, sx = _rows_of(x)
    y, sy = _rows_of(y)
    n = x.shape[0]
    out = torch.empty((n, NUM_LIMBS), dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    lib = _load()
    # switching devices costs a few µs a call: only when the tensors are
    # not on the current one
    same = x.device.index in (None, torch.cuda.current_device())
    with contextlib.nullcontext() if same else torch.cuda.device(x.device):
        rc = lib.field_launch(_OPS[name], x.data_ptr(), sx, y.data_ptr(), sy,
                              out.data_ptr(), n, _c_limbs(ctx),
                              ctx.p_inv_neg,
                              torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.field_error_string(rc).decode()}")
    LAUNCHES[name] += 1
    return out


def mont_mul(x: torch.Tensor, y: torch.Tensor, ctx) -> torch.Tensor:
    """x·y·R⁻¹ mod p rowwise, canonical. x may be a lazy sum below R =
    2^264; y is canonical."""
    return _launch("mont_mul", x, y, ctx)


def add_mod(x: torch.Tensor, y: torch.Tensor, ctx) -> torch.Tensor:
    """(x + y) mod p rowwise on normalised rows."""
    return _launch("add_mod", x, y, ctx)


def sub_mod(x: torch.Tensor, y: torch.Tensor, ctx) -> torch.Tensor:
    """(x − y) mod p rowwise on normalised rows."""
    return _launch("sub_mod", x, y, ctx)
