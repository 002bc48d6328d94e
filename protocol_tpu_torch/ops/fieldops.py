"""Batched big-prime field arithmetic on torch (int32 limbs).

The port of ``protocol_tpu/ops/fieldops.py``: the same representation,
the same Montgomery form and the same results, bit for bit. A field
element is a row of ``NUM_LIMBS`` = 22 little-endian limbs of
``LIMB_BITS`` = 12 bits in int32 (264 bits ≥ 254-bit moduli), a batch an
``(n, 22)`` tensor; R = 2^264. Every intermediate of the CIOS inner loop
stays below 2^31:

- per-step products are < 2^24,
- limbs accumulate lazily across the 22 CIOS steps (bounded by
  22·2^25 < 2^30) — no per-step carry propagation,
- the shifted-out limb's low bits are exact despite deferred carries,
  because t ≡ t[0] (mod 2^B) (all other limbs carry factors of 2^B).

Everything is modulus-generic (BN254 Fr/Fq, the secp256k1 field and
order — any prime up to 256 bits): precompute a ``FieldCtx`` per modulus.

``mont_mul``, ``add_mod`` and ``sub_mod`` are the hand-written CUDA
kernels of ``ops/kernels/field_kernel.py`` on a CUDA tensor and their
plain torch versions on a CPU tensor. Device placement follows the
tensors; ``field_converge`` takes ``device=None``, which means the GPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .kernels import field_kernel as fk
from .kernels.field_kernel import BASE, LIMB_BITS, MASK, NUM_LIMBS

# the carry helpers are the plain versions' building blocks
_ripple = fk.ripple
_geq = fk.geq
_cond_sub_p = fk.cond_sub_p


class FieldCtx:
    """Per-modulus constants, host-side."""

    def __init__(self, modulus: int):
        # CIOS is exact for any modulus < R = 2^264: with input x < R the
        # output is < p·(x/R + 1) < 2p, which one conditional subtract
        # fixes. 256 bits leaves ≥ 2^8 of lazy-sum headroom (see
        # ``max_lazy_terms``) — enough for BN254 Fr/Fq AND the secp256k1
        # field/order the batched-ECDSA path needs.
        if modulus.bit_length() > 256:
            raise ValueError("modulus too large for the limb layout")
        self.modulus = modulus
        # how many < p terms may be lazily summed before exceeding R
        self.max_lazy_terms = 1 << (LIMB_BITS * NUM_LIMBS
                                    - modulus.bit_length())
        self.p_limbs = tuple(
            (modulus >> (LIMB_BITS * i)) & MASK for i in range(NUM_LIMBS)
        )
        # -p^{-1} mod 2^B (CIOS quotient constant)
        self.p_inv_neg = (-pow(modulus, -1, BASE)) % BASE
        self.r = pow(2, LIMB_BITS * NUM_LIMBS, modulus)  # R mod p
        self.r2 = self.r * self.r % modulus  # R² mod p (to-Montgomery factor)

    def __hash__(self):
        return hash(self.modulus)

    def __eq__(self, other):
        return isinstance(other, FieldCtx) and other.modulus == self.modulus


# --- host <-> limb conversion ----------------------------------------------

def to_limbs(values) -> np.ndarray:
    """Python ints → (n, L) int32 limb rows (plain, not Montgomery).

    Fast path: serialize through ``int.to_bytes`` and split 3 bytes →
    two 12-bit limbs vectorized. Values outside [0, 2^264) (never
    produced by the field paths) fall back to the per-limb masking
    loop."""
    vals = [int(v) for v in values]
    n = len(vals)
    try:
        buf = b"".join(v.to_bytes(33, "little") for v in vals)
    except (OverflowError, ValueError):  # negative or >= 2^264
        out = np.zeros((n, NUM_LIMBS), dtype=np.int32)
        for i, v in enumerate(vals):
            for j in range(NUM_LIMBS):
                out[i, j] = (v >> (LIMB_BITS * j)) & MASK
        return out
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(n, 33)
    b = raw.reshape(n, 11, 3).astype(np.int32)
    out = np.empty((n, NUM_LIMBS), dtype=np.int32)
    out[:, 0::2] = b[:, :, 0] | ((b[:, :, 1] & 0xF) << 8)
    out[:, 1::2] = (b[:, :, 1] >> 4) | (b[:, :, 2] << 4)
    return out


def from_limbs(arr) -> list:
    """(n, L) limb rows → Python ints (vectorized repack for normalized
    rows; arbitrary/unnormalized limbs take the exact summation path)."""
    arr = np.asarray(arr)
    n = arr.shape[0]
    if n and ((arr < 0) | (arr > MASK)).any():
        return [
            sum(int(arr[i, j]) << (LIMB_BITS * j)
                for j in range(NUM_LIMBS))
            for i in range(n)
        ]
    b = np.empty((n, 33), dtype=np.uint8)
    l0 = arr[:, 0::2]
    l1 = arr[:, 1::2]
    b[:, 0::3] = l0 & 0xFF
    b[:, 1::3] = (l0 >> 8) | ((l1 & 0xF) << 4)
    b[:, 2::3] = l1 >> 4
    by = b.tobytes()
    return [int.from_bytes(by[33 * i:33 * (i + 1)], "little")
            for i in range(n)]


def to_device(values, device) -> torch.Tensor:
    """Python ints → (n, L) int32 limb rows on ``device``."""
    return torch.from_numpy(to_limbs(values)).to(device)


def const_rows(value: int, n: int, device) -> torch.Tensor:
    """The limbs of one host constant, broadcast to (n, L)."""
    return fk.limb_row(value, device).expand(n, NUM_LIMBS)


# --- core Montgomery multiply ----------------------------------------------

def mont_mul(ctx: FieldCtx, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched Montgomery product: x·y·R⁻¹ mod p, normalized rows.

    x may hold lazily-summed values up to R = 2^264 (see
    ``mont_matvec``): the CIOS output is < p·(x/R + 1) < 2p for any
    x < R, so the single conditional subtract suffices."""
    return fk.mont_mul(x, y, ctx)


def add_mod(ctx: FieldCtx, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(x + y) mod p on normalized rows (works in either domain)."""
    return fk.add_mod(x, y, ctx)


def sub_mod(ctx: FieldCtx, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(x - y) mod p on normalized rows (works in either domain)."""
    return fk.sub_mod(x, y, ctx)


def to_mont(ctx: FieldCtx, limbs: torch.Tensor) -> torch.Tensor:
    """Plain rows → Montgomery domain (multiply by R² with reduction)."""
    return mont_mul(ctx, limbs, const_rows(ctx.r2, limbs.shape[0],
                                           limbs.device))


def from_mont(ctx: FieldCtx, limbs: torch.Tensor) -> torch.Tensor:
    """Montgomery rows → plain rows (multiply by 1 with reduction)."""
    return mont_mul(ctx, limbs, const_rows(1, limbs.shape[0], limbs.device))


def mont_one(ctx: FieldCtx, n: int, device) -> torch.Tensor:
    """1 in Montgomery form, broadcast to (n, L)."""
    return const_rows(ctx.r, n, device)


def mont_pow(ctx: FieldCtx, x: torch.Tensor, exp: int) -> torch.Tensor:
    """x^exp (exponent known on the host) in the Montgomery domain.

    Small exponents (the Poseidon S-box x^5) unroll to a minimal
    multiply chain; large ones (Fermat inversion, ~254 bits) run the
    square-and-multiply, multiplying only at the exponent's set bits
    (the host knows them: the reference's per-bit select of an unused
    product is not needed eagerly)."""
    e = int(exp)
    if e.bit_length() <= 8:
        acc = mont_one(ctx, x.shape[0], x.device)
        base = x
        while e:
            if e & 1:
                acc = mont_mul(ctx, acc, base)
            e >>= 1
            if e:
                base = mont_mul(ctx, base, base)
        return acc

    acc = mont_one(ctx, x.shape[0], x.device)
    base = x
    for i in range(e.bit_length()):
        if (e >> i) & 1:
            acc = mont_mul(ctx, acc, base)
        if i + 1 < e.bit_length():
            base = mont_mul(ctx, base, base)
    return acc


def inv_mod(ctx: FieldCtx, x: torch.Tensor) -> torch.Tensor:
    """Batched modular inverse via Fermat (x^(p-2)); 0 → 0 like the
    reference's witness convention for absent inverses."""
    return mont_pow(ctx, x, ctx.modulus - 2)


# --- batched dot products (the field-converge building block) --------------

def _lazy_rowsum_mod(ctx: FieldCtx, rows: torch.Tensor) -> torch.Tensor:
    """Exact mod-p reduction of a lazy limb-sum (< 512·p): one
    Montgomery multiply by plain R maps acc → acc·R·R⁻¹ = acc mod p."""
    return mont_mul(ctx, rows, const_rows(ctx.r, rows.shape[0], rows.device))


def mont_matvec(ctx: FieldCtx, m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """new[i] = Σ_j m[j, i] · v[j]  (mod p), Montgomery domain.

    m: (N, N, L) trust matrix, v: (N, L) — index convention matches the
    reference converge loop (``dynamic_sets/native.rs:322-326``: score
    flows j → i through m[j][i]). The N² products run as one batched
    Montgomery multiply; the lazy limb sum over j is exact for N ≤ 512
    (sum < 512·p keeps CIOS intermediates in int32 and its output < 2p).
    """
    n = m.shape[0]
    limit = min(512, ctx.max_lazy_terms)
    if n > limit:
        raise ValueError(
            f"mont_matvec supports set sizes up to {limit} for this modulus")
    prod = mont_mul(
        ctx,
        m.transpose(0, 1).reshape(n * n, NUM_LIMBS),  # [i, j] rows
        v.repeat(n, 1),
    ).reshape(n, n, NUM_LIMBS)
    acc = _ripple(prod.sum(dim=1, dtype=torch.int32))
    # acc < N·p: one Montgomery multiply by R (plain) maps it to
    # acc·R·R⁻¹ = acc mod p while staying in the Montgomery domain
    return _lazy_rowsum_mod(ctx, acc)


# --- bit-exact EigenTrust field convergence --------------------------------

def _field_converge_mont(ctx: FieldCtx, m: torch.Tensor, s0: torch.Tensor,
                         num_iterations: int) -> torch.Tensor:
    n = m.shape[0]
    # row sums + Fermat inverse-or-zero (native.rs:305-314 semantics)
    row_sum = _lazy_rowsum_mod(ctx, _ripple(m.sum(dim=1, dtype=torch.int32)))
    inv = inv_mod(ctx, row_sum)  # (N, L); zero rows stay zero
    m_norm = mont_mul(
        ctx,
        m.reshape(n * n, NUM_LIMBS),
        inv.repeat_interleave(n, dim=0),
    ).reshape(n, n, NUM_LIMBS)
    s = s0
    for _ in range(num_iterations):
        s = mont_matvec(ctx, m_norm, s)
    return s


def field_converge(ctx: FieldCtx, matrix, initial, num_iterations: int,
                   device=None) -> list:
    """Bit-exact twin of ``EigenTrustSet.converge``'s post-filter phase
    (``models/eigentrust.py`` / reference ``dynamic_sets/native.rs:
    305-329``): field row-normalization by modular inverse-or-zero, then
    the fixed power iteration — producing the exact same Fr scores as the
    scalar loop, as batched int32 limb arithmetic on the card.

    ``matrix``: N×N ints (filtered opinion values), ``initial``: N ints.
    ``device=None`` means the GPU (raises without one). Returns N ints.
    """
    dev = resolve_device(device)
    n = len(matrix)
    flat = [int(v) % ctx.modulus for row in matrix for v in row]
    m = to_mont(ctx, to_device(flat, dev)).reshape(n, n, NUM_LIMBS)
    s0 = to_mont(ctx, to_device([int(v) for v in initial], dev))
    s = _field_converge_mont(ctx, m, s0, num_iterations)
    return from_limbs(from_mont(ctx, s).cpu().numpy())
