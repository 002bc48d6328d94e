"""The device prover's BN254 Fr engine: the counterpart of
``protocol_tpu/ops/fieldops2.py``, written for the card.

The reference engine keeps n elements as ``(L, n)`` limb planes in its
own Montgomery domain (R = 2^276, relaxed limbs below 2^13, values below
2p). This engine keeps the layout and the domain of the port's field
kernels (``ops/kernels/field_kernel.py``, B2) instead, so that every
product of the prover is one launch of the hand-written ``mont_mul`` and
every sum one launch of ``add_mod`` / ``sub_mod``:

- **Layout**: a batch of n elements is an ``(n, 22)`` int32 tensor of
  little-endian 12-bit limbs, one element a row (``fieldops``'s layout);
- **Domain**: device tensors hold x̃ = x·R mod p with R = 2^264, the
  radix of B2 (``csrc/field.cu``);
- **Canonical throughout**: every limb in [0, 2^12), every value in
  [0, p). B2's ``mont_mul``, ``add_mod`` and ``sub_mod`` take and give
  canonical rows, so no relaxed bookkeeping is needed. The one lazy
  form is a limb sum of at most ``LAZY_TERMS`` canonical rows (below R),
  which ``mont_mul`` accepts as its first operand.

A proof depends only on values mod p (every download canonicalises), so
the two engines give the same proofs; tests compare values with the
reference, never limb arrays.

Host ↔ device: ``upload_mont`` takes the prover core's ``(n, 4)``
little-endian u64 standard form through pinned memory and splits it into
limbs on the device; ``download_std`` returns it, as 16-bit windows that
the host regroups into u64 words.

On a CPU tensor each field kernel runs its plain torch version; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.fields import BN254_FR_MODULUS
from .fieldops import FieldCtx
from .kernels import field_kernel as fk
from .kernels.field_kernel import LIMB_BITS, MASK, NUM_LIMBS

B = LIMB_BITS
L = NUM_LIMBS
B6 = 6
L6 = 2 * L  # 44 six-bit planes
MASK6 = (1 << B6) - 1

P = BN254_FR_MODULUS
CTX = FieldCtx(P)
R_MONT = pow(2, B * L, P)            # R = 2^264 mod p: the form of 1
R2_MONT = R_MONT * R_MONT % P        # R² mod p: the to-Montgomery factor
# canonical rows whose limb sum stays below R: 2^(264 − 254)
LAZY_TERMS = CTX.max_lazy_terms


def mont(v: int) -> int:
    """The Montgomery form of a host int."""
    return int(v) % P * R_MONT % P


def ints_to_rows(vals) -> np.ndarray:
    """Host ints (< 2^264) → (n, 22) int32 limb rows (no reduction)."""
    out = np.zeros((len(vals), L), dtype=np.int32)
    for j, v in enumerate(vals):
        v = int(v)
        for i in range(L):
            out[j, i] = (v >> (B * i)) & MASK
    return out


def rows_to_ints(rows) -> list:
    """(n, 22) limb rows → host ints (not reduced mod p)."""
    rows = np.asarray(rows.cpu() if isinstance(rows, torch.Tensor)
                      else rows)
    return [sum(int(rows[j, i]) << (B * i) for i in range(rows.shape[1]))
            for j in range(rows.shape[0])]


def const_rows(v: int, n: int, device) -> torch.Tensor:
    """A host constant (< 2^264, taken as it is) broadcast to (n, 22):
    one row with stride 0, which the kernels read once per block."""
    return fk.limb_row(int(v), device).expand(n, L)


def mont_rows(vals, device) -> torch.Tensor:
    """(m, 22) Montgomery rows of host scalars (``_cplane`` stacked)."""
    return torch.from_numpy(ints_to_rows([mont(v) for v in vals])).to(device)


# --- the field operations (B2 and its companions) ----------------------------

def mont_mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x·y·R⁻¹ mod p, canonical: the Montgomery product of two Montgomery
    rows. x may be a lazy sum below R; y is canonical. Either may be one
    broadcast row (``const_rows``)."""
    return fk.mont_mul(x, y, CTX)


def add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(x + y) mod p on canonical rows."""
    return fk.add_mod(x, y, CTX)


def sub(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(x − y) mod p on canonical rows."""
    return fk.sub_mod(x, y, CTX)


def mont_mul_const(x: torch.Tensor, c: int) -> torch.Tensor:
    """x̃ · c for a host constant c given as it is (e.g. c = ṽ for a
    Montgomery factor, or c = R mod p to reduce a lazy sum)."""
    return mont_mul(x, const_rows(c, x.shape[0], x.device))


def enter_mont(x_plain: torch.Tensor) -> torch.Tensor:
    """Plain rows (< R) → Montgomery domain: multiply by R²."""
    return mont_mul_const(x_plain, R2_MONT)


def exit_mont(x_mont: torch.Tensor) -> torch.Tensor:
    """Montgomery rows → plain canonical rows: multiply by 1."""
    return mont_mul_const(x_mont, 1)


def sum_rows(x: torch.Tensor) -> torch.Tensor:
    """Σ over the rows of (n, 22) canonical Montgomery rows → (1, 22):
    blocks of ``LAZY_TERMS`` rows summed as int32 limbs (below R), each
    sum normalised and reduced by one multiply by R mod p (acc·R·R⁻¹),
    until one row is left."""
    while x.shape[0] > 1:
        n = x.shape[0]
        blk = min(LAZY_TERMS, n)
        pad = (-n) % blk
        if pad:
            x = torch.cat([x, x.new_zeros(pad, L)])
        s = x.reshape(-1, blk, L).sum(dim=1, dtype=torch.int32)
        x = mont_mul_const(fk.ripple(s), R_MONT)
    return x


def _scan_mul(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products over the rows (Hillis–Steele: ⌈log₂ n⌉
    launches over the whole batch)."""
    step = 1
    while step < x.shape[0]:
        x = torch.cat([x[:step], mont_mul(x[step:], x[:-step])])
        step *= 2
    return x


def batch_inv(x: torch.Tensor) -> torch.Tensor:
    """Montgomery-trick inverse of every row (all nonzero): prefix and
    suffix products, ONE inversion of the total, then
    xᵢ⁻¹ = pre_{i−1} · suf_{i+1} · total⁻¹. The one inversion is a
    single scalar: it goes to the host and back (one sync), where a
    Fermat chain on the device would be ~380 one-row launches."""
    n = x.shape[0]
    pre = _scan_mul(x)
    suf = _scan_mul(x.flip(0)).flip(0)
    # t̃ = t·R on the device; the row of t⁻¹ is (t⁻¹)·R = R / t̃ · R,
    # i.e. the Montgomery form of R / t̃
    t_m = rows_to_ints(pre[-1:])[0]
    total_inv = mont_rows([R_MONT * pow(t_m, -1, P)], x.device)
    one = fk.limb_row(R_MONT, x.device)[None]
    pre_prev = torch.cat([one, pre[:-1]])
    suf_next = torch.cat([suf[1:], one])
    out = mont_mul(pre_prev, suf_next)
    return mont_mul(out, total_inv.expand(n, L))


def powers_matrix(gens, cols: int, device) -> torch.Tensor:
    """(len(gens)·cols, 22) Montgomery rows of gᵣ^c, in (r, c) order,
    by doubling: ⌈log₂ cols⌉ multiplies of the table so far by each
    row's g^len (the squares of g come on the device)."""
    g = mont_rows(gens, device)
    r = g.shape[0]
    out = fk.limb_row(R_MONT, device).expand(r, 1, L)
    length = 1
    while length < cols:
        step = g[:, None, :].expand(r, length, L).reshape(-1, L)
        nxt = mont_mul(out.reshape(-1, L), step).reshape(r, length, L)
        out = torch.cat([out, nxt], dim=1)
        length *= 2
        if length < cols:
            g = mont_mul(g, g)
    return out[:, :cols].reshape(-1, L)


def powers_vector(base: int, n: int, device) -> torch.Tensor:
    """(n, 22) Montgomery rows of (baseⁱ)_{i<n}."""
    return powers_matrix([base], n, device)


# --- int8 plane interface of the NTT's stage products ------------------------

def to_planes(x: torch.Tensor) -> torch.Tensor:
    """(…, 22) canonical rows → (…, 44) int8 six-bit planes: plane 2i
    holds limb i's low six bits, plane 2i + 1 its high six."""
    lo = (x & MASK6).to(torch.int8)
    hi = (x >> B6).to(torch.int8)
    return torch.stack([lo, hi], dim=-1).reshape(*x.shape[:-1], L6)


def reduce_planes(acc: torch.Tensor, transpose: bool = False
                  ) -> torch.Tensor:
    """(87, d0, d1) int32 lazy base-2^6 planes of Montgomery products
    (each plane below 2^31, the value below 2^528) → (d0·d1, 22)
    canonical Montgomery rows, in (d0, d1) order, or (d1, d0) order
    with ``transpose``.

    Pairs of planes become 12-bit limbs in int64 (each below 2^35), a
    ripple of 44 limbs makes them exact digits of the value V, and its
    two 264-bit halves fold mod p: V = c₀ + c₁·2^264 ≡ c₀·R·R⁻¹ +
    c₁·R²·R⁻¹, two multiplies by host constants and one add."""
    k = acc.shape[0]
    d0, d1 = acc.shape[1], acc.shape[2]
    acc = torch.cat([acc, acc.new_zeros(2 * L6 - k, d0, d1)]).long()
    limbs = acc[0::2] + (acc[1::2] << B6)  # (44, d0, d1)
    limbs = limbs.permute(2, 1, 0) if transpose else limbs.permute(1, 2, 0)
    limbs = fk.ripple(limbs.reshape(d0 * d1, L6)).int()
    lo = mont_mul_const(limbs[:, :L], R_MONT)
    hi = mont_mul_const(limbs[:, L:], R2_MONT)
    return add(lo, hi)


# --- host wire format --------------------------------------------------------

def _pinned(t: torch.Tensor) -> torch.Tensor:
    return t.pin_memory() if torch.cuda.is_available() else t


def u64_to_rows(arr_u64: np.ndarray, device) -> torch.Tensor:
    """(n, 4) little-endian u64 standard values → (n, 22) plain limb
    rows on ``device``: the u64 words travel as they are (pinned), and
    the limbs are cut from them on the device."""
    a = np.ascontiguousarray(arr_u64).view("<i8").reshape(-1, 4)
    w = _pinned(torch.from_numpy(a)).to(device, non_blocking=True)
    cols = []
    for i in range(L):
        bit = B * i
        word, off = divmod(bit, 64)
        v = (w[:, word] >> off) & MASK  # arithmetic shift: masked after
        if off > 64 - B and word + 1 < 4:
            lo_bits = 64 - off
            v = (v & ((1 << lo_bits) - 1)) | (
                (w[:, word + 1] & ((1 << (B - lo_bits)) - 1)) << lo_bits)
        cols.append(v)
    return torch.stack(cols, dim=1).int()


def rows_to_u64(x: torch.Tensor) -> np.ndarray:
    """(n, 22) canonical plain rows → (n, 4) little-endian u64 on the
    host: sixteen 16-bit windows cut on the device, copied through
    pinned memory, regrouped on the host."""
    wins = []
    for t in range(16):
        a, s = divmod(16 * t, B)  # s ∈ {0, 4, 8}: two limbs cover it
        w = x[:, a] >> s
        if a + 1 < L:
            w = w | (x[:, a + 1] << (B - s))
        wins.append(w & 0xFFFF)
    w16 = torch.stack(wins, dim=1)
    host = torch.empty(w16.shape, dtype=w16.dtype, pin_memory=(
        w16.device.type == "cuda"))
    host.copy_(w16, non_blocking=True)
    if w16.device.type == "cuda":
        torch.cuda.current_stream(w16.device).synchronize()
    return np.ascontiguousarray(host.numpy().astype("<u2")).view(
        "<u8").reshape(-1, 4)


def upload_mont(arr_u64: np.ndarray, device) -> torch.Tensor:
    """(n, 4) u64 standard → (n, 22) Montgomery rows on ``device``."""
    return enter_mont(u64_to_rows(arr_u64, device))


def download_std(x: torch.Tensor) -> np.ndarray:
    """(n, 22) Montgomery rows → (n, 4) u64 standard on the host."""
    return rows_to_u64(exit_mont(x))
