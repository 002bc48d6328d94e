"""Batched secp256k1 ECDSA on torch — ingest-scale signature validation.

The port of ``protocol_tpu/ops/secp_batch.py``. The reference validates
every attestation with a scalar EC multiply (``ecdsa/native.rs:382-395``
verify, ``:298-331`` recover); this module runs N verifications or
recoveries at once on the modulus-generic limb engine
(``ops.fieldops``): Jacobian point arithmetic over the secp256k1 base
field and scalar logic over the group order, batched along the lane
axis. Every field multiply, add and subtract is one launch of a
hand-written kernel on the card.

Verification: two scalar muls fused in one 256-step Strauss ladder (per
bit: one Jacobian double + one table add from {∞, G, Q, G+Q}), with
branchless infinity/equal-point handling via lane selects. Recovery:
the GLV + fixed-base-window ladder (``_recover_glv``). Bit-exact against
``crypto.secp256k1``.

The JAX loops (``fori_loop``) are Python loops here and
``take_along_axis`` is ``torch.gather``. The fixed-base tables are built
once per process on the host and moved once to each device. Entry points
take ``device=None``, which means the GPU (raise without one).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..crypto.secp256k1 import (
    GLV_BETA,
    GX,
    GY,
    N as SECP_N,
    P as SECP_P,
    AffinePoint,
    glv_decompose,
)
from ..device import resolve_device
from .fieldops import (
    LIMB_BITS,
    NUM_LIMBS,
    FieldCtx,
    _cond_sub_p,
    add_mod,
    const_rows,
    from_limbs,
    from_mont,
    inv_mod,
    mont_mul,
    mont_pow,
    sub_mod,
    to_device,
    to_limbs,
    to_mont,
)

CTX_P = FieldCtx(SECP_P)  # base field (curve coordinates)
CTX_N = FieldCtx(SECP_N)  # scalar field (signature algebra)

SCALAR_BITS = 256

# host seconds spent, since the last reset_host_seconds(), building limb
# rows from ints (``limb_prep``), in the GLV split between the two device
# stages (``glv_split``) and turning result limbs back into ints
# (``unpack``, which also waits for the card)
HOST_SECONDS = {"limb_prep": 0.0, "glv_split": 0.0, "unpack": 0.0}


def reset_host_seconds() -> None:
    for k in HOST_SECONDS:
        HOST_SECONDS[k] = 0.0


def _const_mont(ctx: FieldCtx, value: int, n: int, device) -> torch.Tensor:
    """Montgomery form of a host constant (value·R mod p), (n, L)."""
    return const_rows(value * ctx.r % ctx.modulus, n, device)


def _zeros(n: int, device) -> torch.Tensor:
    return torch.zeros((n, NUM_LIMBS), dtype=torch.int32, device=device)


def _is_zero_row(x: torch.Tensor) -> torch.Tensor:
    return (x == 0).all(dim=1)


def _select(cond: torch.Tensor, a, b):
    """Per-point select: cond (n,) picks coords from a else b."""
    c = cond[:, None]
    return tuple(torch.where(c, ai, bi) for ai, bi in zip(a, b))


# --- Jacobian arithmetic (a = 0 curve) -------------------------------------

def _dbl(ctx, pt):
    """2P in Jacobian coordinates (valid for Z=0 → stays at infinity)."""
    x, y, z = pt
    a = mont_mul(ctx, x, x)
    b = mont_mul(ctx, y, y)
    c = mont_mul(ctx, b, b)
    xb = add_mod(ctx, x, b)
    d = sub_mod(ctx, sub_mod(ctx, mont_mul(ctx, xb, xb), a), c)
    d = add_mod(ctx, d, d)
    e = add_mod(ctx, add_mod(ctx, a, a), a)
    f = mont_mul(ctx, e, e)
    x3 = sub_mod(ctx, f, add_mod(ctx, d, d))
    c8 = add_mod(ctx, c, c)
    c8 = add_mod(ctx, c8, c8)
    c8 = add_mod(ctx, c8, c8)
    y3 = sub_mod(ctx, mont_mul(ctx, e, sub_mod(ctx, d, x3)), c8)
    yz = mont_mul(ctx, y, z)
    z3 = add_mod(ctx, yz, yz)
    return x3, y3, z3


def _add(ctx, p, q):
    """P + Q, branchless: handles ∞ operands, P == Q (falls back to the
    doubling formula) and P == −Q (→ ∞) via selects."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = mont_mul(ctx, z1, z1)
    z2z2 = mont_mul(ctx, z2, z2)
    u1 = mont_mul(ctx, x1, z2z2)
    u2 = mont_mul(ctx, x2, z1z1)
    s1 = mont_mul(ctx, y1, mont_mul(ctx, z2, z2z2))
    s2 = mont_mul(ctx, y2, mont_mul(ctx, z1, z1z1))
    h = sub_mod(ctx, u2, u1)
    rr = sub_mod(ctx, s2, s1)

    hh = mont_mul(ctx, h, h)
    hhh = mont_mul(ctx, h, hh)
    v = mont_mul(ctx, u1, hh)
    rr2 = mont_mul(ctx, rr, rr)
    x3 = sub_mod(ctx, sub_mod(ctx, rr2, hhh), add_mod(ctx, v, v))
    y3 = sub_mod(ctx, mont_mul(ctx, rr, sub_mod(ctx, v, x3)),
                 mont_mul(ctx, s1, hhh))
    z3 = mont_mul(ctx, mont_mul(ctx, z1, z2), h)
    general = (x3, y3, z3)

    p_inf = _is_zero_row(z1)
    q_inf = _is_zero_row(z2)
    h_zero = _is_zero_row(h)
    r_zero = _is_zero_row(rr)

    doubled = _dbl(ctx, p)
    inf = (_zeros(x1.shape[0], x1.device),) * 3

    out = _select(h_zero & r_zero, doubled, general)  # P == Q
    out = _select(h_zero & ~r_zero & ~p_inf & ~q_inf, inf, out)  # P == −Q
    out = _select(q_inf, p, out)
    out = _select(p_inf, q, out)
    return out


def _to_affine(ctx, pt):
    """Jacobian → affine Montgomery coords; ∞ → (0, 0)."""
    x, y, z = pt
    zi = inv_mod(ctx, z)  # Montgomery-domain inverse; 0 → 0
    zi2 = mont_mul(ctx, zi, zi)
    return mont_mul(ctx, x, zi2), mont_mul(ctx, y, mont_mul(ctx, zi, zi2))


def _bit(scalars: torch.Tensor, j: int) -> torch.Tensor:
    """Bit j of plain limb rows."""
    return (scalars[:, j // LIMB_BITS] >> (j % LIMB_BITS)) & 1


def _gather_entry(table, idx: torch.Tensor):
    """Per lane, entry idx[lane] of a (n, k, L) table, for each coord."""
    ix = idx.long()[:, None, None].expand(-1, 1, NUM_LIMBS)
    return tuple(torch.gather(t, 1, ix)[:, 0, :] for t in table)


def _strauss(u1_plain: torch.Tensor, u2_plain: torch.Tensor, q):
    """u1·G + u2·Q as one interleaved ladder. Scalars are plain limb
    rows; Q is an affine Montgomery pair. Returns a Jacobian point."""
    ctx = CTX_P
    n, dev = u1_plain.shape[0], u1_plain.device
    gx = _const_mont(ctx, GX, n, dev)
    gy = _const_mont(ctx, GY, n, dev)
    one = _const_mont(ctx, 1, n, dev)
    g = (gx, gy, one)
    qx, qy = q
    qj = (qx, qy, one)
    gq = _add(ctx, g, qj)

    # table[i] for i = b1 + 2·b2: ∞, G, Q, G+Q — stacked (n, 4, L)
    inf = (_zeros(n, dev),) * 3
    table = [torch.stack([c0, c1, c2, c3], dim=1)
             for c0, c1, c2, c3 in zip(inf, g, qj, gq)]

    acc = inf
    for i in range(SCALAR_BITS):
        j = SCALAR_BITS - 1 - i
        acc = _dbl(ctx, acc)
        idx = _bit(u1_plain, j) + 2 * _bit(u2_plain, j)  # (n,)
        acc = _add(ctx, acc, _gather_entry(table, idx))
    return acc


def _mod_n_plain(x_plain: torch.Tensor) -> torch.Tensor:
    """Reduce a base-field value (< p) into the scalar field: at most
    one subtract of n since p < 2n for secp256k1 (one conditional
    subtract — fieldops._cond_sub_p — is exact here)."""
    return _cond_sub_p(x_plain, CTX_N)


# --- GLV + fixed-base-window recovery ladder --------------------------------
#
# Recovery Q = u1·G + u2·R:
#
# - u1·G rides 64 unsigned 4-bit windows into PRECOMPUTED affine tables
#   T[j][d] = d·16^j·G — zero doublings, 64 mixed adds (~18 muls each);
# - u2·R splits through the λ-endomorphism (crypto glv_decompose,
#   host-side Babai) into 129-bit halves riding a joint 2-bit-window
#   ladder over {i·(e1R) + j·(e2λR)} — 65 iterations of 2 doublings + 1
#   add, plus a 16-entry per-lane table (2 dbl, 11 add).
#
# ≈ 3.8k muls per lane; bit-exact against the scalar oracle.

FB_WINDOW_BITS = 4
FB_WINDOWS = 64  # 256 bits / 4
GLV_WINDOW_BITS = 2
GLV_WINDOWS = 65  # ceil(129 / 2) windows of the half-scalars


class _FixedBaseTables:
    """Affine Montgomery tables d·16^j·G, j<64, d<16, as (64, 16, L)
    int32 host arrays — built once per process (Python EC adds) and
    moved once to each device that asks (``on``)."""

    def __init__(self):
        xs = np.zeros((FB_WINDOWS, 16, NUM_LIMBS), dtype=np.int32)
        ys = np.zeros((FB_WINDOWS, 16, NUM_LIMBS), dtype=np.int32)
        base = AffinePoint(GX, GY)
        for j in range(FB_WINDOWS):
            row = [AffinePoint.identity()]
            for _ in range(15):
                row.append(row[-1].add(base))
            mont = [(0, 0) if p.is_identity() else
                    (p.x * CTX_P.r % SECP_P, p.y * CTX_P.r % SECP_P)
                    for p in row]
            xs[j] = to_limbs([m[0] for m in mont])
            ys[j] = to_limbs([m[1] for m in mont])
            base = row[-1].add(base)  # 16^{j+1}·G
        self.xs = xs
        self.ys = ys
        self._on: dict = {}

    def on(self, device) -> tuple:
        key = torch.device(device)
        if key not in self._on:
            self._on[key] = (torch.from_numpy(self.xs).to(key),
                             torch.from_numpy(self.ys).to(key))
        return self._on[key]


_FB_TABLES: list = []


def _fb_tables() -> _FixedBaseTables:
    if not _FB_TABLES:
        _FB_TABLES.append(_FixedBaseTables())
    return _FB_TABLES[0]


def _add_mixed(ctx, p, ex, ey, e_inf):
    """P (Jacobian) + E (affine Montgomery, Z=1), branchless: ∞
    operands, P == E (doubling fallback) and P == −E handled by lane
    selects; ``e_inf`` marks lanes whose table entry is the identity."""
    x1, y1, z1 = p
    z1z1 = mont_mul(ctx, z1, z1)
    u2 = mont_mul(ctx, ex, z1z1)
    s2 = mont_mul(ctx, ey, mont_mul(ctx, z1, z1z1))
    h = sub_mod(ctx, u2, x1)
    rr = sub_mod(ctx, s2, y1)
    hh = mont_mul(ctx, h, h)
    hhh = mont_mul(ctx, h, hh)
    v = mont_mul(ctx, x1, hh)
    rr2 = mont_mul(ctx, rr, rr)
    x3 = sub_mod(ctx, sub_mod(ctx, rr2, hhh), add_mod(ctx, v, v))
    y3 = sub_mod(ctx, mont_mul(ctx, rr, sub_mod(ctx, v, x3)),
                 mont_mul(ctx, y1, hhh))
    z3 = mont_mul(ctx, z1, h)
    general = (x3, y3, z3)

    n, dev = x1.shape[0], x1.device
    p_inf = _is_zero_row(z1)
    h_zero = _is_zero_row(h)
    r_zero = _is_zero_row(rr)
    doubled = _dbl(ctx, p)
    inf = (_zeros(n, dev),) * 3
    one = _const_mont(ctx, 1, n, dev)
    lifted = (ex, ey, one)

    out = _select(h_zero & r_zero, doubled, general)  # P == E
    out = _select(h_zero & ~r_zero & ~p_inf, inf, out)  # P == −E
    out = _select(p_inf, lifted, out)
    out = _select(e_inf, p, out)  # E == ∞ (also wins when both ∞)
    return out


def _fb_digit(u_plain: torch.Tensor, j: int) -> torch.Tensor:
    """4-bit window j of (n, L) plain 12-bit limb rows; 12 = 3·4 so
    windows never straddle a limb."""
    return (u_plain[:, j // 3] >> (4 * (j % 3))) & 15


def _glv_digits(s_plain: torch.Tensor, w: int) -> torch.Tensor:
    """2-bit window w of a half-scalar's limb rows."""
    return (s_plain[:, w // 6] >> (2 * (w % 6))) & 3


def _recover_glv(u1_plain, s1_plain, s2_plain, e1_neg, e2_neg, rx, ry):
    """u1·G + (e1·s1)·R + (e2·s2)·λR → affine Montgomery (x, y) and a
    not-∞ flag. Scalars are plain limb rows (s1, s2 < 2^129); rx/ry is
    the lifted R in affine Montgomery; e*_neg are bool lanes for the
    GLV component signs."""
    ctx = CTX_P
    n, dev = u1_plain.shape[0], u1_plain.device
    inf = (_zeros(n, dev),) * 3
    one = _const_mont(ctx, 1, n, dev)

    # --- fixed-base sum: 64 window adds, no doublings ------------------
    fbx, fby = _fb_tables().on(dev)
    fb = inf
    for j in range(FB_WINDOWS):
        d = _fb_digit(u1_plain, j).long()
        fb = _add_mixed(ctx, fb, fbx[j][d], fby[j][d], d == 0)

    # --- GLV joint ladder over P1 = e1·R, P2 = e2·λR -------------------
    neg_ry = sub_mod(ctx, _zeros(n, dev), ry)
    y1 = torch.where(e1_neg[:, None], neg_ry, ry)
    y2 = torch.where(e2_neg[:, None], neg_ry, ry)
    beta = _const_mont(ctx, GLV_BETA, n, dev)
    x2 = mont_mul(ctx, rx, beta)
    p1 = (rx, y1, one)
    p2 = (x2, y2, one)

    # 16-entry joint table i·P1 + j·P2, (n, 16, L) per coord. The 13
    # point ops ride 3 batched group ops on stacked lane blocks:
    #   [2P1|2P2] = dbl([P1|P2]);  [3P1|3P2] = [2P1|2P2] + [P1|P2];
    #   the 9 interior entries = one 9n-lane add A[i] + B[j].
    p12 = tuple(torch.cat([a, b]) for a, b in zip(p1, p2))
    d12 = _dbl(ctx, p12)
    t12 = _add(ctx, d12, p12)
    a_row = [inf, p1, tuple(c[:n] for c in d12), tuple(c[:n] for c in t12)]
    b_row = [inf, p2, tuple(c[n:] for c in d12), tuple(c[n:] for c in t12)]
    big_a = tuple(torch.cat([a_row[ii][c] for jj in range(1, 4)
                             for ii in range(1, 4)])
                  for c in range(3))
    big_b = tuple(torch.cat([b_row[jj][c] for jj in range(1, 4)
                             for ii in range(1, 4)])
                  for c in range(3))
    sums = _add(ctx, big_a, big_b)
    entries = []
    for jj in range(4):
        for ii in range(4):
            if jj == 0:
                entries.append(a_row[ii])
            elif ii == 0:
                entries.append(b_row[jj])
            else:
                k = (jj - 1) * 3 + (ii - 1)
                entries.append(tuple(
                    c[k * n:(k + 1) * n] for c in sums))
    table = [torch.stack([e[c] for e in entries], dim=1)
             for c in range(3)]  # 3 × (n, 16, L)

    glv = inf
    for i in range(GLV_WINDOWS):
        w = GLV_WINDOWS - 1 - i
        glv = _dbl(ctx, _dbl(ctx, glv))
        idx = _glv_digits(s1_plain, w) + 4 * _glv_digits(s2_plain, w)
        glv = _add(ctx, glv, _gather_entry(table, idx))

    # --- combine + affine ---------------------------------------------
    pt = _add(ctx, glv, fb)
    not_inf = ~_is_zero_row(pt[2])
    ax, ay = _to_affine(ctx, pt)
    return (from_mont(ctx, ax), from_mont(ctx, ay), not_inf)


# --- public batch ops -------------------------------------------------------

def verify_batch(rs, ss, msgs, pub_points, device=None) -> np.ndarray:
    """Batched ECDSA verification, one ladder for the whole batch.

    Twin of ``crypto.secp256k1.EcdsaVerifier.verify`` (itself mirroring
    ``ecdsa/native.rs:382-395``): R' = (m·s⁻¹)·G + (r·s⁻¹)·Q, accept iff
    R' ≠ ∞ and R'.x mod n == r. Zero r/s and default (0, 0) pubkeys are
    rejected exactly like the scalar path.

    rs, ss, msgs: int lists; pub_points: [(x, y)] affine ints.
    Returns a bool numpy array.
    """
    dev = resolve_device(device)
    # r stays UNreduced for the final comparison: the scalar path
    # compares R'.x mod n against the raw signature r, so r >= n can
    # never verify (no malleability via r + n); only the u2 scalar uses
    # r mod n, exactly like the host's  u2 = sig.r * s_inv % N.
    r_raw = to_device(rs, dev)
    s_pl = to_device([v % SECP_N for v in ss], dev)
    s_m = to_mont(CTX_N, s_pl)
    m_m = to_mont(CTX_N, to_device([v % SECP_N for v in msgs], dev))
    r_m = to_mont(CTX_N, to_device([v % SECP_N for v in rs], dev))

    s_inv = inv_mod(CTX_N, s_m)
    u1 = from_mont(CTX_N, mont_mul(CTX_N, m_m, s_inv))
    u2 = from_mont(CTX_N, mont_mul(CTX_N, r_m, s_inv))

    qx = to_mont(CTX_P, to_device([p[0] for p in pub_points], dev))
    qy = to_mont(CTX_P, to_device([p[1] for p in pub_points], dev))

    rpt = _strauss(u1, u2, (qx, qy))
    not_inf = ~_is_zero_row(rpt[2])
    ax, _ = _to_affine(CTX_P, rpt)
    x_plain = from_mont(CTX_P, ax)
    x_mod_n = _mod_n_plain(x_plain)
    x_matches = (x_mod_n == r_raw).all(dim=1)

    nonzero = ~(_is_zero_row(r_raw) | _is_zero_row(s_pl))
    pk_ok = torch.tensor(
        [not (p[0] == 0 and p[1] == 0) for p in pub_points], device=dev)
    return (not_inf & x_matches & nonzero & pk_ok).cpu().numpy()


def _recover_prep(r_pl, rn_pl, m_pl, s_pl, want_odd):
    """Lift R from (r, parity) and derive the recovery scalars — the
    challenge-independent front half of recovery."""
    k, dev = r_pl.shape[0], r_pl.device
    r_m = to_mont(CTX_P, r_pl)

    # lift_x: y = (x³ + 7)^((p+1)/4); valid iff y² == x³ + 7
    x3 = mont_mul(CTX_P, r_m, mont_mul(CTX_P, r_m, r_m))
    rhs = add_mod(CTX_P, x3, _const_mont(CTX_P, 7, k, dev))
    y = mont_pow(CTX_P, rhs, (SECP_P + 1) // 4)
    lift_ok = (mont_mul(CTX_P, y, y) == rhs).all(dim=1)

    # parity select: plain lsb vs rec_id (host recover_public_key lifts
    # with bool(rec_id): ANY nonzero rec_id selects the odd-y point)
    y_plain = from_mont(CTX_P, y)
    y_odd = y_plain[:, 0] & 1
    y_neg = sub_mod(CTX_P, _zeros(k, dev), y)
    y_sel = torch.where((y_odd == want_odd)[:, None], y, y_neg)

    # scalars: u1 = −m·r⁻¹, u2 = s·r⁻¹ (mod n)
    rn_m = to_mont(CTX_N, rn_pl)
    r_inv = inv_mod(CTX_N, rn_m)
    m_m = to_mont(CTX_N, m_pl)
    s_m = to_mont(CTX_N, s_pl)
    u1 = sub_mod(CTX_N, torch.zeros_like(m_m),
                 mont_mul(CTX_N, m_m, r_inv))
    u2 = mont_mul(CTX_N, s_m, r_inv)
    return (r_m, y_sel, lift_ok,
            from_mont(CTX_N, u1), from_mont(CTX_N, u2))


def recover_submit(rs, ss, rec_ids, msgs, device=None, _prep=None):
    """Phase 1 of the split recovery: host limb prep + the
    challenge-independent ``_recover_prep`` launches (which return
    before the card is done). The split exists so a chunked caller can
    software-pipeline: while the card runs chunk i's ladder, the host
    builds chunk i+1's limbs here (``recover_stream``). ``_prep`` stands
    in for ``_recover_prep`` with the same arguments and results (the
    lane-sharded stage of ``parallel/ingest.py``)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    k = len(rs)
    rs = [int(v) for v in rs]
    ss = [int(v) for v in ss]
    r_pl = to_device([v % SECP_P for v in rs], dev)
    rn_pl = to_device([v % SECP_N for v in rs], dev)
    m_pl = to_device([v % SECP_N for v in msgs], dev)
    s_pl = to_device([v % SECP_N for v in ss], dev)
    want_odd = torch.tensor([int(bool(v)) for v in rec_ids],
                            dtype=torch.int32, device=dev)
    range_ok = np.array([0 < r < SECP_N and s % SECP_N != 0
                         for r, s in zip(rs, ss)], dtype=bool)
    HOST_SECONDS["limb_prep"] += time.perf_counter() - t0
    prep = (_prep or _recover_prep)(r_pl, rn_pl, m_pl, s_pl, want_odd)
    return (k, prep, range_ok)


def recover_midstage(handle, _glv=None):
    """Phase 2: download u2 (waits for phase 1), host-side Babai GLV
    split, then the ladder's launches (which return before the card is
    done). ``_glv`` stands in for ``_recover_glv`` as ``_prep`` does for
    the prep stage."""
    k, (r_m, y_sel, lift_ok, u1, u2), range_ok = handle
    u2_host = u2.cpu().numpy()
    t0 = time.perf_counter()
    u2_ints = from_limbs(u2_host)
    e1_neg = np.zeros(k, dtype=bool)
    e2_neg = np.zeros(k, dtype=bool)
    halves1, halves2 = [], []
    for i, u in enumerate(u2_ints):
        h1, e1, h2, e2 = glv_decompose(u)
        halves1.append(h1)
        halves2.append(h2)
        e1_neg[i] = e1 < 0
        e2_neg[i] = e2 < 0
    dev = u2.device
    s1l = to_device(halves1, dev)
    s2l = to_device(halves2, dev)
    e1t = torch.from_numpy(e1_neg).to(dev)
    e2t = torch.from_numpy(e2_neg).to(dev)
    HOST_SECONDS["glv_split"] += time.perf_counter() - t0
    ax, ay, not_inf = (_glv or _recover_glv)(u1, s1l, s2l, e1t, e2t, r_m,
                                             y_sel)
    return (ax, ay, lift_ok, not_inf, range_ok)


def recover_finalize(handle):
    """Phase 3: download the affine results (waits for the ladder) and
    assemble the validity mask."""
    ax, ay, lift_ok, not_inf, range_ok = handle
    t0 = time.perf_counter()
    xs = from_limbs(ax.cpu().numpy())
    ys = from_limbs(ay.cpu().numpy())
    ok = (lift_ok & not_inf).cpu().numpy() & range_ok
    HOST_SECONDS["unpack"] += time.perf_counter() - t0
    return xs, ys, ok


def recover_stream(chunks, device=None, _prep=None, _glv=None):
    """Pipelined recovery over an iterable of (rs, ss, rec_ids, msgs)
    chunks, yielding (xs, ys, valid) per chunk in order.

    Two chunks are in flight: while the card runs chunk i's GLV ladder
    (the dominant span), the host builds chunk i+1's limbs and queues
    its prep. Results are bit-identical to per-chunk ``recover_batch``
    (same kernels, same order within a chunk)."""
    dev = resolve_device(device)
    mid = None
    for ch in chunks:
        sub = recover_submit(*ch, device=dev, _prep=_prep)
        if mid is not None:
            yield recover_finalize(mid)
        mid = recover_midstage(sub, _glv=_glv)
    if mid is not None:
        yield recover_finalize(mid)


def recover_batch(rs, ss, rec_ids, msgs, device=None, _prep=None,
                  _glv=None):
    """Batched pubkey recovery: pk = r⁻¹·(s·R − m·G) with R lifted from
    (r, rec_id) — the ingest hot path (``ecdsa/native.rs:298-331``), on
    the GLV + fixed-base-window ladder (``_recover_glv``).

    Returns (xs, ys, valid): affine coordinate int lists and a bool
    array. A lane is valid iff r ∈ [1, n), s ≢ 0 (mod n), r lifts onto
    the curve and the result is not ∞ — EXACTLY the acceptance set of
    the scalar pipeline (recover, then verify with the recovered key):
    verify mod-reduces s, rejects r = 0 / r ≥ n through the final
    R'.x ≡ r comparison, and rejects the crafted sR = mG identity-key
    case via ``is_default``. Within that set recover⇒verify is an
    algebraic identity (R' = s⁻¹·(z·G + s·R − z·G) = R), so a True
    lane's key is guaranteed to verify.

    Composition of recover_submit → recover_midstage → recover_finalize;
    chunked callers pipeline the phases via ``recover_stream``."""
    return recover_finalize(recover_midstage(
        recover_submit(rs, ss, rec_ids, msgs, device=device, _prep=_prep),
        _glv=_glv))
