"""Native-accelerated PLONK keygen/prover on the C++ kernel layer.

The reference's proving stack is native end-to-end (Rust halo2 — MSMs,
FFTs and the quotient loop all run compiled; ``eigentrust-zk`` merely
drives it). This module is the framework's equivalent: a mirror of
``plonk.keygen``/``plonk.prove`` whose polynomial and curve arithmetic
lives in ``csrc/prover_native.cpp`` (Montgomery NTT, Pippenger MSM,
grand-product / LogUp / quotient kernels), with Python keeping only the
Fiat–Shamir transcript and protocol orchestration.

The port of ``protocol_tpu/zk/prover_fast.py``: the host path is the
reference's, copied; rounds 3–4 of ``prove_fast_tpu`` run on the
torch/CUDA device prover (``zk/prover_tpu.py``). Two seams differ:
``prove_auto`` raises when the device prove fails on a CUDA device
(the reference falls back to the host), and the stage series carry
``path="device"`` with ``prove_device.*`` spans where the reference's
read ``path="tpu"`` and ``prove_tpu.*``.

Proofs are byte-identical in format and transcript-compatible with
``plonk.prove``: anything produced here verifies under
``plonk.verify``/``succinct_verify`` (and therefore under the in-circuit
aggregator) with no changes — ``FastProvingKey`` duck-types the vk
fields those consumers read (k, shifts, public_rows, lookup_bits,
vk_commits, commit_list, domain).

Data layout: (n, 4) little-endian uint64 limb arrays in standard
(non-Montgomery) form throughout; conversions happen once at the wire
boundary (witness columns in, transcript scalars out).
"""

from __future__ import annotations

import contextlib
import json
import os
import secrets
import threading
from dataclasses import dataclass

import numpy as np

from ..native import prover as native
from ..utils import trace
from ..utils.errors import EigenError
from ..utils.fields import BN254_FR_MODULUS
from .bn254 import BN254_FQ_MODULUS, G1_GEN
from .commit_engine import CommitEngine
from .domain import EvaluationDomain
from .kzg import KZGParams, g1_from_bytes, g1_to_bytes
from .plonk import (
    FIXED_NAMES,
    LOOKUP_WIRE,
    MIN_K,
    NUM_PERM_PARTIALS,
    NUM_WIRES,
    QUOTIENT_CHUNKS,
    SELECTORS,
    ConstraintSystem,
    Proof,
    _find_coset_shifts,
    _table_values,
)
from .shards import shard_fanout, shard_map, split_ranges
from .transcript import PoseidonTranscript, make_transcript

R = BN254_FR_MODULUS
Q = BN254_FQ_MODULUS

# The prove stage graph's parallelizable stage sets — the work units an
# installed shard runner (zk/shards.py; the pool's worker lending) fans
# out, per path. Everything else is transcript-sequential: each round's
# commits must be absorbed before the challenges the next round
# consumes, so intra-prove parallelism lives INSIDE stages, never
# across them. Host path: the K commit columns per engine flush, the
# row-sliced quotient evaluation (the native kernel is pointwise per
# evaluation row — bit-exact under any row split), and the two opening
# folds. Device path: only the commit flushes — quotient chunks, ext
# builds and the opening folds are device-resident there, and the
# per-device dispatch queue is a serially-owned resource. LOAD-BEARING
# for the host quotient/openings stages (their shard paths gate on
# membership here — removing an entry reverts that stage to inline);
# the commit.* entries describe the engine, which shards identically
# on both paths.
SHARDABLE_STAGES = {
    "host": ("commit.r1", "commit.r2", "quotient", "commit.t",
             "openings", "commit.open"),
    "device": ("commit.r1", "commit.r2", "commit.t", "commit.open"),
}


def available() -> bool:
    return native.available()


def _kernel() -> native.FieldKernel:
    return native.FieldKernel(R)


def _get_int(arr: np.ndarray, i: int) -> int:
    return int.from_bytes(arr[i].tobytes(), "little")


def _set_int(arr: np.ndarray, i: int, v: int) -> None:
    arr[i] = np.frombuffer(int(v % R).to_bytes(32, "little"), dtype="<u8")


def _parse_key_header(data: bytes) -> tuple:
    """(header_dict, payload_offset) for either serialized key format:
    FPK1 (limb arrays after a JSON header) or the pure-Python
    ProvingKey's bare JSON (payload_offset = None)."""
    if data[:4] in (b"FPK1", b"FPK2"):
        hlen = int.from_bytes(data[4:12], "little")
        return json.loads(data[12 : 12 + hlen].decode()), 12 + hlen
    try:
        return json.loads(data.decode()), None
    except (UnicodeDecodeError, ValueError) as e:
        raise EigenError("proving_error",
                         "unrecognized proving key format") from e


def _decode_vk_commits(header: dict) -> dict:
    return {name: g1_from_bytes(bytes.fromhex(h))
            for name, h in header["vk_commits"].items()}


# --- SRS limb cache --------------------------------------------------------

def srs_limbs(params: KZGParams) -> np.ndarray:
    """(n, 8) limb view of the G1 powers, cached on the params object."""
    cached = getattr(params, "_srs_limbs", None)
    if cached is None or len(cached) != len(params.g1_powers):
        cached = native.points_to_limbs(params.g1_powers)
        params._srs_limbs = cached
    return cached


def commit_limbs(params: KZGParams, coeffs: np.ndarray):
    """MSM commit of a (n, 4) coefficient array → affine point or None."""
    if len(coeffs) > len(params.g1_powers):
        raise EigenError("proving_error", "poly exceeds SRS")
    return native.g1_msm(Q, srs_limbs(params)[: len(coeffs)], coeffs)


def lagrange_limbs(params: KZGParams) -> np.ndarray:
    """(n, 8) limb view of the Lagrange-basis G1 points, cached."""
    if params.g1_lagrange is None:
        raise EigenError("proving_error",
                         "params carry no Lagrange basis (regenerate with "
                         "setup_params_fast)")
    cached = getattr(params, "_lag_limbs", None)
    if cached is None or len(cached) != len(params.g1_lagrange):
        cached = native.points_to_limbs(params.g1_lagrange)
        params._lag_limbs = cached
    return cached


def _msm_signed(bases: np.ndarray, scalars: np.ndarray):
    """MSM with scalar-balancing: each scalar s is replaced by
    min(s, R−s) with the base's y negated when R−s is the smaller —
    a scalar like −1 (= R−1, full-width) then costs one window pass
    instead of seventeen. Pays off whenever a column is ±small
    (selector/coefficient columns); a wash on dense columns. The limb
    compare + borrow subtract is the shared
    ``commit_engine.balance_rows`` core (the engine's batched path
    applies the SAME balancing as per-column flips)."""
    from .commit_engine import balance_rows

    flipped = scalars.astype(np.uint64, copy=True)
    ge = balance_rows(flipped)
    if not ge.any():
        return native.g1_msm(Q, bases, scalars)
    rows = np.nonzero(ge)[0]
    # negate base y for flipped rows: y' = Q - y (y == 0 stays 0)
    b = bases.astype(np.uint64, copy=True)
    Q_limbs = np.frombuffer(int(Q).to_bytes(32, "little"), dtype="<u8")
    y = b[rows][:, 4:8]
    nz = (y != 0).any(axis=1)
    yr = rows[nz]
    borrow = np.zeros(len(yr), dtype=np.uint64)
    for j in range(4):
        sub = b[yr, 4 + j] + borrow
        wrapped = sub < borrow
        diff = Q_limbs[j] - sub
        new_borrow = ((Q_limbs[j] < sub) | wrapped).astype(np.uint64)
        b[yr, 4 + j] = diff
        borrow = new_borrow
    return native.g1_msm(Q, np.ascontiguousarray(b),
                         np.ascontiguousarray(flipped))


def commit_evals_limbs(params: KZGParams, evals: np.ndarray):
    """Commit a polynomial from its evaluations on the 2^k domain via the
    Lagrange-basis SRS: commit(p) = Σ p(ωⁱ)·L_i(τ)·G — no iNTT. Equals
    ``commit_limbs(params, intt(evals))`` exactly (tested)."""
    n = 1 << params.k
    if len(evals) != n:
        raise EigenError("proving_error", "evals length must equal 2^k")
    return _msm_signed(lagrange_limbs(params), evals)


def setup_params_fast(k: int, extra: int = 8, seed: bytes | None = None
                      ) -> KZGParams:
    """``KZGParams.setup`` with the powers-of-τ G1 chain on the native
    fixed-base kernel (identical output for identical seed). Also emits
    the Lagrange-basis G1 points L_i(τ)·G over the 2^k domain — the
    setup is the one party that knows τ, exactly like real trusted
    setups that publish both bases — enabling commits straight from
    evaluations (``commit_evals_limbs``)."""
    n = (1 << k) + extra
    if seed is None:
        tau = secrets.randbelow(R - 1) + 1
    else:
        tau = int.from_bytes(seed + b"kzg-tau", "little") % (R - 1) + 1
    powers = [1] * n
    for i in range(1, n):
        powers[i] = powers[i - 1] * tau % R
    from .bn254 import g2_mul, G2_GEN

    def aff_list(pts_arr, count):
        vals = native.limbs_to_ints(pts_arr.reshape(-1, 4))
        out = []
        for i in range(count):
            x, y = vals[2 * i], vals[2 * i + 1]
            out.append(None if x == 0 and y == 0 else (x, y))
        return out

    pts = native.g1_fixed_base_muls(Q, G1_GEN, native.ints_to_limbs(powers))
    g1_powers = aff_list(pts, n)

    # Lagrange scalars L_i(τ) = ωⁱ·(τⁿ−1) / (n·(τ−ωⁱ)) over H = <ω>,
    # n = 2^k; computed with the native field kernels then turned into
    # points with the fixed-base ladder.
    nn = 1 << k
    d = EvaluationDomain(k)
    fk = _kernel()
    omegas = np.zeros((nn, 4), dtype="<u8")
    omegas[:, 0] = 1
    fk.coset_scale(omegas, d.omega)                    # ωⁱ
    den = fk.scalar_mul(fk.scalar_sub(omegas, tau), (R - nn) % R)
    fk.batch_inverse(den)                              # 1/(n(τ−ωⁱ))
    zh_tau = (pow(tau, nn, R) - 1) % R
    lag_scalars = fk.vec_mul(fk.scalar_mul(omegas, zh_tau), den)
    lag_pts = native.g1_fixed_base_muls(Q, G1_GEN, lag_scalars)
    g1_lagrange = aff_list(lag_pts, nn)
    return KZGParams(k, g1_powers, g2_mul(G2_GEN, tau), g1_lagrange)


# --- proving key -----------------------------------------------------------

@dataclass
class FastProvingKey:
    """Keygen output in limb-array form. Duck-types the ``ProvingKey``
    surface that ``succinct_verify``/``verify``/the aggregator touch."""

    k: int
    fixed_limbs: np.ndarray  # (9, n, 4), FIXED_NAMES order (see eval_form)
    sigma_limbs: np.ndarray  # (6, n, 4)
    sigma_eval_limbs: np.ndarray  # (6, n, 4) row form
    shifts: list
    public_rows: list
    lookup_bits: int | None
    vk_commits: dict
    # eval_form=True (FPK2): fixed_limbs/sigma_limbs hold EVALS on H, and
    # sigma_eval_limbs aliases sigma_limbs; False (FPK1): coefficients.
    eval_form: bool = False

    def domain(self) -> EvaluationDomain:
        return EvaluationDomain(self.k)

    def commit_list(self) -> list:
        return ([self.vk_commits[name] for name in FIXED_NAMES]
                + [self.vk_commits[f"sigma_{w}"] for w in range(NUM_WIRES)])

    def coeff_forms(self):
        """(fixed_coeffs, sigma_coeffs) — identity for FPK1; for FPK2,
        host-iNTTs of the evals, cached (the device prove path derives
        these on device instead)."""
        if not self.eval_form:
            return self.fixed_limbs, self.sigma_limbs
        cached = getattr(self, "_coeffs", None)
        if cached is None:
            fk = _kernel()
            omega = self.domain().omega
            fixed = self.fixed_limbs.copy()
            for idx in range(len(FIXED_NAMES)):
                fk.ntt(fixed[idx], omega, inverse=True)
            sigma = self.sigma_limbs.copy()
            for w in range(NUM_WIRES):
                fk.ntt(sigma[w], omega, inverse=True)
            cached = self._coeffs = (fixed, sigma)
        return cached

    def to_bytes(self) -> bytes:
        header = json.dumps({
            "k": self.k,
            "shifts": self.shifts,
            "public_rows": self.public_rows,
            "lookup_bits": self.lookup_bits,
            "eval_form": self.eval_form,
            "vk_commits": {name: g1_to_bytes(pt).hex()
                           for name, pt in self.vk_commits.items()},
        }).encode()
        magic = b"FPK2" if self.eval_form else b"FPK1"
        return (magic + len(header).to_bytes(8, "little") + header
                + np.ascontiguousarray(self.fixed_limbs).tobytes()
                + np.ascontiguousarray(self.sigma_limbs).tobytes())

    @classmethod
    def from_bytes(cls, data: bytes) -> "FastProvingKey":
        if data[:4] not in (b"FPK1", b"FPK2"):
            raise EigenError("proving_error", "bad proving key magic")
        p, off = _parse_key_header(data)
        n = 1 << p["k"]
        fixed = np.frombuffer(data, dtype="<u8", count=9 * n * 4,
                              offset=off).reshape(9, n, 4).copy()
        off += 9 * n * 4 * 8
        sigma = np.frombuffer(data, dtype="<u8", count=6 * n * 4,
                              offset=off).reshape(6, n, 4).copy()
        if p.get("eval_form"):
            # FPK2: arrays are evals; the row form IS sigma_limbs
            return cls(p["k"], fixed, sigma, sigma, p["shifts"],
                       p["public_rows"], p.get("lookup_bits"),
                       _decode_vk_commits(p), eval_form=True)
        # sigma row form is derivable — recompute so the two copies can
        # never disagree in a key file (same rule as ProvingKey.to_bytes)
        fk = _kernel()
        omega = EvaluationDomain(p["k"]).omega
        sigma_evals = np.empty_like(sigma)
        for w in range(NUM_WIRES):
            sigma_evals[w] = fk.ntt(sigma[w].copy(), omega)
        return cls(p["k"], fixed, sigma, sigma_evals, p["shifts"],
                   p["public_rows"], p.get("lookup_bits"),
                   _decode_vk_commits(p))


@dataclass
class VerifyingKey:
    """vk-only view of a serialized proving key: everything
    ``succinct_verify``/``verify`` touch (domain, shifts, public rows,
    vk commitments) without the coefficient columns — verification
    never needs them, and at k=22 they are ~0.5 GB of limb data."""

    k: int
    shifts: list
    public_rows: list
    lookup_bits: int | None
    vk_commits: dict

    def domain(self) -> EvaluationDomain:
        return EvaluationDomain(self.k)

    def commit_list(self) -> list:
        return ([self.vk_commits[name] for name in FIXED_NAMES]
                + [self.vk_commits[f"sigma_{w}"] for w in range(NUM_WIRES)])

    @classmethod
    def from_key_bytes(cls, data: bytes) -> "VerifyingKey":
        """Parse either key format (FPK1 limb-array or the slow path's
        JSON), reading only the header fields."""
        p, _ = _parse_key_header(data)
        return cls(p["k"], p["shifts"], p["public_rows"],
                   p.get("lookup_bits"), _decode_vk_commits(p))


def natural_k(cs: ConstraintSystem) -> int:
    """The smallest domain exponent a circuit fits — the k that
    ``keygen_fast``/``plonk.keygen`` pick when none is forced. Shared
    with api._keygen's SRS-domain snap so the two can't diverge."""
    k = max(MIN_K, (max(cs.num_rows, 1) - 1).bit_length())
    if cs.lookup_bits:
        k = max(k, cs.lookup_bits)
    return k


def keygen_fast(params: KZGParams, cs: ConstraintSystem,
                k: int | None = None,
                eval_pk: bool = False) -> FastProvingKey:
    """``plonk.keygen`` on native kernels; same key material.

    ``eval_pk`` returns the key in evaluation form (FPK2): the fixed and
    sigma columns stay as evals on H and keygen runs NO iNTTs — commits
    come from the Lagrange basis (required) plus the σ = shift·SRS[1] +
    swapped-cell-correction identity. The vk commitments are identical
    to the coefficient-form key's."""
    rows = cs.num_rows
    if k is None:
        k = natural_k(cs)
    if k < MIN_K:
        raise EigenError("circuit_error",
                         f"k={k} below minimum domain size k={MIN_K}")
    n = 1 << k
    if rows > n:
        raise EigenError("circuit_error", f"{rows} rows exceed 2^{k}")
    fk = _kernel()
    d = EvaluationDomain(k)
    _table_values(cs.lookup_bits, n)  # validates table fits the domain

    # fixed columns: scatter the sparse selector maps; commit from the
    # EVALS when the params carry a Lagrange basis (selector values are
    # 0/1/small, so the signed-window MSM skips all high windows), then
    # iNTT in place for the pk polys
    use_lagrange = (params.g1_lagrange is not None
                    and len(params.g1_lagrange) == n)
    if eval_pk == "auto":
        eval_pk = use_lagrange
    if eval_pk and not use_lagrange:
        raise EigenError(
            "proving_error",
            "eval_pk keygen needs params with a matching Lagrange basis")
    fixed = np.zeros((len(FIXED_NAMES), n, 4), dtype="<u8")
    for idx, name in enumerate(SELECTORS):
        sel = cs.selectors[name]
        if sel:
            rows_idx = np.fromiter(sel.keys(), dtype=np.int64)
            # selector columns hold few DISTINCT values (0/±1/small
            # constants) — convert each distinct value once and gather,
            # instead of millions of int→bytes conversions
            vals = list(sel.values())
            uniq = list(set(vals))
            uniq_limbs = native.ints_to_limbs(uniq)
            lut = {v: i for i, v in enumerate(uniq)}
            sel_idx = np.fromiter((lut[v] for v in vals), dtype=np.int64,
                                  count=len(vals))
            fixed[idx, rows_idx] = uniq_limbs[sel_idx]
    table_size = 1 << cs.lookup_bits if cs.lookup_bits else 1
    fixed[len(SELECTORS), :table_size, 0] = np.arange(table_size,
                                                      dtype=np.uint64)
    vk_commits = {}
    if use_lagrange:
        for idx, name in enumerate(FIXED_NAMES):
            vk_commits[name] = commit_evals_limbs(params, fixed[idx])
    fixed_evals = fixed
    if not eval_pk:
        for idx in range(len(FIXED_NAMES)):
            fk.ntt(fixed[idx], d.omega, inverse=True)

    # permutation σ: baseline shifts[w]·ωʳ, then swap along copy cycles.
    # Union-find only over cells that appear in copies — every other cell
    # keeps its identity image (the full 6n-cell map of the slow path is
    # never materialized).
    shifts = _find_coset_shifts(n, NUM_WIRES)
    omegas = np.zeros((n, 4), dtype="<u8")
    omegas[:, 0] = 1
    fk.coset_scale(omegas, d.omega)  # omegas[i] = ωⁱ

    sigma_evals = np.empty((NUM_WIRES, n, 4), dtype="<u8")
    for w in range(NUM_WIRES):
        sigma_evals[w] = fk.scalar_mul(omegas, shifts[w])

    parent: dict = {}
    nxt: dict = {}

    def find(x):
        while parent.get(x, x) != x:
            parent[x] = parent.get(parent[x], parent[x])
            x = parent[x]
        return x

    for a, b in cs.copies:
        if a not in nxt:
            nxt[a] = a
        if b not in nxt:
            nxt[b] = b
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        parent[ra] = rb
        nxt[a], nxt[b] = nxt[b], nxt[a]
    # apply the cycle swaps with vectorized gathers: group the nxt map
    # by (wire, target wire) — at most 36 numpy fancy assignments instead
    # of a per-cell Python loop (millions of cells at k=20)
    shifted = [sigma_evals[w].copy() for w in range(NUM_WIRES)]
    groups: dict = {}
    for (w, r), (tw, tr) in nxt.items():
        g = groups.get((w, tw))
        if g is None:
            g = groups[(w, tw)] = ([], [])
        g[0].append(r)
        g[1].append(tr)
    swapped_rows: list = [[] for _ in range(NUM_WIRES)]
    for (w, tw), (rs, trs) in groups.items():
        rs_a = np.asarray(rs, dtype=np.int64)
        sigma_evals[w][rs_a] = shifted[tw][np.asarray(trs, dtype=np.int64)]
        swapped_rows[w].append(rs_a)

    if use_lagrange:
        # σ_w evals are shift_w·ωʳ EXCEPT at cells in copy cycles, and
        # Σ_r ωʳ·L_r(τ)G = τG = SRS[1] (the poly with evals ωʳ is X), so
        # commit(σ_w) = shift_w·SRS[1] + Σ_{swapped r} (σ_w(ωʳ) −
        # shift_w·ωʳ)·L_r(τ)G — an MSM over only the swapped cells.
        from .bn254 import g1_add, g1_mul

        lag = lagrange_limbs(params)
        for w in range(NUM_WIRES):
            rows_w = (np.concatenate(swapped_rows[w])
                      if swapped_rows[w] else np.empty(0, dtype=np.int64))
            base = g1_mul(params.g1_powers[1], shifts[w])
            if len(rows_w):
                diff = fk.vec_sub(
                    np.ascontiguousarray(sigma_evals[w][rows_w]),
                    np.ascontiguousarray(shifted[w][rows_w]))
                corr_pt = _msm_signed(
                    np.ascontiguousarray(lag[rows_w]), diff)
                base = g1_add(base, corr_pt)
            vk_commits[f"sigma_{w}"] = base

    if eval_pk:
        # evaluation-form key: no iNTTs at all — the prover derives any
        # coefficient forms it needs (on device in the device pipeline)
        return FastProvingKey(k, fixed_evals, sigma_evals, sigma_evals,
                              shifts, list(cs.public_rows), cs.lookup_bits,
                              vk_commits, eval_form=True)

    sigma = sigma_evals.copy()
    for w in range(NUM_WIRES):
        fk.ntt(sigma[w], d.omega, inverse=True)

    if not use_lagrange:
        for idx, name in enumerate(FIXED_NAMES):
            vk_commits[name] = commit_limbs(params, fixed[idx])
        for w in range(NUM_WIRES):
            vk_commits[f"sigma_{w}"] = commit_limbs(params, sigma[w])

    return FastProvingKey(k, fixed, sigma, sigma_evals, shifts,
                          list(cs.public_rows), cs.lookup_bits, vk_commits)


# --- prover ----------------------------------------------------------------

def _blind_arr(coeffs: np.ndarray, n: int, count: int, randint):
    """(b₀+b₁X+…)·Z_H blinding on a coefficient array; returns
    (array of length n+count, blinding values) — the blinds let eval-
    basis commits apply the correction Σ bᵢ·(SRS[n+i] − SRS[i])."""
    out = np.zeros((n + count, 4), dtype="<u8")
    out[: len(coeffs)] = coeffs[: n + count]
    blinds = []
    for i in range(count):
        b = randint()
        blinds.append(b)
        _set_int(out, i, (_get_int(out, i) - b) % R)
        _set_int(out, n + i, (_get_int(out, n + i) + b) % R)
    return out, blinds


def _commit_blinded_evals(params: KZGParams, evals: np.ndarray, blinds: list):
    """Commit p + Σ bᵢ(X^{n+i} − X^i)·1 from p's evals via the Lagrange
    basis: the Z_H-multiple blinding vanishes on H, so it re-enters as a
    τ-basis correction on 2·count SRS points."""
    from .bn254 import g1_add, g1_mul

    n = 1 << params.k
    cm = commit_evals_limbs(params, evals)
    for i, b in enumerate(blinds):
        if b == 0:
            continue
        cm = g1_add(cm, g1_mul(params.g1_powers[n + i], b))
        cm = g1_add(cm, g1_mul(params.g1_powers[i], (R - b) % R))
    return cm



def _perm_partial_vals(fk, wire_vals, sigma_eval_limbs, shifts, omegas,
                       z_vals, beta, gamma) -> list:
    """[u1, u2, v1, v2] H-evaluations of the z-split partial products
    (zk/plonk.py round 2c) on native kernels — shared by the host and
    device prove paths, which must stay transcript-lockstep."""
    def f_factor(w):
        t = fk.scalar_mul(omegas, beta * shifts[w] % R)
        t = fk.vec_add(t, wire_vals[w])
        return fk.scalar_add(t, gamma)

    def g_factor(w):
        t = fk.scalar_mul(np.ascontiguousarray(sigma_eval_limbs[w]), beta)
        t = fk.vec_add(t, wire_vals[w])
        return fk.scalar_add(t, gamma)

    zw = np.ascontiguousarray(np.roll(z_vals, -1, axis=0))  # z(ω·X) on H
    u1 = fk.vec_mul(fk.vec_mul(z_vals, f_factor(0)), f_factor(1))
    u2 = fk.vec_mul(fk.vec_mul(u1, f_factor(2)), f_factor(3))
    v1 = fk.vec_mul(fk.vec_mul(zw, g_factor(0)), g_factor(1))
    v2 = fk.vec_mul(fk.vec_mul(v1, g_factor(2)), g_factor(3))
    return [u1, u2, v1, v2]


def _lookup_multiplicities(cs: ConstraintSystem, n: int,
                           table_size: int) -> np.ndarray:
    """(n, 4) limb array of the LogUp multiplicity column — shared by
    the host and device prove paths, which must stay transcript-lockstep."""
    for v in cs.wires[LOOKUP_WIRE]:
        if v >= table_size:
            raise EigenError("proving_error",
                             f"lookup value {v} outside range table")
    lk_small = np.fromiter(cs.wires[LOOKUP_WIRE], dtype=np.int64,
                           count=cs.num_rows)
    m_small = np.bincount(lk_small, minlength=table_size).astype(np.uint64)
    m_small[0] += n - cs.num_rows  # padding rows pool at table entry 0
    m_vals = np.zeros((n, 4), dtype="<u8")
    m_vals[:table_size, 0] = m_small
    return m_vals


def _cuda_present() -> bool:
    """The device probe of :func:`prove_auto` (a seam tests fake)."""
    import torch

    return torch.cuda.is_available()


def prove_auto(params: KZGParams, pk: FastProvingKey, cs: ConstraintSystem,
               public_inputs=None, transcript: str = "poseidon",
               device=None) -> bytes:
    """Prove with the device round-3/4 engine when the key is eval-form,
    k ≤ 21 and the device is a CUDA device; else on the host.

    ``device`` names the torch device; ``None`` probes for a card and
    takes the first one when present, the host path otherwise (as the
    reference's probe does on a host without an accelerator). A named
    CPU device proves on the host.

    Unlike the reference, a device prove that fails RAISES: a failed
    device prove never turns silently into a host prove (ROADMAP C)."""
    import torch

    if device is None:
        dev = torch.device("cuda") if _cuda_present() else None
    else:
        dev = torch.device(device)
    # k ≤ 21 is the reference's device line; the port keeps its routing
    if (dev is not None and dev.type == "cuda" and pk.eval_form
            and pk.k <= 21):
        return prove_fast_tpu(params, pk, cs, public_inputs=public_inputs,
                              transcript=transcript, device=dev)
    return prove_fast(params, pk, cs, public_inputs=public_inputs,
                      transcript=transcript)


def prove_fast(params: KZGParams, pk: FastProvingKey, cs: ConstraintSystem,
               public_inputs=None, randint=None,
               transcript: str = "poseidon") -> bytes:
    """``plonk.prove`` on native kernels; transcript-identical, so the
    output verifies under ``plonk.verify``/``succinct_verify`` and
    aggregates under the aggregator chipset. ``randint`` overrides the
    blinding sampler (deterministic fixtures).

    Stage-attributed like the device path: every section reports into
    ``ptpu_prover_stage_seconds{stage,k,path="host"}``. The host path
    is synchronous, so its stage spans are exact without sync mode —
    which makes it the reference workload for the ``profile`` verb's
    coverage check (stage times must sum to ~the prove wall time)."""
    with _prove_total(pk.k, "host"):
        return _prove_fast_host(params, pk, cs, public_inputs, randint,
                                transcript)


def _prove_fast_host(params, pk, cs, public_inputs, randint,
                     transcript) -> bytes:
    if randint is None:
        randint = lambda: secrets.randbelow(R)  # noqa: E731
    fk = _kernel()
    d = pk.domain()
    n = d.n
    if cs.num_rows > n:
        raise EigenError("proving_error", "circuit larger than key domain")
    pubs = (list(public_inputs) if public_inputs is not None
            else cs.public_values())
    with _stage("transcript", pk.k, "host"):
        tr = make_transcript(transcript)
        for v in pubs:
            tr.absorb_fr(v)

    use_lagrange = (params.g1_lagrange is not None
                    and len(params.g1_lagrange) == n)
    eng = CommitEngine(params)

    def submit_column(label, evals, blinds, coeffs):
        # eval-basis (Lagrange) when the params carry it, else SRS
        # coefficients — the same rule the serial commits applied
        if use_lagrange:
            eng.submit_evals(label, evals, blinds)
        else:
            eng.submit_coeffs(label, coeffs)

    # round 1: wires + lookup multiplicities. Values, iNTTs and blind
    # draws run per column; the commits batch into ONE engine flush
    # (7 same-bases columns), absorbed in the historical order — the
    # blinding stream and the transcript sequence are unchanged.
    with _stage("witness_build", pk.k, "host"):
        wire_vals = np.zeros((NUM_WIRES, n, 4), dtype="<u8")
        for w in range(NUM_WIRES):
            col = cs.wires[w]
            if col:
                wire_vals[w, : len(col)] = native.ints_to_limbs(col)
        wire_coeffs = []
        wire_blinds = []
        for w in range(NUM_WIRES):
            c = wire_vals[w].copy()
            fk.ntt(c, d.omega, inverse=True)
            blinded, blinds = _blind_arr(c, n, 2, randint)
            wire_coeffs.append(blinded)
            wire_blinds.append(blinds)

    with _stage("lookup_build", pk.k, "host"):
        table_size = 1 << pk.lookup_bits if pk.lookup_bits else 1
        m_vals = _lookup_multiplicities(cs, n, table_size)
        m_coeffs_base = m_vals.copy()
        fk.ntt(m_coeffs_base, d.omega, inverse=True)
        m_coeffs, m_blinds = _blind_arr(m_coeffs_base, n, 2, randint)

    with _stage("commit.r1", pk.k, "host", labels=eng.stage_labels()):
        for w in range(NUM_WIRES):
            submit_column(f"wire{w}", wire_vals[w], wire_blinds[w],
                          wire_coeffs[w])
        submit_column("m", m_vals, m_blinds, m_coeffs)
        r1_points = eng.flush()
        wire_commits = r1_points[:NUM_WIRES]
        m_commit = r1_points[NUM_WIRES]
        for cm in wire_commits:
            tr.absorb_point(cm)
        tr.absorb_point(m_commit)

    with _stage("transcript", pk.k, "host"):
        beta = tr.challenge()
        gamma = tr.challenge()
        beta_lk = tr.challenge()

    # round 2a: permutation grand product (native kernel)
    with _stage("grand_product", pk.k, "host"):
        omegas = np.zeros((n, 4), dtype="<u8")
        omegas[:, 0] = 1
        fk.coset_scale(omegas, d.omega)
        z_vals = fk.perm_grand_product(wire_vals, pk.sigma_eval_limbs,
                                       pk.shifts, omegas, beta, gamma)
        z_base = z_vals.copy()
        fk.ntt(z_base, d.omega, inverse=True)
        z_coeffs, z_blinds = _blind_arr(z_base, n, 3, randint)

    # round 2b: LogUp running sum (native kernel)
    with _stage("logup_sum", pk.k, "host"):
        table_limbs = np.zeros((n, 4), dtype="<u8")
        table_limbs[:table_size, 0] = np.arange(table_size, dtype=np.uint64)
        phi_vals = fk.logup_running_sum(wire_vals[LOOKUP_WIRE], table_limbs,
                                        m_vals, beta_lk)
        phi_base = phi_vals.copy()
        fk.ntt(phi_base, d.omega, inverse=True)
        phi_coeffs, phi_blinds = _blind_arr(phi_base, n, 3, randint)

    # round 2c: z-split partial products (u1, u2, v1, v2)
    with _stage("partials", pk.k, "host"):
        uv_vals = _perm_partial_vals(fk, wire_vals, pk.sigma_eval_limbs,
                                     pk.shifts, omegas, z_vals, beta, gamma)
        uv_coeffs = []
        uv_blinds = []
        for vals in uv_vals:
            base = vals.copy()
            fk.ntt(base, d.omega, inverse=True)
            c, blinds = _blind_arr(base, n, 2, randint)
            uv_coeffs.append(c)
            uv_blinds.append(blinds)

    # round-2 commits batch into one flush (z, φ and the 4 partials
    # sit between the SAME two challenges — none of their values
    # depends on another round-2 commitment, only the absorb ORDER
    # matters, and that is preserved below)
    with _stage("commit.r2", pk.k, "host", labels=eng.stage_labels()):
        submit_column("z", z_vals, z_blinds, z_coeffs)
        submit_column("phi", phi_vals, phi_blinds, phi_coeffs)
        for i, vals in enumerate(uv_vals):
            submit_column(f"uv{i}", vals, uv_blinds[i], uv_coeffs[i])
        r2_points = eng.flush()
        z_commit, phi_commit = r2_points[0], r2_points[1]
        uv_commits = r2_points[2:]
        tr.absorb_point(z_commit)
        tr.absorb_point(phi_commit)
        for cm in uv_commits:
            tr.absorb_point(cm)

    with _stage("transcript", pk.k, "host"):
        alpha = tr.challenge()

    # round 3: quotient over the 4n extension coset (z-split)
    de = EvaluationDomain(pk.k + 2)
    ext_n = de.n
    shift = _find_coset_shifts(ext_n, 2)[1]

    def ext(coeffs: np.ndarray) -> np.ndarray:
        out = np.zeros((ext_n, 4), dtype="<u8")
        out[: len(coeffs)] = coeffs
        fk.coset_scale(out, shift)
        fk.ntt(out, de.omega)
        return out

    with _stage("ext_build", pk.k, "host"):
        wires_e = np.empty((NUM_WIRES, ext_n, 4), dtype="<u8")
        for w in range(NUM_WIRES):
            wires_e[w] = ext(wire_coeffs[w])
        z_e = ext(z_coeffs)
        zw_coeffs = z_coeffs.copy()
        fk.coset_scale(zw_coeffs, d.omega)  # z(ωX): cᵢ ← cᵢ·ωⁱ
        zw_e = ext(zw_coeffs)
        m_e = ext(m_coeffs)
        phi_e = ext(phi_coeffs)
        phiw_coeffs = phi_coeffs.copy()
        fk.coset_scale(phiw_coeffs, d.omega)
        phiw_e = ext(phiw_coeffs)
        uv_e = np.empty((NUM_PERM_PARTIALS, ext_n, 4), dtype="<u8")
        for j in range(NUM_PERM_PARTIALS):
            uv_e[j] = ext(uv_coeffs[j])
        pk_fixed_c, pk_sigma_c = pk.coeff_forms()
        fixed_e = np.empty((len(FIXED_NAMES), ext_n, 4), dtype="<u8")
        for idx in range(len(FIXED_NAMES)):
            fixed_e[idx] = ext(pk_fixed_c[idx])
        sigma_e = np.empty((NUM_WIRES, ext_n, 4), dtype="<u8")
        for w in range(NUM_WIRES):
            sigma_e[w] = ext(pk_sigma_c[w])
        pi_vals = np.zeros((n, 4), dtype="<u8")
        for row, value in zip(pk.public_rows, pubs):
            _set_int(pi_vals, row, (-int(value)) % R)
        fk.ntt(pi_vals, d.omega, inverse=True)
        pi_e = ext(pi_vals)

        # xs = shift·ω_e^i; Z_H(xs) has period 8 on the extension coset:
        # xs^n = shift^n·(ω_e^n)^i and ω_e has order 8n
        xs = np.zeros((ext_n, 4), dtype="<u8")
        _shift_limb = np.frombuffer(int(shift).to_bytes(32, "little"),
                                    dtype="<u8")
        xs[:] = _shift_limb
        fk.coset_scale(xs, de.omega)
        # Z_H on the 4n coset has period 4: xsⁿ = shiftⁿ·(ω_eⁿ)ⁱ, ω_e
        # order 4n
        w4 = pow(de.omega, n, R)
        shift_n = pow(shift, n, R)
        zh4 = [(shift_n * pow(w4, i, R) - 1) % R for i in range(4)]
        zh4_inv = [pow(v, -1, R) for v in zh4]
        reps = ext_n // 4
        zh_inv = np.tile(native.ints_to_limbs(zh4_inv), (reps, 1))
        zh_tiled = np.tile(native.ints_to_limbs(zh4), (reps, 1))
        # l0 = Z_H(x) / (n·(x−1))
        l0_den = fk.scalar_mul(fk.scalar_sub(xs, 1), n % R)
        fk.batch_inverse(l0_den)
        l0 = fk.vec_mul(zh_tiled, l0_den)

    with _stage("quotient", pk.k, "host"):
        def _quotient_rows(a: int, b: int) -> np.ndarray:
            # the quotient kernel is pointwise per evaluation row, so a
            # row slice of every operand computes the identical bytes
            # for its rows — the shard unit of the host quotient stage
            return fk.quotient_eval(
                wires_e[:, a:b], z_e[a:b], zw_e[a:b], m_e[a:b],
                phi_e[a:b], phiw_e[a:b], uv_e[:, a:b], fixed_e[:, a:b],
                sigma_e[:, a:b], pi_e[a:b], xs[a:b], zh_inv[a:b],
                l0[a:b], beta, gamma, beta_lk, alpha, pk.shifts)

        def _quotient_portable(a: int, b: int):
            # lazy payload: only materialized if the runner publishes
            # the unit to the cross-process fabric (external workers
            # registered) — the in-process path never pays the copy
            from .fabric import PortableUnit

            def build(a=a, b=b):
                return {
                    "arrays": {
                        "wires": wires_e[:, a:b], "z": z_e[a:b],
                        "zw": zw_e[a:b], "m": m_e[a:b],
                        "phi": phi_e[a:b], "phiw": phiw_e[a:b],
                        "uv": uv_e[:, a:b], "fixed": fixed_e[:, a:b],
                        "sigma": sigma_e[:, a:b], "pi": pi_e[a:b],
                        "xs": xs[a:b], "zh_inv": zh_inv[a:b],
                        "l0": l0[a:b],
                    },
                    "scalars": {
                        "beta": str(beta), "gamma": str(gamma),
                        "beta_lk": str(beta_lk), "alpha": str(alpha),
                        "shifts": [str(s) for s in pk.shifts],
                    },
                }

            return PortableUnit("quotient", build)

        fanout = (shard_fanout()
                  if "quotient" in SHARDABLE_STAGES["host"] else 1)
        if fanout > 1:
            ranges = split_ranges(ext_n, fanout)
            t_ext = np.concatenate(shard_map(
                "quotient",
                [lambda a=a, b=b: _quotient_rows(a, b)
                 for a, b in ranges],
                portables=[_quotient_portable(a, b) for a, b in ranges]))
        else:
            t_ext = _quotient_rows(0, ext_n)
    del wires_e, zw_e, m_e, phiw_e, uv_e, fixed_e, sigma_e, pi_e, xs, zh_inv
    del zh_tiled, l0_den, l0, z_e, phi_e

    with _stage("intt_ext", pk.k, "host"):
        fk.ntt(t_ext, de.omega, inverse=True)
        fk.coset_scale(t_ext, shift, invert=True)
        if t_ext[QUOTIENT_CHUNKS * n :].any():
            raise EigenError(
                "proving_error",
                "quotient degree overflow — witness does not satisfy the "
                "circuit",
            )
        chunks = [np.ascontiguousarray(t_ext[i * n : (i + 1) * n])
                  for i in range(QUOTIENT_CHUNKS)]
    with _stage("commit.t", pk.k, "host", labels=eng.stage_labels()):
        for u, ch in enumerate(chunks):
            eng.submit_coeffs(f"t{u}", ch)
        t_commits = eng.flush()
        for cm in t_commits:
            tr.absorb_point(cm)
    with _stage("transcript", pk.k, "host"):
        zeta = tr.challenge()

    # round 4: evaluations via one stacked Horner pass per point
    npp = NUM_PERM_PARTIALS
    with _stage("evals", pk.k, "host"):
        all_polys = (wire_coeffs + [m_coeffs, z_coeffs, phi_coeffs]
                     + uv_coeffs + chunks
                     + [pk_fixed_c[i] for i in range(len(FIXED_NAMES))]
                     + [pk_sigma_c[w] for w in range(NUM_WIRES)])
        max_len = max(len(p) for p in all_polys)
        stacked = np.zeros((len(all_polys), max_len, 4), dtype="<u8")
        for i, p in enumerate(all_polys):
            stacked[i, : len(p)] = p
        evals = fk.poly_eval_many(stacked, zeta)
        nw = NUM_WIRES
        wire_evals = evals[:nw]
        m_eval = evals[nw]
        z_eval = evals[nw + 1]
        phi_eval = evals[nw + 2]
        uv_evals = evals[nw + 3 : nw + 3 + npp]
        qb = nw + 3 + npp
        t_evals = evals[qb : qb + QUOTIENT_CHUNKS]
        fixed_evals = evals[qb + QUOTIENT_CHUNKS :
                            qb + QUOTIENT_CHUNKS + len(FIXED_NAMES)]
        sigma_zeta = evals[qb + QUOTIENT_CHUNKS + len(FIXED_NAMES) :]
        zeta_w = zeta * d.omega % R
        shifted_pair = np.zeros((2, n + 3, 4), dtype="<u8")
        shifted_pair[0, : len(z_coeffs)] = z_coeffs
        shifted_pair[1, : len(phi_coeffs)] = phi_coeffs
        z_next, phi_next = fk.poly_eval_many(shifted_pair, zeta_w)
        for v in (wire_evals + [m_eval, z_eval, z_next, phi_eval,
                                phi_next]
                  + uv_evals + t_evals + fixed_evals + sigma_zeta):
            tr.absorb_fr(v)
    with _stage("transcript", pk.k, "host"):
        v_ch = tr.challenge()
        tr.challenge()  # u — verifier-side fold; lockstep transcripts

    # batched openings at ζ and ωζ: fold with γ powers, divide, then
    # BOTH witness commits ride one engine batch (same SRS bases, same
    # quotient length; neither depends on the other)
    def open_group(polys: list, at: int) -> np.ndarray:
        width = max(len(p) for p in polys)
        folded = np.zeros((width, 4), dtype="<u8")
        g = 1
        for p in polys:
            term = fk.scalar_mul(p, g)
            folded[: len(term)] = fk.vec_add(folded[: len(term)], term)
            g = g * v_ch % R
        return fk.poly_divide_linear(folded, at)

    with _stage("openings", pk.k, "host"):
        # the two witness folds are independent whole units (native
        # field kernels are stateless) — the opening-side shard pair
        if "openings" in SHARDABLE_STAGES["host"]:
            from .fabric import PortableUnit

            def _fold_portable(polys, at):
                return PortableUnit("open_fold", lambda: {
                    "polys": list(polys), "at": str(at),
                    "v": str(v_ch)})

            q_x, q_wx = shard_map("open_fold", [
                lambda: open_group(all_polys, zeta),
                lambda: open_group([z_coeffs, phi_coeffs], zeta_w),
            ], portables=[
                _fold_portable(all_polys, zeta),
                _fold_portable([z_coeffs, phi_coeffs], zeta_w),
            ])
        else:  # pragma: no cover - stage-set edit seam
            q_x = open_group(all_polys, zeta)
            q_wx = open_group([z_coeffs, phi_coeffs], zeta_w)
    with _stage("commit.open", pk.k, "host", labels=eng.stage_labels()):
        eng.submit_coeffs("w_x", q_x)
        eng.submit_coeffs("w_wx", q_wx)
        w_x, w_wx = eng.flush()

    proof = Proof(wire_commits, m_commit, z_commit, phi_commit, uv_commits,
                  t_commits, wire_evals, m_eval, z_eval, z_next, phi_eval,
                  phi_next, uv_evals, t_evals, fixed_evals, sigma_zeta,
                  w_x, w_wx)
    return proof.to_bytes()


# --- device-pipelined prover ------------------------------------------------

_DEVICE_PROVERS: list = []  # MRU-first [(pk object, DeviceProver)] — the
# DEFAULT (single-driver) cache's backing list; pool workers get their
# own DeviceProverCache via worker_isolation() below
_DEVICE_PROVERS_LOCK = threading.Lock()  # api's prewarm thread vs provers


def _dp_cache_cap() -> int:
    """PTPU_DP_CACHE bounds how many per-pk DeviceProvers stay alive
    (default 2 — the Threshold cycle alternates the k=20 inner and the
    k=21 outer pk every proof; 1 restores the single-slot behavior if
    a suspended prover's resident coeffs ever crowd the card's memory)."""
    try:
        return max(1, int(os.environ.get("PTPU_DP_CACHE", "2")))
    except ValueError:
        return 2


def _sync_if_tracing(x) -> None:
    """Sync-span mode turns the trace spans in ``prove_fast_tpu`` into
    accurate per-stage attribution by draining the device queue at span
    boundaries. Device launches are asynchronous, so without this the
    round-3 compute cost all surfaces at the blocking t-chunk download.
    First-class form: ``trace.sync_spans()`` (the ``profile`` CLI verb's
    default); ``PTPU_TRACE_SYNC=1`` forces the drain regardless of
    tracer state. Profiling aid only — it serializes stages, so the
    total is slightly worse than the production overlap."""
    if os.environ.get("PTPU_TRACE_SYNC") == "1":
        from .prover_tpu import synchronize

        synchronize(x)
        return
    trace.device_sync(x)


def _stage_labels(base: dict) -> dict:
    """Stage histogram labels + the pool-worker id when this thread
    runs inside a worker context — ``ptpu_prover_stage_seconds`` series
    then carry ``worker=wN`` so per-device attribution is scrapeable
    (label cardinality = worker count, bounded by the device count)."""
    worker = trace.current_worker()
    if worker is not None:
        base = dict(base, worker=worker)
    return base


def _stage(stage: str, k: int, path: str, span_name: str | None = None,
           labels: dict | None = None, **fields):
    """One named prover stage: a trace span plus a
    ``ptpu_prover_stage_seconds{stage,k,path[,worker]}`` histogram
    observation — the label-aware instrument the service renders on
    ``/metrics``. ``labels`` adds extra label dimensions (the commit
    stages carry ``batched="0|1"`` from the engine). Under sync-span
    mode the caller drains the device queue before the block exits, so
    the recorded duration is the stage's true cost, not its dispatch
    time. Default span names are per-path (``prove.`` /
    ``prove_device.``): a process that runs both paths must not merge
    their durations under one span name."""
    base = {"stage": stage, "k": str(k), "path": path}
    if labels:
        base.update(labels)
    return trace.timed("prover_stage_seconds",
                       span_name or ("prove_device." if path == "device"
                                     else "prove.") + stage,
                       _stage_labels(base),
                       stage=stage, k=k, **fields)


def _prove_total(k: int, path: str):
    """Whole-prove span + ``ptpu_prover_total_seconds{path,k[,worker]}``
    — the denominator per-stage shares are reported against. Span names
    are per-path like :func:`_stage`'s."""
    return trace.timed("prover_total_seconds",
                       "prove_device.total" if path == "device"
                       else "prove.total",
                       _stage_labels({"k": str(k), "path": path}),
                       k=k, path=path)


class DeviceProverCache:
    """One driver's MRU of per-pk DeviceProvers (the pk's fixed/sigma
    cosets are device-resident, like halo2's ProvingKey holds its
    cosets in RAM). The cache is a small MRU list (cap: PTPU_DP_CACHE,
    default 2): the Threshold cycle alternates a k=20 inner and a k=21
    outer prover on every proof, and a single slot paid BOTH full
    device inits (uploads + iNTTs + resident ext builds, ~70 s summed)
    per call. Inactive provers are suspended — resident ext tables
    released so the active prove keeps its working-set budget —
    and resumed from their resident coefficients on reuse (device
    compute only). Entries hold strong pk references and compare
    identity: an id()-keyed map could alias a new key to a collected
    one's DeviceProver. Serialized by a lock: api's prewarm daemon
    calls this concurrently with engine-level provers — without it two
    threads could miss on the same pk and double-init (double memory).

    The suspend/resume protocol assumes ONE driver per cache — which
    used to mean one per process. The proof pool gives each worker its
    own instance pinned to its own device (:func:`worker_isolation`),
    so N workers drive N devices concurrently without sharing prover
    state; the module-global default cache keeps the historical
    single-driver behavior for everything outside a pool worker."""

    def __init__(self, entries: list | None = None, device=None,
                 name: str | None = None, lock=None):
        self.entries = entries if entries is not None else []
        self.device = device
        self.name = name
        self._lock = lock or threading.Lock()

    def holds(self, pk) -> bool:
        with self._lock:
            return any(entry[0] is pk for entry in self.entries)

    def get(self, pk: FastProvingKey, device=None):
        """``pk``'s DeviceProver on ``device`` (default: the cache's own
        device, else the card — ``resolve_device`` raises without
        one)."""
        from ..device import resolve_device
        from . import prover_tpu

        dev = resolve_device(device if device is not None else self.device)
        with self._lock:
            for i, entry in enumerate(self.entries):
                if entry[0] is pk and entry[1].device == dev:
                    if i:
                        self.entries.insert(0, self.entries.pop(i))
                    for _, other in self.entries[1:]:
                        other.suspend()
                    dp = entry[1]
                    with trace.span("prove_device.device_prover_resume"):
                        dp.resume()
                    return dp
            # free the evictee's and the suspendees' device arrays
            # BEFORE the new prover's init starts claiming device memory
            del self.entries[_dp_cache_cap() - 1:]
            for _, other in self.entries:
                other.suspend()
            ext_n = (1 << pk.k) * 4
            shift = _find_coset_shifts(ext_n, 2)[1]
            dp = prover_tpu.DeviceProver(
                pk.k, shift,
                [pk.fixed_limbs[i] for i in range(len(FIXED_NAMES))],
                [pk.sigma_limbs[w] for w in range(NUM_WIRES)],
                device=dev)
            self.entries.insert(0, (pk, dp))
            return dp


# the default process-wide cache shares the module-global list so the
# historical test/probe seam (pf._DEVICE_PROVERS surgery) keeps working
_DEFAULT_DP_CACHE = DeviceProverCache(entries=_DEVICE_PROVERS,
                                      lock=_DEVICE_PROVERS_LOCK)
_WORKER_DP = threading.local()


def current_dp_cache() -> DeviceProverCache:
    """The DeviceProver cache for THIS thread: a pool worker's own
    instance inside :func:`worker_isolation`, else the process-wide
    default."""
    return getattr(_WORKER_DP, "cache", None) or _DEFAULT_DP_CACHE


@contextlib.contextmanager
def worker_isolation(name: str, device=None):
    """Per-worker prover isolation for a proof-pool worker thread: a
    private :class:`DeviceProverCache` (so suspend/resume never crosses
    drivers) and, when a CUDA device is given, ``torch.cuda.device``
    pinning so every launch this thread makes lands on the worker's own
    card. Yields the cache (the pool reads residency from its scheduler
    state, not from here)."""
    import torch

    cache = DeviceProverCache(device=device, name=name)
    prev = getattr(_WORKER_DP, "cache", None)
    _WORKER_DP.cache = cache
    try:
        if device is not None and torch.device(device).type == "cuda":
            with torch.cuda.device(torch.device(device)):
                yield cache
        else:
            yield cache
    finally:
        _WORKER_DP.cache = prev


def _device_prover(pk: FastProvingKey, device=None):
    """The per-thread cache's DeviceProver for ``pk`` (see
    :class:`DeviceProverCache` for the MRU/suspend semantics)."""
    return current_dp_cache().get(pk, device)


def prove_fast_tpu(params: KZGParams, pk: FastProvingKey,
                   cs: ConstraintSystem, public_inputs=None,
                   randint=None, transcript: str = "poseidon",
                   device=None) -> bytes:
    """``prove_fast`` with rounds 3–4 on the device: extension-domain
    NTTs, the quotient identity, the 4n inverse, the opening folds and
    the ζ evaluations are device-resident (zk/prover_tpu.py) on
    ``device`` (default: the card; raises without one — name ``"cpu"``
    to run the same pipeline on the CPU's plain kernels); the host keeps
    witness generation, grand products, the Poseidon transcript and the
    MSM commits. Requires an eval-form (FPK2) key and Lagrange-basis
    params. Proof bytes are identical to the host path's for the same
    blinding stream (tested).

    LOCKSTEP WARNING: rounds 1-2 here mirror ``prove_fast``'s absorb and
    blinding-draw ORDER exactly — any edit to one path's transcript
    sequence must be mirrored in the other or the two provers' proofs
    (and the verifier) silently diverge.

    Every stage reports into ``ptpu_prover_stage_seconds{stage,k,
    path="device"}``; run under sync-span mode (``trace.sync_spans()`` /
    ``PTPU_TRACE_SYNC=1``) for accurate attribution — device launches
    are asynchronous, so without it the round-3 cost surfaces at
    whichever stage blocks first."""
    with _prove_total(pk.k, "device"):
        with trace.compile_watch("prove"):  # counts nothing on torch
            return _prove_fast_tpu_impl(params, pk, cs, public_inputs,
                                        randint, transcript, device)


def _prove_fast_tpu_impl(params, pk, cs, public_inputs, randint,
                         transcript, device) -> bytes:
    from . import prover_tpu as ptpu

    if not pk.eval_form:
        raise EigenError("proving_error", "prove_fast_tpu needs an FPK2 key")
    if randint is None:
        randint = lambda: secrets.randbelow(R)  # noqa: E731
    fk = _kernel()
    d = pk.domain()
    n = d.n
    if cs.num_rows > n:
        raise EigenError("proving_error", "circuit larger than key domain")
    if (params.g1_lagrange is None or len(params.g1_lagrange) != n):
        raise EigenError("proving_error",
                         "prove_fast_tpu needs a matching Lagrange basis")
    with _stage("device_init", pk.k, "device",
                span_name="prove_device.device_prover_init"):
        dp = _device_prover(pk, device)
    pubs = (list(public_inputs) if public_inputs is not None
            else cs.public_values())
    with _stage("transcript", pk.k, "device"):
        tr = make_transcript(transcript)
        for v in pubs:
            tr.absorb_fr(v)

    # round 1: wires + lookup multiplicities (commits from evals; the
    # blinding stream consumption order matches _blind_arr exactly). The
    # host's limb conversion of the witness is its own stage, as on the
    # host path: unstaged, it is prove time no stage accounts for
    with _stage("witness_build", pk.k, "device"):
        wire_vals = np.zeros((NUM_WIRES, n, 4), dtype="<u8")
        for w in range(NUM_WIRES):
            col = cs.wires[w]
            if col:
                wire_vals[w, : len(col)] = native.ints_to_limbs(col)
    # eval-form device arrays are transient: intt to coeffs, then drop
    # (ζ-evals run from coeffs, as in the reference)

    # Host/device overlap: the 4n ext-chunk NTTs of every poly whose
    # coefficients and blinds are already fixed (wires, m, pi — and z,
    # phi as soon as their commits seal them) are launched BEFORE the
    # host MSM commits of rounds 1-2: CUDA launches are asynchronous, so
    # the device ext work runs under the host commit work instead of
    # after it. Default: resident mode at k ≤ 20 only (the reference's
    # memory line); PTPU_PREDISPATCH={0,1} overrides.
    _pd = os.environ.get("PTPU_PREDISPATCH")
    pre = ((dp.ext_resident and dp.k <= 20) if _pd not in ("0", "1")
           else _pd == "1")

    def ext8(coeff_dev, blinds=None):
        return dp.ext_chunks(coeff_dev, blinds)

    eng = CommitEngine(params)
    with _stage("witness_upload", pk.k, "device",
                span_name="prove_device.r1_upload_intt"):
        wire_coeff_dev = [dp.upload_intt(wire_vals[w])
                          for w in range(NUM_WIRES)]
        wire_blinds = [[randint() for _ in range(2)]
                       for _ in range(NUM_WIRES)]
        pi_vals = np.zeros((n, 4), dtype="<u8")
        for row, value in zip(pk.public_rows, pubs):
            _set_int(pi_vals, row, (-int(value)) % R)
        pi_coeff_dev = dp.upload_intt(pi_vals)
        if pre:
            wire_ext = [ext8(wire_coeff_dev[w], wire_blinds[w])
                        for w in range(NUM_WIRES)]
            pi_ext = ext8(pi_coeff_dev)
        # sync the LAST work dispatched in this stage: blocking on an
        # earlier array would let the pre-dispatched ext8 compute skew
        # onto whichever later stage blocks first
        _sync_if_tracing((wire_ext, pi_ext) if pre else pi_coeff_dev)

    with _stage("lookup_build", pk.k, "device",
                span_name="prove_device.r1_lookup_build"):
        table_size = 1 << pk.lookup_bits if pk.lookup_bits else 1
        m_vals = _lookup_multiplicities(cs, n, table_size)
        m_coeff_dev = dp.upload_intt(m_vals)
        m_blinds = [randint() for _ in range(2)]
        if pre:
            m_ext = ext8(m_coeff_dev, m_blinds)

    # round-1 commits batch through the engine (7 Lagrange-basis
    # columns, one g1_msm_multi window pass) and absorb in the
    # historical order; the pre-dispatched device ext chunks above
    # compute under this host MSM block exactly as they did under the
    # serial commits
    with _stage("commit.r1", pk.k, "device", labels=eng.stage_labels(),
                span_name="prove_device.commit_r1"):
        for w in range(NUM_WIRES):
            eng.submit_evals(f"wire{w}", wire_vals[w], wire_blinds[w])
        eng.submit_evals("m", m_vals, m_blinds)
        r1_points = eng.flush()
        wire_commits = r1_points[:NUM_WIRES]
        m_commit = r1_points[NUM_WIRES]
        for cm in wire_commits:
            tr.absorb_point(cm)
        tr.absorb_point(m_commit)

    with _stage("transcript", pk.k, "device"):
        beta = tr.challenge()
        gamma = tr.challenge()
        beta_lk = tr.challenge()

    # round 2: grand products on host kernels, commits from evals
    with _stage("grand_product", pk.k, "device",
                span_name="prove_device.r2_grand_products"):
        omegas = np.zeros((n, 4), dtype="<u8")
        omegas[:, 0] = 1
        fk.coset_scale(omegas, d.omega)
        z_vals = fk.perm_grand_product(wire_vals, pk.sigma_eval_limbs,
                                       pk.shifts, omegas, beta, gamma)
        z_coeff_dev = dp.upload_intt(z_vals)
        z_blinds = [randint() for _ in range(3)]
        if pre:
            z_ext = ext8(z_coeff_dev, z_blinds)

    with _stage("logup_sum", pk.k, "device",
                span_name="prove_device.r2_logup_sum"):
        table_limbs = np.zeros((n, 4), dtype="<u8")
        table_limbs[:table_size, 0] = np.arange(table_size,
                                                dtype=np.uint64)
        phi_vals = fk.logup_running_sum(wire_vals[LOOKUP_WIRE],
                                        table_limbs, m_vals, beta_lk)
        phi_coeff_dev = dp.upload_intt(phi_vals)
        phi_blinds = [randint() for _ in range(3)]
        if pre:
            phi_ext = ext8(phi_coeff_dev, phi_blinds)

    # round 2c: z-split partial products — values on host kernels (the
    # lockstep twin of prove_fast's round 2c), ext chunks on device
    with _stage("partials", pk.k, "device",
                span_name="prove_device.r2c_partials"):
        uv_vals = _perm_partial_vals(fk, wire_vals, pk.sigma_eval_limbs,
                                     pk.shifts, omegas, z_vals, beta,
                                     gamma)
        uv_coeff_dev = []
        uv_blinds = []
        for vals in uv_vals:
            uv_coeff_dev.append(dp.upload_intt(vals))
            uv_blinds.append([randint() for _ in range(2)])
        if pre:
            uv_ext = [ext8(uv_coeff_dev[i], uv_blinds[i])
                      for i in range(NUM_PERM_PARTIALS)]

    # round-2 commits batch into one flush (z, φ, partials sit between
    # the same two challenges; blind draws already happened above in
    # the historical order, absorbs happen here in it). The dispatched
    # ext8 chunks overlap this host MSM block as before.
    with _stage("commit.r2", pk.k, "device", labels=eng.stage_labels(),
                span_name="prove_device.commit_r2"):
        eng.submit_evals("z", z_vals, z_blinds)
        eng.submit_evals("phi", phi_vals, phi_blinds)
        for i in range(NUM_PERM_PARTIALS):
            eng.submit_evals(f"uv{i}", uv_vals[i], uv_blinds[i])
        r2_points = eng.flush()
        z_commit, phi_commit = r2_points[0], r2_points[1]
        uv_commits = r2_points[2:]
        tr.absorb_point(z_commit)
        tr.absorb_point(phi_commit)
        for cm in uv_commits:
            tr.absorb_point(cm)

    with _stage("transcript", pk.k, "device"):
        alpha = tr.challenge()

    # round 3 (device): ext chunks → quotient → 4n inverse → chunks
    with _stage("quotient_chunks", pk.k, "device",
                span_name="prove_device.r3_quotient"):
        ch_planes = dp.challenge_planes(beta, gamma, beta_lk, alpha,
                                        pk.shifts)
        t_chunks_fs = []
        for j in range(ptpu.EXT_COSETS):
            with trace.span("prove_device.r3_chunk", j=j):
                if pre:
                    wires_e = [wire_ext[w][j] for w in range(NUM_WIRES)]
                    z_e, m_e = z_ext[j], m_ext[j]
                    phi_e, pi_e = phi_ext[j], pi_ext[j]
                    uv_e = [uv_ext[i][j]
                            for i in range(NUM_PERM_PARTIALS)]
                else:
                    wires_e = [dp.ext_chunk(wire_coeff_dev[w], j,
                                            wire_blinds[w])
                               for w in range(NUM_WIRES)]
                    z_e = dp.ext_chunk(z_coeff_dev, j, z_blinds)
                    m_e = dp.ext_chunk(m_coeff_dev, j, m_blinds)
                    phi_e = dp.ext_chunk(phi_coeff_dev, j, phi_blinds)
                    pi_e = dp.ext_chunk(pi_coeff_dev, j)
                    uv_e = [dp.ext_chunk(uv_coeff_dev[i], j,
                                         uv_blinds[i])
                            for i in range(NUM_PERM_PARTIALS)]
                t_chunks_fs.append(dp.quotient_chunk(
                    j, wires_e, z_e, m_e, phi_e, pi_e, uv_e, ch_planes))
                if pre:  # chunk consumed — release its 14 ext arrays
                    for col in wire_ext:
                        col[j] = None
                    for col in uv_ext:
                        col[j] = None
                    z_ext[j] = m_ext[j] = phi_ext[j] = pi_ext[j] = None
                _sync_if_tracing(t_chunks_fs[-1])
    with _stage("intt_ext", pk.k, "device",
                span_name="prove_device.r3_intt_ext"):
        t_coeff_chunks = dp.intt_ext(t_chunks_fs)
        _sync_if_tracing(t_coeff_chunks[-1])
    # the degree check pins the full device pipeline; the remaining
    # chunk downloads then overlap the host t-commit MSMs through the
    # engine's fetch thread (the ctypes MSM releases the GIL, so chunk
    # u+1 downloads while whatever chunks are already on the host commit
    # as one batch)
    with trace.span("prove_device.r3_top_check"):
        # device-side zero check: one scalar over the wire, not a chunk
        top_max = ptpu._is_zero_poly(t_coeff_chunks[QUOTIENT_CHUNKS])
        t_coeff_chunks[QUOTIENT_CHUNKS] = None
        if top_max != 0:
            raise EigenError(
                "proving_error",
                "quotient degree overflow — witness does not satisfy "
                "the circuit",
            )
    with _stage("commit.t", pk.k, "device", labels=eng.stage_labels(),
                span_name="prove_device.commit_t"):
        for u in range(QUOTIENT_CHUNKS):
            eng.submit_coeffs(
                f"t{u}",
                fetch=(lambda u=u: ptpu.download_std(t_coeff_chunks[u])))
        t_commits = eng.flush()
        for cm in t_commits:
            tr.absorb_point(cm)
    with _stage("transcript", pk.k, "device"):
        zeta = tr.challenge()

    # round 4: ζ evaluations — barycentric on device + blind corrections
    zh_zeta = (pow(zeta, n, R) - 1) % R
    zeta_w = zeta * d.omega % R
    zh_zeta_w = (pow(zeta_w, n, R) - 1) % R

    def blind_corr(blinds, at, zh):
        b = 0
        xp = 1
        for bi in blinds:
            b = (b + bi * xp) % R
            xp = xp * at % R
        return b * zh % R

    npp = NUM_PERM_PARTIALS
    with _stage("evals", pk.k, "device", span_name="prove_device.r4_evals"):
        base_evals = dp.eval_coeffs_at_many(
            wire_coeff_dev + [m_coeff_dev, z_coeff_dev, phi_coeff_dev]
            + uv_coeff_dev + dp.fixed_coeffs + dp.sigma_coeffs, zeta)
        wire_evals = [
            (base_evals[w] + blind_corr(wire_blinds[w], zeta, zh_zeta)) % R
            for w in range(NUM_WIRES)
        ]
        m_eval = (base_evals[6] + blind_corr(m_blinds, zeta, zh_zeta)) % R
        z_eval = (base_evals[7] + blind_corr(z_blinds, zeta, zh_zeta)) % R
        phi_eval = (base_evals[8]
                    + blind_corr(phi_blinds, zeta, zh_zeta)) % R
        uv_evals = [
            (base_evals[9 + i] + blind_corr(uv_blinds[i], zeta,
                                            zh_zeta)) % R
            for i in range(npp)
        ]
        fixed_evals = base_evals[9 + npp : 9 + npp + len(FIXED_NAMES)]
        sigma_zeta = base_evals[9 + npp + len(FIXED_NAMES) :]
        shifted_evals = dp.eval_coeffs_at_many(
            [z_coeff_dev, phi_coeff_dev], zeta_w)
        z_next = (shifted_evals[0]
                  + blind_corr(z_blinds, zeta_w, zh_zeta_w)) % R
        phi_next = (shifted_evals[1]
                    + blind_corr(phi_blinds, zeta_w, zh_zeta_w)) % R
        # t chunks are device-resident coefficient arrays — ζ-power dots
        # there instead of a 3×2^20 host Horner pass
        t_evals = dp.eval_coeffs_at_many(
            [t_coeff_chunks[u] for u in range(QUOTIENT_CHUNKS)], zeta)
        for v in (wire_evals + [m_eval, z_eval, z_next, phi_eval,
                                phi_next]
                  + uv_evals + t_evals + fixed_evals + sigma_zeta):
            tr.absorb_fr(v)
    with _stage("transcript", pk.k, "device"):
        v_ch = tr.challenge()
        tr.challenge()  # u — verifier-side fold

    # batched openings: fold base coeffs on device, patch blinds on host
    base_polys = (wire_coeff_dev + [m_coeff_dev, z_coeff_dev, phi_coeff_dev]
                  + uv_coeff_dev
                  + [t_coeff_chunks[u] for u in range(QUOTIENT_CHUNKS)]
                  + dp.fixed_coeffs + dp.sigma_coeffs)
    blind_map = {w: wire_blinds[w] for w in range(NUM_WIRES)}
    blind_map[NUM_WIRES] = m_blinds
    blind_map[NUM_WIRES + 1] = z_blinds
    blind_map[NUM_WIRES + 2] = phi_blinds
    for i in range(npp):
        blind_map[NUM_WIRES + 3 + i] = uv_blinds[i]

    def _g_pows(poly_idx: list) -> list:
        return [pow(v_ch, i, R) for i in range(len(poly_idx))]

    def open_quotient(g_pows: list, folded_np: np.ndarray,
                      poly_idx: list, at: int) -> np.ndarray:
        folded = np.zeros((n + 3, 4), dtype="<u8")
        folded[:n] = folded_np
        for gi, idx in zip(g_pows, poly_idx):
            blinds = blind_map.get(idx)
            if not blinds:
                continue
            for i, b in enumerate(blinds):
                corr = gi * b % R
                _set_int(folded, i, (_get_int(folded, i) - corr) % R)
                _set_int(folded, n + i,
                         (_get_int(folded, n + i) + corr) % R)
        with trace.span("prove_device.r4_divide"):
            return fk.poly_divide_linear(folded, at)

    with _stage("openings", pk.k, "device",
                span_name="prove_device.r4_openings"):
        # both folds launch up front; the engine's fetch thread then
        # downloads fold1, divides, and hands the ζ witness to the MSM
        # while fold2 downloads behind it.
        all_idx = list(range(len(base_polys)))
        g1 = _g_pows(all_idx)
        wx_idx = [NUM_WIRES + 1, NUM_WIRES + 2]
        g2 = _g_pows(wx_idx)
        with trace.span("prove_device.r4_fold_dispatch"):
            fold1_dev = dp.fold_coeffs(base_polys, g1)
            fold2_dev = dp.fold_coeffs([z_coeff_dev, phi_coeff_dev], g2)
    with _stage("commit.open", pk.k, "device", labels=eng.stage_labels(),
                span_name="prove_device.commit_open"):
        eng.submit_coeffs(
            "w_x",
            fetch=lambda: open_quotient(
                g1, ptpu.download_std(fold1_dev), all_idx, zeta))
        eng.submit_coeffs(
            "w_wx",
            fetch=lambda: open_quotient(
                g2, ptpu.download_std(fold2_dev), wx_idx, zeta_w))
        w_x, w_wx = eng.flush()

    proof = Proof(wire_commits, m_commit, z_commit, phi_commit, uv_commits,
                  t_commits, wire_evals, m_eval, z_eval, z_next, phi_eval,
                  phi_next, uv_evals, t_evals, fixed_evals, sigma_zeta,
                  w_x, w_wx)
    return proof.to_bytes()
