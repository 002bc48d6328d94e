"""KZG polynomial commitments over BN254 (GWC19 multi-open flavour).

The reference's commitment scheme is halo2's ``ParamsKZG`` + ``ProverGWC``
/ ``VerifierGWC`` (``eigentrust-zk/src/utils.rs:206-251``); this is the
framework's own implementation of the same scheme:

- ``KZGParams.setup(k)`` — powers-of-τ SRS. τ is sampled and discarded
  (same unsafe-ceremony semantics as the reference's ``ParamsKZG::new``
  with ``OsRng``; a ``seed`` makes it deterministic for tests/fixtures).
- ``commit(coeffs)`` — MSM over the G1 powers.
- ``open_at(poly, z)`` — witness quotient (f(X)−f(z))/(X−z).
- single and batched verification as pairing checks; the batch form
  (per-point γ-fold, cross-point u-fold, one pairing check) is the GWC
  construction PLONK needs for its {x, ωx} openings.

Byte layout: uncompressed big-endian coordinates (G1 = 64 bytes,
G2 = 128, identity = zeros) — simple, self-describing artifacts for the
CLI's kzg-params / proof files (EigenFile layout, fs.rs:50-84).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from ..utils.fields import BN254_FR_MODULUS
from . import bn254
from .bn254 import (
    G1_GEN,
    G2_GEN,
    g1_add,
    g1_msm,
    g1_mul,
    g1_neg,
    g2_mul,
    pairing_check,
)
from .domain import poly_divide_linear, poly_eval

R = BN254_FR_MODULUS
P = bn254.P


@dataclass
class KZGParams:
    k: int
    g1_powers: list  # [τⁱ·G1] for i in 0..n_max
    s_g2: tuple  # τ·G2
    # optional Lagrange-basis form [L_i(τ)·G1] over the 2^k domain,
    # emitted by the fast setup (which knows τ before discarding it, the
    # same way real trusted setups publish both bases). Enables
    # committing straight from evaluations — no iNTT before the MSM.
    g1_lagrange: list | None = None

    @classmethod
    def setup(cls, k: int, extra: int = 8, seed: bytes | None = None) -> "KZGParams":
        """SRS for polynomials of degree < 2^k + extra (the slack covers
        blinding rows and quotient chunks)."""
        n = (1 << k) + extra
        if seed is None:
            tau = secrets.randbelow(R - 1) + 1
        else:
            tau = int.from_bytes(seed + b"kzg-tau", "little") % (R - 1) + 1
        powers = []
        acc = 1
        for _ in range(n):
            powers.append(acc)
            acc = acc * tau % R
        g1_powers = [g1_mul(G1_GEN, t) for t in powers]
        s_g2 = g2_mul(G2_GEN, tau)
        return cls(k, g1_powers, s_g2)

    @property
    def n(self) -> int:
        return 1 << self.k

    def commit(self, coeffs: list):
        assert len(coeffs) <= len(self.g1_powers), "poly exceeds SRS"
        from ..native import prover as native

        if native.available() and len(coeffs) > 16:
            # the compiled Pippenger (identical result; the pure-python
            # g1_msm below stays as the oracle fallback). The SRS limb
            # view is cached on the params object by prover_fast.
            from .prover_fast import commit_limbs

            return commit_limbs(self,
                                native.ints_to_limbs(
                                    [int(c) % R for c in coeffs]))
        return g1_msm(self.g1_powers[: len(coeffs)], coeffs)

    # --- serialization ----------------------------------------------------
    def to_bytes(self) -> bytes:
        out = [self.k.to_bytes(4, "little"), len(self.g1_powers).to_bytes(4, "little")]
        for pt in self.g1_powers:
            out.append(g1_to_bytes(pt))
        out.append(g2_to_bytes(self.s_g2))
        if self.g1_lagrange is not None:
            # optional trailing section — old readers that check exact
            # length must be tolerant (verifier_from_bytes is)
            out.append(b"LAG1")
            out.append(len(self.g1_lagrange).to_bytes(4, "little"))
            for pt in self.g1_lagrange:
                out.append(g1_to_bytes(pt))
        return b"".join(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "KZGParams":
        k = int.from_bytes(data[0:4], "little")
        count = int.from_bytes(data[4:8], "little")
        off = 8
        powers = []
        for _ in range(count):
            powers.append(g1_from_bytes(data[off : off + 64]))
            off += 64
        s_g2 = g2_from_bytes(data[off : off + 128])
        off += 128
        lagrange = None
        if data[off : off + 4] == b"LAG1":
            lcount = int.from_bytes(data[off + 4 : off + 8], "little")
            off += 8
            lagrange = []
            for _ in range(lcount):
                lagrange.append(g1_from_bytes(data[off : off + 64]))
                off += 64
        return cls(k, powers, s_g2, lagrange)

    @classmethod
    def verifier_from_bytes(cls, data: bytes) -> "KZGParams":
        """Verifier-side load: header + the τG2 tail only, skipping the
        G1 powers (hundreds of MB at k=22). ``succinct_verify`` needs no
        SRS and the pairing decider reads only ``s_g2``; the returned
        params must not be used for committing."""
        k = int.from_bytes(data[0:4], "little")
        count = int.from_bytes(data[4:8], "little")
        g2_off = 8 + 64 * count
        expected = g2_off + 128
        if len(data) < expected:
            raise ValueError(f"bad params length {len(data)} < {expected}")
        if len(data) > expected and data[expected : expected + 4] != b"LAG1":
            raise ValueError("bad params trailer")
        return cls(k, [], g2_from_bytes(data[g2_off : g2_off + 128]))


# --- point codecs ---------------------------------------------------------

def g1_to_bytes(pt) -> bytes:
    if pt is None:
        return b"\x00" * 64
    return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


def g1_from_bytes(data: bytes):
    x = int.from_bytes(data[:32], "big")
    y = int.from_bytes(data[32:64], "big")
    if x == 0 and y == 0:
        return None
    pt = (x, y)
    if not bn254.g1_is_on_curve(pt):
        raise ValueError("G1 point not on curve")
    return pt


def g2_to_bytes(pt) -> bytes:
    if pt is None:
        return b"\x00" * 128
    (x0, x1), (y0, y1) = pt
    return b"".join(v.to_bytes(32, "big") for v in (x0, x1, y0, y1))


def g2_from_bytes(data: bytes):
    vals = [int.from_bytes(data[i * 32 : (i + 1) * 32], "big") for i in range(4)]
    if all(v == 0 for v in vals):
        return None
    pt = ((vals[0], vals[1]), (vals[2], vals[3]))
    if not bn254.g2_is_on_curve(pt):
        raise ValueError("G2 point not on curve")
    return pt


# --- single opening -------------------------------------------------------

def open_at(params: KZGParams, coeffs: list, z: int):
    """(y, W): evaluation and witness commitment for f at z."""
    y = poly_eval(coeffs, z)
    q = poly_divide_linear(coeffs, z)
    return y, params.commit(q) if q else None


def verify_single(params: KZGParams, commitment, z: int, y: int, witness) -> bool:
    """e(C − y·G1 + z·W, G2) · e(−W, τ·G2) == 1
    (the rearranged form avoids a G2 subtraction)."""
    lhs = g1_add(commitment, g1_neg(g1_mul(G1_GEN, y)))
    lhs = g1_add(lhs, g1_mul(witness, z))
    return pairing_check([(lhs, G2_GEN), (g1_neg(witness), params.s_g2)])


# --- GWC batched opening --------------------------------------------------

@dataclass
class BatchOpening:
    """One opening point with its polys folded by γ powers."""

    z: int
    witness: tuple  # commitment to Σ γʲ (fⱼ − fⱼ(z))/(X−z)


def open_batch(params: KZGParams, groups, gamma: int) -> list:
    """groups: [(z, [coeffs, ...])] → one witness per point, folding each
    point's polynomials with powers of the verifier challenge γ."""
    out = []
    for z, polys in groups:
        folded: list = []
        g = 1
        for coeffs in polys:
            for i, c in enumerate(coeffs):
                if i < len(folded):
                    folded[i] = (folded[i] + g * c) % R
                else:
                    folded.append(g * c % R)
            g = g * gamma % R
        y, w = open_at(params, folded, z)
        out.append(BatchOpening(z, w))
    return out


def fold_batch(groups, gamma: int, u: int, openings: list) -> tuple:
    """groups: [(z, [(commitment, claimed_eval), ...])]; γ folds within a
    point, u folds across points. Returns the KZG **accumulator**
    (acc_l, acc_r): the pair satisfying the deferred pairing equation
    e(acc_l, G2)·e(−acc_r, τG2) == 1 iff every opening is valid — the
    GWC19 accumulation the reference's aggregator carries across proofs
    (``verifier/aggregator/native.rs:140-187``)."""
    acc_l = None  # Σ uⁱ (zᵢ·Wᵢ + Fᵢ − yᵢ·G1)
    acc_r = None  # Σ uⁱ Wᵢ
    ui = 1
    for (z, items), opening in zip(groups, openings):
        f_commit = None
        y_folded = 0
        g = 1
        for commitment, claimed in items:
            f_commit = g1_add(f_commit, g1_mul(commitment, g))
            y_folded = (y_folded + g * claimed) % R
            g = g * gamma % R
        term = g1_add(
            g1_mul(opening.witness, z),
            g1_add(f_commit, g1_neg(g1_mul(G1_GEN, y_folded))),
        )
        acc_l = g1_add(acc_l, g1_mul(term, ui))
        acc_r = g1_add(acc_r, g1_mul(opening.witness, ui))
        ui = ui * u % R
    return acc_l, acc_r


def decide(params: KZGParams, acc_l, acc_r) -> bool:
    """The deferred pairing check on an accumulator."""
    return pairing_check([(acc_l, G2_GEN), (g1_neg(acc_r), params.s_g2)])


def verify_batch(params: KZGParams, groups, gamma: int, u: int,
                 openings: list) -> bool:
    acc_l, acc_r = fold_batch(groups, gamma, u, openings)
    return decide(params, acc_l, acc_r)
