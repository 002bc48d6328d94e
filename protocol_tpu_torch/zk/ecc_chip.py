"""Elliptic-curve chips over wrong-field RNS integers.

Circuit twin of the reference's ``ecc`` module: affine point add /
double / windowed scalar-mul chipsets over 4×68-bit integers
(``eigentrust-zk/src/ecc/generic/mod.rs:140-1265``, window tables and
aux points per ``params/ecc/mod.rs:16-41``). Short-Weierstrass curves
y² = x³ + b only (secp256k1 and BN254 G1 both have a = 0).

Additions are incomplete (distinct-x), like the reference's, but the
λ-division here *hard-constrains* Δx ≠ 0 (witnessed inverse), so the
doubling degeneracy can never be used to leave λ unconstrained — a
colliding add makes the circuit unsatisfiable rather than unsound.
Scalar multiplication offsets every partial sum with nothing-up-my-
sleeve aux points (the reference's AuxInit/AuxFin pattern) so the
identity never appears on the add path; the aux mass is removed with
one final constant-point add.

Window digits come from ``IntegerChip.to_window_digits`` (4-bit,
lookup-constrained). Fixed-base tables are per-window constant points
(d·16^w·G + C), so their selects are pure linear combinations — no mul
rows at all on the fixed-base path.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.errors import EigenError
from ..utils.keccak import keccak256
from .gadgets import Cell, Chips
from .integer_chip import (
    B,
    NUM_LIMBS,
    TOTAL_BITS,
    AssignedInteger,
    IntegerChip,
)

WINDOW_BITS = 4
NUM_WINDOWS = TOTAL_BITS // WINDOW_BITS  # 68
TABLE_SIZE = 1 << WINDOW_BITS
# native-scalar path: 64 windows cover 256 bits ≥ the 254-bit field
NATIVE_WINDOWS = 256 // WINDOW_BITS


@dataclass
class CurveSpec:
    """Host-side curve oracle: exact ops on affine (x, y) int pairs, used
    for witness values and constant-point precomputation (never for
    constraints)."""

    p: int
    n: int
    b: int
    gen: tuple
    add: object  # (pt, pt) -> pt
    mul: object  # (pt, int) -> pt
    neg: object  # (pt) -> pt

    def aux_points(self, tag: str) -> tuple:
        """Two deterministic nothing-up-my-sleeve points (C, Aux)."""
        pts = []
        for name in (b"C", b"Aux"):
            seed = keccak256(b"protocol-tpu/ecc-aux/" + tag.encode() + b"/" + name)
            k = int.from_bytes(seed, "big") % self.n
            pts.append(self.mul(self.gen, k))
        return pts[0], pts[1]


def secp256k1_spec() -> CurveSpec:
    from ..crypto import secp256k1 as s

    def add(a, b):
        ra = s.AffinePoint(*a).add(s.AffinePoint(*b))
        return (ra.x, ra.y)

    def mul(a, k):
        ra = s.AffinePoint(*a).mul(k)
        return (ra.x, ra.y)

    def neg(a):
        return (a[0], s.P - a[1])

    return CurveSpec(p=s.P, n=s.N, b=7, gen=(s.GX, s.GY),
                     add=add, mul=mul, neg=neg)


@dataclass
class AssignedPoint:
    x: AssignedInteger
    y: AssignedInteger


class EccChip:
    """Point ops for one curve over an ``IntegerChip`` of its base field
    (EccAddChipset / EccDoubleChipset / EccMulChipset twins)."""

    def __init__(self, chips: Chips, fp: IntegerChip, spec: CurveSpec,
                 tag: str):
        if fp.p != spec.p:
            raise EigenError("circuit_error", "integer chip/base field mismatch")
        self.chips = chips
        self.fp = fp
        self.spec = spec
        self.aux_c, self.aux_init = spec.aux_points(tag)
        self._fixed_tables: dict = {}

    # --- assignment -------------------------------------------------------
    def assign_point(self, pt: tuple) -> AssignedPoint:
        x = self.fp.assign(pt[0])
        y = self.fp.assign(pt[1])
        p = AssignedPoint(x, y)
        self.assert_on_curve(p)
        return p

    def constant_point(self, pt: tuple) -> AssignedPoint:
        return AssignedPoint(self.fp.constant(pt[0]), self.fp.constant(pt[1]))

    def assert_on_curve(self, pt: AssignedPoint) -> None:
        """y·y ≡ x³ + b (mod p) in one CRT constraint."""
        fp = self.fp
        x2 = fp.square(pt.x)
        x3 = fp.mul(x2, pt.x)
        rhs = fp.add(x3, fp.constant(self.spec.b))
        fp.constrain_mul(pt.y, pt.y, rhs)

    # --- group ops --------------------------------------------------------
    def add(self, p1: AssignedPoint, p2: AssignedPoint) -> AssignedPoint:
        """Incomplete affine add; Δx ≠ 0 is hard-constrained."""
        fp = self.fp
        dx = fp.sub(p2.x, p1.x)
        dy = fp.sub(p2.y, p1.y)
        fp.assert_not_zero(dx)
        lam = fp.div(dy, dx)  # λ·Δx ≡ Δy
        lam_v = lam.value % fp.p
        x3_v = (lam_v * lam_v - p1.x.value - p2.x.value) % fp.p
        y3_v = (lam_v * (p1.x.value - x3_v) - p1.y.value) % fp.p
        x3 = fp.assign(x3_v)
        y3 = fp.assign(y3_v)
        # λ² ≡ x3 + x1 + x2
        fp.constrain_mul(lam, lam, fp.add(fp.add(x3, p1.x), p2.x))
        # λ·(x1 − x3) ≡ y3 + y1
        fp.constrain_mul(lam, fp.sub(p1.x, x3), fp.add(y3, p1.y))
        return AssignedPoint(x3, y3)

    def double(self, p1: AssignedPoint) -> AssignedPoint:
        """λ = 3x²/(2y); y = 0 makes the division unsatisfiable (no
        order-2 points on these curves anyway)."""
        fp = self.fp
        x2 = fp.square(p1.x)
        num = fp.mul_small(x2, 3)
        den = fp.mul_small(p1.y, 2)
        lam = fp.div(num, den)
        lam_v = lam.value % fp.p
        x3_v = (lam_v * lam_v - 2 * p1.x.value) % fp.p
        y3_v = (lam_v * (p1.x.value - x3_v) - p1.y.value) % fp.p
        x3 = fp.assign(x3_v)
        y3 = fp.assign(y3_v)
        fp.constrain_mul(lam, lam, fp.add(fp.add(x3, p1.x), p1.x))
        fp.constrain_mul(lam, fp.sub(p1.x, x3), fp.add(y3, p1.y))
        return AssignedPoint(x3, y3)

    # --- window select ----------------------------------------------------
    def _digit_flags(self, digit: Cell) -> list:
        c = self.chips
        eqs = [c.is_equal(digit, c.constant(d)) for d in range(TABLE_SIZE)]
        c.assert_equal(c.lincomb([(1, e) for e in eqs]), c.constant(1))
        return eqs

    def select_point(self, digit: Cell, table: list) -> AssignedPoint:
        """table[digit] for an in-circuit (witness) table."""
        c = self.chips
        fp = self.fp
        eqs = self._digit_flags(digit)
        dv = c.value(digit)
        coords = []
        for coord in ("x", "y"):
            limbs = []
            mx = []
            for i in range(NUM_LIMBS):
                cells = [getattr(pt, coord).limbs[i] for pt in table]
                prods = [c.mul(e, cell) for e, cell in zip(eqs, cells)]
                limbs.append(c.lincomb([(1, pr) for pr in prods]))
                mx.append(max(getattr(pt, coord).max_limb[i] for pt in table))
            value = getattr(table[dv], coord).value
            coords.append(AssignedInteger(limbs, value, mx))
        return AssignedPoint(*coords)

    def select_point_const(self, digit: Cell, host_table: list) -> AssignedPoint:
        """host_table[digit] for a constant table — selects are pure
        lincombs over the digit's one-hot flags."""
        c = self.chips
        eqs = self._digit_flags(digit)
        dv = c.value(digit)
        coords = []
        for axis in (0, 1):
            limbs = []
            mx = []
            for i in range(NUM_LIMBS):
                consts = [
                    (pt[axis] >> (68 * i)) & (B - 1) for pt in host_table
                ]
                limbs.append(
                    c.lincomb([(cv, e) for cv, e in zip(consts, eqs)]))
                mx.append(max(consts))
            coords.append(AssignedInteger(limbs, host_table[dv][axis], mx))
        return AssignedPoint(*coords)

    # --- scalar multiplication -------------------------------------------
    def scalar_mul(self, pt: AssignedPoint, digits: list) -> AssignedPoint:
        """Variable-base windowed mul (EccMulChipset twin). ``digits`` are
        LSB-first 4-bit cells of the scalar *representative* (scalar + k·n
        representatives are harmless: n·P = O)."""
        if len(digits) != NUM_WINDOWS:
            raise EigenError("circuit_error", "expected 68 window digits")
        # in-circuit table T[d] = d·P + C
        table = [self.constant_point(self.aux_c)]
        for _ in range(1, TABLE_SIZE):
            table.append(self.add(table[-1], pt))
        acc = self.constant_point(self.aux_init)
        for digit in reversed(digits):
            for _ in range(WINDOW_BITS):
                acc = self.double(acc)
            acc = self.add(acc, self.select_point(digit, table))
        # acc = 2^272·Aux + scalar·P + sC·C with sC = Σ 16^w
        s_c = ((1 << TOTAL_BITS) - 1) // (TABLE_SIZE - 1)
        mass = self.spec.add(
            self.spec.mul(self.aux_init, pow(2, TOTAL_BITS, self.spec.n)),
            self.spec.mul(self.aux_c, s_c % self.spec.n),
        )
        return self.add(acc, self.constant_point(self.spec.neg(mass)))

    def scalar_mul_fixed(self, digits: list,
                         base: tuple | None = None) -> AssignedPoint:
        """Fixed-base windowed mul of a constant point (default: the
        generator): constant per-window tables T_w[d] = (d·16^w)·base + C;
        68 adds, zero in-circuit doubles."""
        if len(digits) != NUM_WINDOWS:
            raise EigenError("circuit_error", "expected 68 window digits")
        tables = self._fixed_tables_for(base if base is not None
                                        else self.spec.gen)
        acc = self.constant_point(self.aux_init)
        for w, digit in enumerate(digits):
            acc = self.add(acc, self.select_point_const(digit, tables[w]))
        mass = self.spec.add(
            self.aux_init,
            self.spec.mul(self.aux_c, NUM_WINDOWS % self.spec.n),
        )
        return self.add(acc, self.constant_point(self.spec.neg(mass)))

    def _fixed_tables_for(self, base: tuple) -> list:
        key = base
        if key not in self._fixed_tables:
            tables = []
            for w in range(NUM_WINDOWS):
                window_base = self.spec.mul(
                    base, pow(TABLE_SIZE, w, self.spec.n))
                row = [self.aux_c]
                for d in range(1, TABLE_SIZE):
                    row.append(self.spec.add(row[-1], window_base))
                tables.append(row)
            self._fixed_tables[key] = tables
        return self._fixed_tables[key]

    # --- native-scalar path (same-curve chipset) --------------------------
    # Circuit twin of the reference's ``ecc/same_curve`` chipset
    # (eigentrust-zk/src/ecc/same_curve/mod.rs:134-1094 + native.rs):
    # when the curve's SCALAR field is the circuit's native field (bn254
    # G1 inside an Fr circuit — the in-circuit verifier's own folds),
    # the scalar needs no wrong-field RNS integer at all. The reference
    # Bits2Num's the native cell; here the cell decomposes into 64
    # lookup-constrained 4-bit windows, and a shared-doubling batched
    # MSM (its EccBatchedMulConfig counterpart) amortizes the 252
    # doublings across every point in a verifier fold.

    def native_digits(self, scalar: Cell) -> list:
        """64 LSB-first 4-bit digit cells of a NATIVE scalar cell.

        The recomposition constraint binds Σ dᵤ·16ᵘ ≡ scalar (mod r)
        only, so a malicious witness may encode scalar + k·r (k ≤ 5,
        still < 2^256). That freedom is harmless exactly here: r is the
        order of the curve's scalar group, so (s + k·r)·P = s·P — the
        same argument that lets the reference feed raw Bits2Num output
        to its same-curve mul (same_curve/mod.rs:134)."""
        c = self.chips
        v = c.value(scalar)
        digits = []
        terms = []
        for w in range(NATIVE_WINDOWS):
            dv = (v >> (WINDOW_BITS * w)) & (TABLE_SIZE - 1)
            d = c.assign_range(dv, WINDOW_BITS)
            digits.append(d)
            terms.append((1 << (WINDOW_BITS * w), d))
        c.assert_equal(c.lincomb(terms), scalar)
        return digits

    def msm_native(self, items: list) -> AssignedPoint:
        """Batched MSM Σ sᵢ·Pᵢ with ONE shared doubling chain.

        ``items``: (point, digits) pairs — point an ``AssignedPoint``
        (in-circuit 16-entry table, 15 adds) or a host (x, y) tuple
        (constant table, selects are pure lincombs); digits from
        :meth:`native_digits`. Every point rides the same 252 doubles
        (the per-point scalar_mul pays them each), which is where the
        verifier-fold row count collapses. Aux offsets keep the
        incomplete adds away from the identity; the aggregate aux mass
        2^252·Aux + K·(Σ16ᵘ)·C leaves with one constant-point add."""
        return self.msm_digits(items, NATIVE_WINDOWS)

    def msm_digits(self, items: list, num_windows: int) -> AssignedPoint:
        """Shared-doubling windowed MSM over 4-bit digit-cell scalars of
        ``num_windows`` LSB-first windows (the :meth:`msm_native` core,
        window count lifted so the EcdsaChip's GLV half-scalars — 33
        windows for |s| < 2^129 — ride the same loop)."""
        if not items:
            raise EigenError("circuit_error", "msm needs items")
        tables = []
        for pt, digits in items:
            if len(digits) != num_windows:
                raise EigenError(
                    "circuit_error",
                    f"expected {num_windows} window digits")
            if isinstance(pt, AssignedPoint):
                tbl = [self.constant_point(self.aux_c)]
                for _ in range(1, TABLE_SIZE):
                    tbl.append(self.add(tbl[-1], pt))
                tables.append((True, tbl))
            else:
                row = [self.aux_c]
                for _ in range(1, TABLE_SIZE):
                    row.append(self.spec.add(row[-1], pt))
                tables.append((False, row))
        acc = self.constant_point(self.aux_init)
        for w in reversed(range(num_windows)):
            if w != num_windows - 1:
                for _ in range(WINDOW_BITS):
                    acc = self.double(acc)
            for (in_circuit, tbl), (pt, digits) in zip(tables, items):
                sel = (self.select_point(digits[w], tbl) if in_circuit
                       else self.select_point_const(digits[w], tbl))
                acc = self.add(acc, sel)
        s_c = ((1 << (WINDOW_BITS * num_windows)) - 1) // (TABLE_SIZE - 1)
        mass = self.spec.add(
            self.spec.mul(self.aux_init,
                          pow(2, WINDOW_BITS * (num_windows - 1),
                              self.spec.n)),
            self.spec.mul(self.aux_c, len(items) * s_c % self.spec.n),
        )
        return self.add(acc, self.constant_point(self.spec.neg(mass)))

    def scalar_mul_native(self, pt: AssignedPoint, scalar: Cell
                          ) -> AssignedPoint:
        """Single variable-base mul by a native scalar cell."""
        return self.msm_native([(pt, self.native_digits(scalar))])

    def scalar_mul_fixed_native(self, digits: list,
                                base: tuple | None = None) -> AssignedPoint:
        """Fixed-base mul by native digits: 64 constant per-window
        tables T_w[d] = (d·16ʷ)·base + C — zero in-circuit doubles."""
        if len(digits) != NATIVE_WINDOWS:
            raise EigenError("circuit_error",
                             "expected 64 native window digits")
        base = base if base is not None else self.spec.gen
        # the native windows are exactly the first 64 of the generic 68
        tables = self._fixed_tables_for(base)[:NATIVE_WINDOWS]
        acc = self.constant_point(self.aux_init)
        for w, digit in enumerate(digits):
            acc = self.add(acc, self.select_point_const(digit, tables[w]))
        mass = self.spec.add(
            self.aux_init,
            self.spec.mul(self.aux_c, NATIVE_WINDOWS % self.spec.n),
        )
        return self.add(acc, self.constant_point(self.spec.neg(mass)))
