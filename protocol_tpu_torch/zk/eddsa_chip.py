"""Twisted-Edwards (BabyJubJub) point chips and the EdDSA verify chipset.

Circuit twins of ``crypto/edwards.py`` / ``crypto/eddsa.py`` — the
reference exports these as first-class circuit components
(``eigentrust-zk/src/edwards/mod.rs`` ``PointAddChip``/``MulScalarChip``,
``eigentrust-zk/src/eddsa/mod.rs`` ``EddsaChipset``; re-exported at
``lib.rs:58-60``) even though the ET4 pipeline itself signs with ECDSA.

BabyJubJub's base field IS BN254's scalar field, so every coordinate is
a native cell: point addition costs ~12 mul rows (add-2008-bbjlp),
doubling ~8, and a 254-bit double-and-add scalar mul ~7k rows — no RNS.

The verify chipset mirrors ``eddsa/native.rs`` exactly:
    h = Poseidon(Rx, Ry, PKx, PKy, msg)
    s·B8 == R + h·PK       (projective cross-equality, no inversions)
with s range-checked below the B8 suborder.
"""

from __future__ import annotations

from ..crypto.edwards import A, B8, D, SUBORDER, EdwardsPoint
from ..utils.fields import BN254_FR_MODULUS
from .gadgets import Cell, Chips
from .poseidon_chip import PoseidonChip

R = BN254_FR_MODULUS


class PointCells:
    """Projective BabyJubJub point as circuit cells."""

    def __init__(self, x: Cell, y: Cell, z: Cell):
        self.x, self.y, self.z = x, y, z


class EdwardsChip:
    """In-circuit twisted-Edwards arithmetic (projective bbjlp-2008,
    the same formulas as the native ``ProjectivePoint``)."""

    def __init__(self, chips: Chips):
        self.chips = chips

    def constant_point(self, pt: EdwardsPoint) -> PointCells:
        c = self.chips
        return PointCells(c.constant(pt.x), c.constant(pt.y), c.constant(1))

    def witness_affine(self, x: int, y: int) -> PointCells:
        """Witness an affine point and constrain it onto the curve:
        a·x² + y² = 1 + d·x²·y² (edwards/native.rs ``is_on_curve``)."""
        c = self.chips
        xc, yc = c.witness(x), c.witness(y)
        x2 = c.mul(xc, xc)
        y2 = c.mul(yc, yc)
        lhs = c.lincomb([(A, x2), (1, y2)])
        x2y2 = c.mul(x2, y2)
        rhs = c.lincomb([(D, x2y2)], const=1)
        c.assert_equal(lhs, rhs)
        return PointCells(xc, yc, c.constant(1))

    def add(self, p: PointCells, q: PointCells) -> PointCells:
        """add-2008-bbjlp — identical algebra to the native ``add``."""
        c = self.chips
        a = c.mul(p.z, q.z)
        b = c.mul(a, a)
        cc = c.mul(p.x, q.x)
        d = c.mul(p.y, q.y)
        e = c.mul_const(c.mul(cc, d), D)
        f = c.sub(b, e)
        g = c.add(b, e)
        pxy = c.add(p.x, p.y)
        qxy = c.add(q.x, q.y)
        cross = c.sub(c.sub(c.mul(pxy, qxy), cc), d)
        x3 = c.mul(c.mul(a, f), cross)
        y3 = c.mul(c.mul(a, g), c.sub(d, c.mul_const(cc, A)))
        z3 = c.mul(f, g)
        return PointCells(x3, y3, z3)

    def double(self, p: PointCells) -> PointCells:
        """dbl-2008-bbjlp — identical algebra to the native ``double``."""
        c = self.chips
        b = c.add(p.x, p.y)
        b = c.mul(b, b)
        cc = c.mul(p.x, p.x)
        d = c.mul(p.y, p.y)
        e = c.mul_const(cc, A)
        f = c.add(e, d)
        h = c.mul(p.z, p.z)
        j = c.lincomb([(1, f), (R - 2, h)])
        x3 = c.mul(c.sub(c.sub(b, cc), d), j)
        y3 = c.mul(f, c.sub(e, d))
        z3 = c.mul(f, j)
        return PointCells(x3, y3, z3)

    def select(self, bit: Cell, p: PointCells, q: PointCells) -> PointCells:
        c = self.chips
        return PointCells(c.select(bit, p.x, q.x),
                          c.select(bit, p.y, q.y),
                          c.select(bit, p.z, q.z))

    def _assert_bits_below(self, bits: list, bound: int) -> None:
        """Constrain the little-endian bit cells to compose a value
        STRICTLY below ``bound`` (MSB-down lexicographic scan). Without
        this, a 254-bit decomposition of an Fr element is non-canonical:
        bits of value+R also satisfy ``to_bits``, letting a prover
        smuggle a different effective scalar into ``mul_scalar``."""
        c = self.chips
        eq = c.constant(1)
        lt = c.constant(0)
        for i in range(len(bits) - 1, -1, -1):
            b = (bound >> i) & 1
            x = bits[i]
            if b == 1:
                lt = c.logic_or(lt, c.logic_and(eq, c.logic_not(x)))
                eq = c.logic_and(eq, x)
            else:
                eq = c.logic_and(eq, c.logic_not(x))
        c.assert_equal(lt, c.constant(1))

    def mul_scalar(self, p: PointCells, scalar: Cell,
                   num_bits: int = 254,
                   canonical_below: int | None = None) -> PointCells:
        """Double-and-add over the scalar's little-endian bits (the
        native ``mul_scalar`` loop with a select per bit).

        ``canonical_below``: when the scalar's range admits a second
        valid decomposition (num_bits wide enough to hold value+R), pass
        the tight bound so the bits are pinned to the canonical ones —
        soundness, not just correctness."""
        c = self.chips
        bits = c.to_bits(scalar, num_bits)
        if canonical_below is not None:
            self._assert_bits_below(bits, canonical_below)
        acc = PointCells(c.constant(0), c.constant(1), c.constant(1))
        exp = p
        for bit in bits:
            added = self.add(acc, exp)
            acc = self.select(bit, added, acc)
            exp = self.double(exp)
        return acc

    def assert_points_equal(self, p: PointCells, q: PointCells) -> None:
        """Projective equality via cross-multiplication."""
        c = self.chips
        c.assert_equal(c.mul(p.x, q.z), c.mul(q.x, p.z))
        c.assert_equal(c.mul(p.y, q.z), c.mul(q.y, p.z))


class EddsaChip:
    """EdDSA verification chipset (``eddsa/mod.rs`` ``EddsaChipset``)."""

    def __init__(self, chips: Chips):
        self.chips = chips
        self.ed = EdwardsChip(chips)
        self.poseidon = PoseidonChip(chips)

    def verify(self, big_r_x: int, big_r_y: int, s: int,
               pk_x: int, pk_y: int, message: int) -> None:
        """Constrain sig = (R, s) as a valid signature on ``message``
        under pk. Witnesses all inputs; callers copy/expose cells as
        needed via the returned chip state."""
        c = self.chips
        big_r = self.ed.witness_affine(big_r_x, big_r_y)
        pk = self.ed.witness_affine(pk_x, pk_y)
        s_cell = c.witness(s % R)
        msg = c.witness(message % R)

        # s below the B8 suborder (native: `sig.s > SUBORDER` reject)
        ok = c.less_eq(s_cell, c.constant(SUBORDER))
        c.assert_equal(ok, c.constant(1))

        h = self.poseidon.hash([big_r.x, big_r.y, pk.x, pk.y, msg])
        # s ≤ SUBORDER < 2^252, and s + R > 2^252: 252 bits make the
        # decomposition canonical by range alone. h is a full-width Fr
        # element, so its 254-bit decomposition needs the explicit
        # canonical bound (review finding: bits of h + R would otherwise
        # also satisfy the decomposition, verifying forged signatures).
        cl = self.ed.mul_scalar(self.ed.constant_point(EdwardsPoint.b8()),
                                s_cell, num_bits=252)
        pk_h = self.ed.mul_scalar(pk, h, num_bits=254, canonical_below=R)
        cr = self.ed.add(big_r, pk_h)
        self.ed.assert_points_equal(cl, cr)
