"""Wrong-field (RNS) integer arithmetic chips.

Circuit twin of the reference's ``integer`` module: 4-limb × 68-bit
residue-number-system big-int ops as chips with CRT constraints
(``eigentrust-zk/src/integer/mod.rs:149-964``, native witnesses
``integer/native.rs:46-69``, RNS params ``params/rns/mod.rs:21-185``).

An integer x in the wrong field F_p is carried as 4 limbs x = Σ xᵢ·Bⁱ,
B = 2^68, each limb a native cell. The core constraint is the CRT
multiplication identity

    a·b + OFF·p − out  =  q·p      (over ℤ)

checked (1) mod 2^272 via two 136-bit carry chains with range-checked,
offset-shifted (possibly negative) carries, and (2) mod the native
modulus r on recomposed limb values — sound because both sides stay
below r·2^272. Per-limb bit bounds are tracked at build time,
witness-independently; bound violations raise before any constraint is
emitted, forcing an explicit ``reduce()``. ``OFF`` is a constant
multiple of p that keeps q non-negative when out may exceed a·b
(division/reduction uses).

Differences from the reference, by design: the reference pairs each
``ReductionWitness`` with lookup-table range chips; here limb range
checks ride the proving stack's LogUp lookup column directly, and loose
(unreduced) results carry their bounds so reduction happens exactly
where the CRT bound demands it rather than after every op.
"""

from __future__ import annotations

from ..utils.errors import EigenError
from ..utils.fields import BN254_FR_MODULUS
from .gadgets import Cell, Chips

R = BN254_FR_MODULUS

NUM_LIMBS = 4
LIMB_BITS = 68
B = 1 << LIMB_BITS
TOTAL_BITS = NUM_LIMBS * LIMB_BITS  # 272
CARRY_SHIFT = 2 * LIMB_BITS  # carries propagate per 136-bit half


def to_limbs(value: int) -> list:
    """4 limbs, little-endian; the top limb keeps any overflow ≥ 2^272."""
    return [
        (value >> (LIMB_BITS * i)) & (B - 1) if i < NUM_LIMBS - 1
        else value >> (LIMB_BITS * i)
        for i in range(NUM_LIMBS)
    ]


def from_limbs(limbs) -> int:
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(limbs))


class AssignedInteger:
    """Limb cells + exact integer bookkeeping.

    ``value`` is the true integer value of the limb combination (not
    reduced mod p); ``max_limb[i]`` bounds limb i witness-independently;
    ``constant`` marks compile-time constants (products with them are
    linear — no mul rows)."""

    __slots__ = ("limbs", "value", "max_limb", "constant")

    def __init__(self, limbs, value, max_limb, constant=False):
        self.limbs = limbs
        self.value = value
        self.max_limb = list(max_limb)  # inclusive upper bounds, ints
        self.constant = constant

    @property
    def max_value(self) -> int:
        return from_limbs(self.max_limb)


class IntegerChip:
    """RNS ops over one wrong modulus p (IntegerMul/Add/Sub/Div/Reduce
    chips, integer/mod.rs:149-743)."""

    def __init__(self, chips: Chips, p: int):
        self.chips = chips
        self.p = p
        self.p_limbs = to_limbs(p)
        self.p_native = p % R
        # p' = −p mod 2^272 for the all-positive carry chains
        self.neg_p_limbs = to_limbs(((1 << TOTAL_BITS) - p) % (1 << TOTAL_BITS))
        self.b_pows = [pow(2, LIMB_BITS * i, R) for i in range(NUM_LIMBS)]
        # canonical reps of values < 2^(p_bits+1) — top limb tightened so
        # products of two assigned integers always clear the CRT bound
        self.top_bits = max(1, p.bit_length() - 3 * LIMB_BITS + 1)
        self._one = None

    # --- assignment -------------------------------------------------------
    def assign(self, value: int) -> AssignedInteger:
        """Witness an integer < 2^(204 + top_bits) (covers any value < 2p);
        limbs lookup-range-checked."""
        value = int(value)
        limb_bits = [LIMB_BITS] * (NUM_LIMBS - 1) + [self.top_bits]
        if value < 0 or value >= 1 << (3 * LIMB_BITS + self.top_bits):
            raise EigenError("circuit_error", "integer witness out of range")
        c = self.chips
        limbs = [c.assign_range(lv, bits)
                 for lv, bits in zip(to_limbs(value), limb_bits)]
        return AssignedInteger(limbs, value, [(1 << b) - 1 for b in limb_bits])

    def constant(self, value: int) -> AssignedInteger:
        c = self.chips
        lvs = to_limbs(int(value))
        limbs = [c.constant(lv) for lv in lvs]
        return AssignedInteger(limbs, int(value), lvs, constant=True)

    def one(self) -> AssignedInteger:
        if self._one is None:
            self._one = self.constant(1)
        return self._one

    def native(self, a: AssignedInteger) -> Cell:
        """Recompose limbs mod the native field: Σ limbᵢ·(Bⁱ mod r)."""
        return self.chips.lincomb(
            [(self.b_pows[i], a.limbs[i]) for i in range(NUM_LIMBS)])

    # --- linear ops -------------------------------------------------------
    def add(self, a: AssignedInteger, b: AssignedInteger) -> AssignedInteger:
        c = self.chips
        limbs = [c.add(a.limbs[i], b.limbs[i]) for i in range(NUM_LIMBS)]
        mx = [a.max_limb[i] + b.max_limb[i] for i in range(NUM_LIMBS)]
        self._check_limb_growth(mx)
        return AssignedInteger(limbs, a.value + b.value, mx)

    def sub(self, a: AssignedInteger, b: AssignedInteger) -> AssignedInteger:
        """a − b + aux where aux is a constant multiple of p whose limbs
        dominate b's bounds, so every limb stays non-negative (the
        reference SubChip's aux trick)."""
        aux = self._sub_aux(b.max_limb)
        c = self.chips
        limbs = [
            c.lincomb([(1, a.limbs[i]), (-1, b.limbs[i])], const=aux[i])
            for i in range(NUM_LIMBS)
        ]
        mx = [a.max_limb[i] + aux[i] for i in range(NUM_LIMBS)]
        self._check_limb_growth(mx)
        value = a.value - b.value + from_limbs(aux)
        return AssignedInteger(limbs, value, mx)

    def mul_small(self, a: AssignedInteger, k: int) -> AssignedInteger:
        c = self.chips
        limbs = [c.mul_const(a.limbs[i], k) for i in range(NUM_LIMBS)]
        mx = [a.max_limb[i] * k for i in range(NUM_LIMBS)]
        self._check_limb_growth(mx)
        return AssignedInteger(limbs, a.value * k, mx)

    def _sub_aux(self, b_max_limb) -> list:
        """Limbs of k·p, borrow-shuffled so aux_i > b_max_limb[i] for all
        i; the top limb may exceed 68 bits (exactness kept via value
        bookkeeping)."""
        k = max(1, (from_limbs(b_max_limb) + self.p) // self.p)
        for _ in range(64):
            aux = to_limbs(k * self.p)
            for i in range(NUM_LIMBS - 1):
                while aux[i] <= b_max_limb[i]:
                    aux[i] += B
                    aux[i + 1] -= 1
            if aux[NUM_LIMBS - 1] > b_max_limb[NUM_LIMBS - 1]:
                if from_limbs(aux) != k * self.p:
                    raise EigenError("circuit_error", "sub aux inconsistent")
                return aux
            k *= 2
        raise EigenError("circuit_error", "sub aux construction failed")

    def _check_limb_growth(self, mx) -> None:
        if any(m >= 1 << (LIMB_BITS + 40) for m in mx):
            raise EigenError(
                "circuit_error",
                "limb bound overflow — reduce() the operand first")

    # --- the CRT multiplication identity ----------------------------------
    def constrain_mul(self, a: AssignedInteger, b: AssignedInteger,
                      out: AssignedInteger) -> None:
        """Constrain a·b ≡ out (mod p) via a·b + OFF·p − out = q·p over ℤ."""
        p = self.p
        # build-time soundness bounds (witness-independent)
        off = out.max_value // p + 1
        lhs_max = a.max_value * b.max_value + off * p
        q_max = lhs_max // p
        if q_max >= 1 << TOTAL_BITS:
            raise EigenError("circuit_error",
                             "mul operands too large — reduce first")
        if lhs_max + q_max * p >= R << TOTAL_BITS:
            raise EigenError("circuit_error",
                             "CRT bound exceeded — reduce operands first")
        if (a.value * b.value + off * p - out.value) % p:
            raise EigenError("circuit_error",
                             "constrain_mul on non-congruent witnesses")
        q_val = (a.value * b.value + off * p - out.value) // p

        c = self.chips
        q = self._assign_q(q_val, q_max)

        # limb products a_j·b_k for j+k ≤ 3 (linear if either is constant)
        prods: dict = {}
        for j in range(NUM_LIMBS):
            for k in range(NUM_LIMBS - j):
                prods[(j, k)] = self._limb_product(a, b, j, k)

        off_limbs = to_limbs((off * p) % (1 << TOTAL_BITS))
        carry_cell = None
        carry_val = 0
        carry_mag = 0  # |carry| < carry_mag
        for half in range(2):
            terms: list = []
            const = 0
            pos_max = 0
            neg_max = 0
            u_val = 0
            for sub_i in range(2):
                i = 2 * half + sub_i
                w = 1 << (LIMB_BITS * sub_i)
                const += off_limbs[i] * w
                pos_max += off_limbs[i] * w
                u_val += off_limbs[i] * w
                for j in range(i + 1):
                    k = i - j
                    coeff, cell, cmax = prods[(j, k)]
                    if cell is None:
                        const += coeff * w
                        pos_max += coeff * w
                        u_val += coeff * w
                    else:
                        terms.append((coeff * w, cell))
                        pos_max += coeff * cmax * w
                        u_val += coeff * c.value(cell) * w
                    pk = self.neg_p_limbs[k]
                    if pk:
                        terms.append((pk * w, q.limbs[j]))
                        pos_max += pk * q.max_limb[j] * w
                        u_val += pk * c.value(q.limbs[j]) * w
                terms.append((-w, out.limbs[i]))
                neg_max += out.max_limb[i] * w
                u_val -= c.value(out.limbs[i]) * w
            if carry_cell is not None:
                terms.append((1, carry_cell))
                pos_max += carry_mag
                neg_max += carry_mag
                u_val += carry_val
            u = c.lincomb(terms, const=const)
            if u_val % (1 << CARRY_SHIFT):
                raise EigenError("circuit_error", "carry chain misaligned")
            v_val = u_val >> CARRY_SHIFT
            vb = max(pos_max, neg_max).bit_length() - CARRY_SHIFT + 2
            # u = (v_shifted − 2^vb)·2^136, v_shifted range-checked: the
            # signed carry v lives in [−2^vb, 2^vb); native exactness needs
            # max(pos_max, neg_max) + 2^(vb+136) < r (checked)
            if max(pos_max, neg_max) + (1 << (vb + CARRY_SHIFT)) >= R:
                raise EigenError("circuit_error", "carry bound exceeds field")
            v_shifted = c.assign_range(v_val + (1 << vb), vb + 1)
            c.assert_equal(
                c.lincomb([(1 << CARRY_SHIFT, v_shifted)],
                          const=-(1 << (vb + CARRY_SHIFT))),
                u)
            carry_cell = c.lincomb([(1, v_shifted)], const=-(1 << vb))
            carry_val = v_val
            carry_mag = 1 << vb
        # the final carry absorbs the ≥2^272 share; the native (mod r) leg
        # closes the CRT:
        a_n = self.native(a)
        b_n = self.native(b)
        q_n = self.native(q)
        out_n = self.native(out)
        row = c.cs.add_row(
            [c.value(a_n), c.value(b_n), c.value(q_n), c.value(out_n)],
            q_mul_ab=1, q_c=-self.p_native, q_d=-1,
            q_const=(off * p) % R)
        c.cs.copy(tuple(a_n), (0, row))
        c.cs.copy(tuple(b_n), (1, row))
        c.cs.copy(tuple(q_n), (2, row))
        c.cs.copy(tuple(out_n), (3, row))

    def _assign_q(self, q_val: int, q_max: int) -> AssignedInteger:
        c = self.chips
        limbs = []
        mx = []
        top_bits = max(1, q_max.bit_length() - 3 * LIMB_BITS)
        for i, lv in enumerate(to_limbs(q_val)):
            bits = LIMB_BITS if i < NUM_LIMBS - 1 else top_bits
            limbs.append(c.assign_range(lv, bits))
            mx.append((1 << bits) - 1)
        return AssignedInteger(limbs, q_val, mx)

    def _limb_product(self, a, b, j, k):
        """(coeff, cell_or_None, cell_max) for a_j·b_k."""
        c = self.chips
        av = c.value(a.limbs[j])
        bv = c.value(b.limbs[k])
        if a.constant and b.constant:
            return (av * bv, None, 1)
        if a.constant:
            return (av, b.limbs[k], b.max_limb[k])
        if b.constant:
            return (bv, a.limbs[j], a.max_limb[j])
        cell = c.mul(a.limbs[j], b.limbs[k])
        return (1, cell, a.max_limb[j] * b.max_limb[k])

    # --- derived ops ------------------------------------------------------
    def mul(self, a: AssignedInteger, b: AssignedInteger) -> AssignedInteger:
        out = self.assign(a.value * b.value % self.p)
        self.constrain_mul(a, b, out)
        return out

    def square(self, a: AssignedInteger) -> AssignedInteger:
        return self.mul(a, a)

    def reduce(self, a: AssignedInteger) -> AssignedInteger:
        """Fresh 68-bit-limb representative ≡ a (mod p)
        (IntegerReduceChip, integer/mod.rs:149)."""
        out = self.assign(a.value % self.p)
        self.constrain_mul(a, self.one(), out)
        return out

    def div(self, a: AssignedInteger, b: AssignedInteger) -> AssignedInteger:
        """w with w·b ≡ a (mod p) (IntegerDivChip, integer/mod.rs:609)."""
        b_red = b.value % self.p
        if b_red == 0:
            raise EigenError("circuit_error", "wrong-field division by zero")
        w_val = a.value % self.p * pow(b_red, -1, self.p) % self.p
        w = self.assign(w_val)
        self.constrain_mul(w, b, a)
        return w

    def assert_not_zero(self, a: AssignedInteger) -> None:
        """a ≢ 0 (mod p): witness inv with a·inv ≡ 1."""
        a_red = a.value % self.p
        if a_red == 0:
            raise EigenError("circuit_error", "assert_not_zero on zero")
        inv = self.assign(pow(a_red, -1, self.p))
        self.constrain_mul(a, inv, self.one())

    def assert_equal(self, a: AssignedInteger, b: AssignedInteger) -> None:
        """Limbwise equality — both sides must be the same representative
        (reduce() + assert_canonical() first when provenance differs);
        IntegerEqualChipset (integer/mod.rs:730-743)."""
        for i in range(NUM_LIMBS):
            self.chips.assert_equal(a.limbs[i], b.limbs[i])

    def assert_canonical(self, a: AssignedInteger) -> None:
        """a < p by lexicographic limb comparison, low→high fold:
        result = ltᵢ ∨ (eqᵢ ∧ result)."""
        c = self.chips
        if any(m >= B for m in a.max_limb):
            raise EigenError("circuit_error",
                             "canonical check needs 68-bit limbs")
        result = None
        for i in range(NUM_LIMBS):
            pl = c.constant(self.p_limbs[i])
            lt = c.less_than(a.limbs[i], pl, num_bits=LIMB_BITS + 1)
            eq = c.is_equal(a.limbs[i], pl)
            result = lt if result is None else c.logic_or(lt, c.logic_and(eq, result))
        c.assert_equal(result, c.constant(1))

    def select(self, bit: Cell, a: AssignedInteger,
               b: AssignedInteger) -> AssignedInteger:
        """bit ? a : b, limbwise."""
        c = self.chips
        limbs = [c.select(bit, a.limbs[i], b.limbs[i])
                 for i in range(NUM_LIMBS)]
        value = a.value if c.value(bit) else b.value
        mx = [max(a.max_limb[i], b.max_limb[i]) for i in range(NUM_LIMBS)]
        return AssignedInteger(limbs, value, mx)

    def to_window_digits(self, a: AssignedInteger,
                         window_bits: int = 4) -> list:
        """LSB-first window digits of a's limbs, each constrained to
        [0, 2^w); recomposition binds digits to limbs. Limbs must be in
        68-bit form."""
        c = self.chips
        lb = c.cs.lookup_bits
        if LIMB_BITS % window_bits:
            raise EigenError("circuit_error", "window must divide 68")
        digits = []
        for i in range(NUM_LIMBS):
            if a.max_limb[i] >= B:
                raise EigenError("circuit_error", "reduce before digits")
            lv = c.value(a.limbs[i])
            terms = []
            for w in range(LIMB_BITS // window_bits):
                dv = (lv >> (w * window_bits)) & ((1 << window_bits) - 1)
                if lb:
                    d = c.lookup(dv)
                    if window_bits < lb:
                        c.assert_equal(
                            c.mul_const(d, 1 << (lb - window_bits)),
                            c.lookup(dv << (lb - window_bits)))
                else:
                    d = c.witness(dv)
                    c.to_bits(d, window_bits)
                terms.append((1 << (w * window_bits), d))
                digits.append(d)
            c.assert_equal(c.lincomb(terms), a.limbs[i])
        return digits
