"""Gadget chipsets over the framework's 5-wire main gate.

The reference builds every circuit out of a small gadget vocabulary on its
``MainChip`` gate (``eigentrust-zk/src/gadgets/main.rs:116-700``):
Add / Sub / Mul / MulAdd / IsBool / IsEqual / IsZero / Inverse / Select /
And / Or chipsets, plus ``Bits2NumChip`` (``gadgets/bits2num.rs:13``),
252-bit comparison ``LessEqualChipset`` (``gadgets/lt_eq.rs:22-114``), set
membership / position / item-select (``gadgets/set.rs:11,153,284``) and
range checks (``gadgets/range.rs``).

This module is the same vocabulary over ``plonk.ConstraintSystem``'s gate

    q_a·a + q_b·b + q_c·c + q_d·d + q_e·e
      + q_mul_ab·a·b + q_mul_cd·c·d + q_const = 0.

Differences from the reference, by design:

- Gadgets are plain methods on a ``Chips`` builder rather than halo2
  Chip/Chipset structs — there is no region/layouter machinery to thread,
  because our ConstraintSystem is row-based and single-region.
- Range checks use the proving stack's LogUp lookup column when the
  constraint system sets ``lookup_bits`` (the reference's range chips are
  likewise lookup-based, ``gadgets/range.rs``), and fall back to boolean
  decomposition (1 row/bit) otherwise.

Every gadget returns a ``Cell`` whose witness value is already assigned;
inputs are wired in with copy constraints, exactly like halo2's
``copy_advice``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

from ..utils.errors import EigenError
from ..utils.fields import BN254_FR_MODULUS
from .plonk import ConstraintSystem

R = BN254_FR_MODULUS


class Cell(NamedTuple):
    """A (wire, row) coordinate in the constraint system."""

    wire: int
    row: int


class Chips:
    """Gadget builder over a ConstraintSystem.

    All methods take/return ``Cell``s; witness values are tracked inside
    the constraint system's wire tables.
    """

    def __init__(self, cs: ConstraintSystem | None = None):
        self.cs = cs if cs is not None else ConstraintSystem()
        self._const_cache: dict = {}

    # --- plumbing ---------------------------------------------------------
    def value(self, cell: Cell) -> int:
        return self.cs.wires[cell.wire][cell.row]

    def witness(self, value: int) -> Cell:
        """A free (unconstrained) witness cell."""
        row = self.cs.add_row([int(value) % R])
        return Cell(0, row)

    def constant(self, value: int) -> Cell:
        """A cell constrained to equal ``value``: a − value = 0.
        Memoized — repeated constants share one row (copy constraints
        reference the same cell)."""
        value = int(value) % R
        hit = self._const_cache.get(value)
        if hit is not None:
            return hit
        row = self.cs.add_row([value], q_a=1, q_const=-value)
        cell = Cell(0, row)
        self._const_cache[value] = cell
        return cell

    def public(self, cell: Cell) -> int:
        """Expose ``cell`` as the next public input; returns its PI row."""
        row = self.cs.public_input(self.value(cell))
        self.cs.copy(cell, (0, row))
        return row

    def assert_equal(self, a: Cell, b: Cell) -> None:
        self.cs.copy(tuple(a), tuple(b))

    def assert_zero(self, a: Cell) -> None:
        row = self.cs.add_row([self.value(a)], q_a=1)
        self.cs.copy(tuple(a), (0, row))

    def _row(self, values, copies, **selectors) -> int:
        """add_row + copy-constrain listed input cells into their slots.

        ``copies`` maps slot index → source Cell (or None for fresh
        witnesses produced by this row).
        """
        row = self.cs.add_row(values, **selectors)
        for slot, src in copies.items():
            self.cs.copy(tuple(src), (slot, row))
        return row

    # --- arithmetic (MainChip chipsets, main.rs:116-700) ------------------
    def add(self, a: Cell, b: Cell) -> Cell:
        va, vb = self.value(a), self.value(b)
        row = self._row([va, vb, (va + vb) % R], {0: a, 1: b},
                        q_a=1, q_b=1, q_c=-1)
        return Cell(2, row)

    def sub(self, a: Cell, b: Cell) -> Cell:
        va, vb = self.value(a), self.value(b)
        row = self._row([va, vb, (va - vb) % R], {0: a, 1: b},
                        q_a=1, q_b=-1, q_c=-1)
        return Cell(2, row)

    def add_const(self, a: Cell, k: int) -> Cell:
        va = self.value(a)
        row = self._row([va, (va + k) % R], {0: a}, q_a=1, q_const=k, q_b=-1)
        return Cell(1, row)

    def mul_const(self, a: Cell, k: int) -> Cell:
        va = self.value(a)
        row = self._row([va, va * k % R], {0: a}, q_a=k, q_b=-1)
        return Cell(1, row)

    def mul(self, a: Cell, b: Cell) -> Cell:
        va, vb = self.value(a), self.value(b)
        row = self._row([va, vb, va * vb % R], {0: a, 1: b},
                        q_mul_ab=1, q_c=-1)
        return Cell(2, row)

    def mul_add(self, a: Cell, b: Cell, c: Cell) -> Cell:
        """a·b + c (MulAddChipset — the power-iteration workhorse,
        main.rs + dynamic_sets/mod.rs:641-657)."""
        va, vb, vc = self.value(a), self.value(b), self.value(c)
        row = self._row([va, vb, vc, (va * vb + vc) % R],
                        {0: a, 1: b, 2: c}, q_mul_ab=1, q_c=1, q_d=-1)
        return Cell(3, row)

    def lincomb(self, terms: Sequence[tuple[int, Cell]], const: int = 0) -> Cell:
        """Σ kᵢ·cellᵢ + const, packed 3 terms per row with a running
        accumulator chained through the 5th wire (no separate fold
        rows)."""
        pending = list(terms)
        if not pending:
            return self.constant(const)
        cs = self.cs
        wires = cs.wires
        copies = cs.copies
        acc: Cell | None = None
        acc_val = const
        sel_names = ("q_a", "q_b", "q_c", "q_d")
        while pending:
            # slot 0 carries the accumulator (when one exists)
            take = 4 if acc is None else 3
            chunk, pending = pending[:take], pending[take:]
            vals = []
            sels = {"q_e": -1}
            slot = 0
            if acc is not None:
                vals.append(acc_val)
                sels["q_a"] = 1
                slot = 1
            else:
                sels["q_const"] = const
            for k, cell in chunk:
                v = wires[cell[0]][cell[1]]
                vals.append(v)
                sels[sel_names[slot]] = k
                acc_val += k * v
                slot += 1
            acc_val %= R
            while len(vals) < 4:
                vals.append(0)
            vals.append(acc_val)
            row = cs.add_row(vals, **sels)
            base = 0
            if acc is not None:
                copies.append((tuple(acc), (0, row)))
                base = 1
            for i, (_, cell) in enumerate(chunk):
                copies.append((tuple(cell), (base + i, row)))
            acc = Cell(4, row)
        return acc

    # --- booleans ---------------------------------------------------------
    def assert_bool(self, a: Cell) -> None:
        """a² − a = 0 (IsBoolChipset)."""
        va = self.value(a)
        self._row([va, va], {0: a, 1: a}, q_mul_ab=1, q_a=-1)

    def is_zero(self, a: Cell) -> Cell:
        """1 if a == 0 else 0 (IsZeroChipset): witness inv with
        a·inv + out − 1 = 0 and a·out = 0."""
        va = self.value(a)
        inv = pow(va, -1, R) if va else 0
        out = 0 if va else 1
        row = self._row([va, inv, out], {0: a}, q_mul_ab=1, q_c=1, q_const=-1)
        out_cell = Cell(2, row)
        self._row([va, out], {0: a, 1: out_cell}, q_mul_ab=1)
        return out_cell

    def is_equal(self, a: Cell, b: Cell) -> Cell:
        return self.is_zero(self.sub(a, b))

    def inverse(self, a: Cell) -> Cell:
        """aˉ¹ with constraint a·inv = 1 (InverseChipset); raises on 0."""
        va = self.value(a)
        if va == 0:
            raise EigenError("circuit_error", "inverse of zero")
        vinv = pow(va, -1, R)
        row = self._row([va, vinv], {0: a}, q_mul_ab=1, q_const=-1)
        return Cell(1, row)

    def select(self, bit: Cell, a: Cell, b: Cell) -> Cell:
        """bit ? a : b (SelectChipset): bit·a − bit·b + b − out = 0.
        Caller must ensure ``bit`` is boolean-constrained."""
        vbit, va, vb = self.value(bit), self.value(a), self.value(b)
        out = va if vbit else vb
        row = self._row([vbit, va, vbit, vb, out],
                        {0: bit, 1: a, 2: bit, 3: b},
                        q_mul_ab=1, q_mul_cd=-1, q_d=1, q_e=-1)
        return Cell(4, row)

    def logic_and(self, a: Cell, b: Cell) -> Cell:
        """Boolean AND (AndChipset): asserts both inputs boolean."""
        self.assert_bool(a)
        self.assert_bool(b)
        return self.mul(a, b)

    def logic_or(self, a: Cell, b: Cell) -> Cell:
        """Boolean OR (OrChipset): a + b − a·b."""
        self.assert_bool(a)
        self.assert_bool(b)
        va, vb = self.value(a), self.value(b)
        out = (va + vb - va * vb) % R
        row = self._row([va, vb, out], {0: a, 1: b},
                        q_a=1, q_b=1, q_mul_ab=-1, q_c=-1)
        return Cell(2, row)

    def logic_not(self, a: Cell) -> Cell:
        self.assert_bool(a)
        va = self.value(a)
        row = self._row([va, (1 - va) % R], {0: a}, q_a=-1, q_const=1, q_b=-1)
        return Cell(1, row)

    # --- bit decomposition (Bits2NumChip, bits2num.rs:13) -----------------
    def to_bits(self, a: Cell, num_bits: int) -> list:
        """LSB-first boolean decomposition; constrains recomposition
        Σ bᵢ·2ⁱ == a. The witness must actually fit in ``num_bits``."""
        va = self.value(a)
        if va >> num_bits:
            raise EigenError("circuit_error",
                             f"value does not fit in {num_bits} bits")
        bits = []
        for i in range(num_bits):
            b = (va >> i) & 1
            row = self.cs.add_row([b, b], q_mul_ab=1, q_a=-1)
            self.cs.copy((0, row), (1, row))
            bits.append(Cell(0, row))
        # recomposition, MSB-first accumulator: acc ← 2·acc + bit
        acc = self.constant(0)
        for bit in reversed(bits):
            vacc, vbit = self.value(acc), self.value(bit)
            row = self._row([vacc, vbit, (2 * vacc + vbit) % R],
                            {0: acc, 1: bit}, q_a=2, q_b=1, q_c=-1)
            acc = Cell(2, row)
        self.assert_equal(acc, a)
        return bits

    def from_bits(self, bits: Sequence[Cell]) -> Cell:
        """Recompose LSB-first boolean cells into a value cell."""
        acc = self.constant(0)
        for bit in reversed(list(bits)):
            vacc, vbit = self.value(acc), self.value(bit)
            row = self._row([vacc, vbit, (2 * vacc + vbit) % R],
                            {0: acc, 1: bit}, q_a=2, q_b=1, q_c=-1)
            acc = Cell(2, row)
        return acc

    # --- range checks (lookup-backed when available, range.rs) ------------
    def lookup(self, value: int) -> Cell:
        """A fresh cell constrained to the range table
        [0, 2^lookup_bits)."""
        return Cell(*self.cs.lookup_row(value))

    def assign_range(self, value: int, num_bits: int) -> Cell:
        """Witness ``value`` already constrained to [0, 2^num_bits), in
        the fused row form: each row holds one lookup chunk in wire 5
        (copied to a gate wire) and chains the recomposition accumulator
        — ceil(bits/lookup_bits) rows total, the workhorse behind every
        limb assignment."""
        lb = self.cs.lookup_bits
        if not lb:
            cell = self.witness(value)
            self.to_bits(cell, num_bits)
            return cell
        value = int(value)
        if value < 0 or value >> num_bits:
            raise EigenError("circuit_error",
                             f"value does not fit in {num_bits} bits")
        cs = self.cs
        copies = cs.copies
        acc_cell = None
        acc_val = 0
        for i in range(0, num_bits, lb):
            width = min(lb, num_bits - i)
            cv = (value >> i) & ((1 << width) - 1)
            acc_new = acc_val + (cv << i)
            if acc_cell is None:
                row = cs.add_row([0, cv, acc_new, 0, 0, cv],
                                 q_b=1 << i, q_c=-1)
            else:
                row = cs.add_row([acc_val, cv, acc_new, 0, 0, cv],
                                 q_a=1, q_b=1 << i, q_c=-1)
                copies.append((tuple(acc_cell), (0, row)))
            copies.append(((1, row), (5, row)))
            if width < lb:
                # partial chunk: cv·2^(lb−width) must also be in the table
                sh = cv << (lb - width)
                row2 = cs.add_row([cv, sh, 0, 0, 0, sh],
                                  q_a=1 << (lb - width), q_b=-1)
                copies.append(((1, row), (0, row2)))
                copies.append(((1, row2), (5, row2)))
            acc_cell = Cell(2, row)
            acc_val = acc_new
        return acc_cell

    def range_check(self, a: Cell, num_bits: int) -> None:
        """0 ≤ a < 2^num_bits. Uses lookup chunks when the constraint
        system has a range table, boolean decomposition otherwise."""
        lb = self.cs.lookup_bits
        if not lb:
            self.to_bits(a, num_bits)
            return
        self.assert_equal(self.assign_range(self.value(a), num_bits), a)

    def split_high(self, a: Cell, num_bits: int) -> tuple:
        """For a < 2^(num_bits+1): a = top·2^num_bits + rest with top
        boolean and rest range-checked; returns (top, rest)."""
        va = self.value(a)
        top, rest = va >> num_bits, va & ((1 << num_bits) - 1)
        if top > 1:
            raise EigenError("circuit_error",
                             f"value does not fit in {num_bits}+1 bits")
        top_c = self.witness(top)
        self.assert_bool(top_c)
        rest_c = self.assign_range(rest, num_bits)
        self.assert_equal(
            self.lincomb([(1 << num_bits, top_c), (1, rest_c)]), a)
        return top_c, rest_c

    # --- comparison (LessEqualChipset, lt_eq.rs:22-114) -------------------
    N_SHIFTED_BITS = 253

    def less_than(self, a: Cell, b: Cell, num_bits: int = 252) -> Cell:
        """Strict a < b for a, b < 2^num_bits (callers must range-check
        inputs, as the reference does): decompose a + 2^num_bits − b and
        return NOT of the top bit."""
        if num_bits >= self.N_SHIFTED_BITS:
            raise EigenError("circuit_error", "compare width too large")
        sh = self.lincomb([(1, a), (-1, b)], const=1 << num_bits)
        top, _ = self.split_high(sh, num_bits)
        return self.logic_not(top)

    def less_eq(self, a: Cell, b: Cell, num_bits: int = 252) -> Cell:
        """a ≤ b == NOT(b < a)."""
        return self.logic_not(self.less_than(b, a, num_bits))

    # --- sets (set.rs:11,153,284) -----------------------------------------
    def set_membership(self, target: Cell, items: Sequence[Cell]) -> Cell:
        """1 iff target ∈ items (SetChipset): is_zero(Π (itemᵢ − target))."""
        prod = self.constant(1)
        for item in items:
            prod = self.mul(prod, self.sub(item, target))
        return self.is_zero(prod)

    def set_position(self, target: Cell, items: Sequence[Cell]) -> Cell:
        """Index of ``target`` in ``items`` (SetPositionChip). Constrains
        Σ eqᵢ = 1, so membership is enforced and the items visible to the
        sum must be distinct at the match (true for address sets)."""
        eqs = [self.is_equal(item, target) for item in items]
        total = self.lincomb([(1, e) for e in eqs])
        one = self.constant(1)
        self.assert_equal(total, one)
        return self.lincomb([(i, e) for i, e in enumerate(eqs)])

    def select_item(self, index: Cell, items: Sequence[Cell]) -> Cell:
        """items[index] (SelectItemChip): Σ is_eq(index, i)·itemᵢ with
        Σ is_eq = 1."""
        terms = []
        eqs = []
        for i, item in enumerate(items):
            eq = self.is_equal(index, self.constant(i))
            eqs.append(eq)
            terms.append((1, self.mul(eq, item)))
        total = self.lincomb([(1, e) for e in eqs])
        self.assert_equal(total, self.constant(1))
        return self.lincomb(terms)
