"""Rescue-Prime permutation and sponge chips.

Circuit twin of ``crypto/rescue_prime.py`` — the reference ships Rescue
chips alongside Poseidon's (``eigentrust-zk/src/rescue_prime/mod.rs``,
exported at ``lib.rs:70``). Round schedule (``rescue_prime/native/
mod.rs:28-56``): for i in 0..N−1: sbox → MDS → consts(i) → sbox⁻¹ →
MDS → consts(i+1).

The inverse S-box x^{1/5} is the interesting constraint: instead of an
in-circuit 254-bit exponentiation, the chip witnesses y = x^{1/5} and
constrains y⁵ = x — three mul rows, same soundness (x ↦ x⁵ is a
bijection on Fr)."""

from __future__ import annotations

from typing import Sequence

from ..crypto.rescue_prime import DEFAULT_WIDTH, FULL_ROUNDS, rescue_prime_params
from ..utils.fields import BN254_FR_MODULUS
from .gadgets import Cell, Chips

R = BN254_FR_MODULUS


class RescuePrimeChip:
    """Width-W Rescue-Prime permutation over the gadget builder."""

    def __init__(self, chips: Chips, width: int = DEFAULT_WIDTH):
        self.chips = chips
        self.width = width
        rc, mds, inv5 = rescue_prime_params(width)
        self.rc, self.mds, self.inv5 = rc, mds, inv5

    def _sbox(self, x: Cell) -> Cell:
        c = self.chips
        x2 = c.mul(x, x)
        x4 = c.mul(x2, x2)
        return c.mul(x4, x)

    def _sbox_inv(self, x: Cell) -> Cell:
        """Witness y = x^{1/5}; constrain y⁵ = x."""
        c = self.chips
        y_val = pow(c.value(x), self.inv5, R)
        y = c.witness(y_val)
        c.assert_equal(self._sbox(y), x)
        return y

    def _mds_mul(self, state: list) -> list:
        c = self.chips
        return [
            c.lincomb([(self.mds[i][j], state[j])
                       for j in range(self.width)])
            for i in range(self.width)
        ]

    def _add_consts(self, state: list, round_idx: int) -> list:
        c = self.chips
        base = round_idx * self.width
        return [c.add_const(s, self.rc[base + i])
                for i, s in enumerate(state)]

    def permute(self, state: Sequence[Cell]) -> list:
        c = self.chips
        state = list(state)
        assert len(state) == self.width
        for i in range(FULL_ROUNDS - 1):
            state = [self._sbox(s) for s in state]
            state = self._mds_mul(state)
            state = self._add_consts(state, i)
            state = [self._sbox_inv(s) for s in state]
            state = self._mds_mul(state)
            state = self._add_consts(state, i + 1)
        return state

    def hash(self, inputs: Sequence[Cell]) -> Cell:
        assert len(inputs) == self.width
        return self.permute(inputs)[0]


class RescuePrimeSpongeChip:
    """Additive sponge over the Rescue permutation
    (``rescue_prime/native/sponge.rs`` parity, same shape as the
    Poseidon sponge chip)."""

    def __init__(self, chips: Chips, width: int = DEFAULT_WIDTH):
        self.chips = chips
        self.perm = RescuePrimeChip(chips, width)
        self.width = width
        self.state: list = [chips.constant(0) for _ in range(width)]
        self.absorbed: list = []

    def update(self, cells: Sequence[Cell]) -> None:
        self.absorbed.extend(cells)

    def squeeze(self) -> Cell:
        c = self.chips
        if not self.absorbed:
            self.absorbed.append(c.constant(0))
        for start in range(0, len(self.absorbed), self.width):
            chunk = self.absorbed[start : start + self.width]
            self.state = [
                c.add(s, x) if x is not None else s
                for s, x in zip(self.state,
                                list(chunk)
                                + [None] * (self.width - len(chunk)))
            ]
            self.state = self.perm.permute(self.state)
        self.absorbed.clear()
        return self.state[0]
