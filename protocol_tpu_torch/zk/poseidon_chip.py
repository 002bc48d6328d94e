"""Poseidon permutation and sponge as circuit chipsets.

Circuit twin of ``protocol_tpu_torch.crypto.poseidon`` (which mirrors the
reference's native Hades permutation, ``poseidon/native/mod.rs:34-96``).
The reference's circuit side is ``FullRoundChip``/``PartialRoundChip``
(``eigentrust-zk/src/poseidon/mod.rs:31+``) and
``PoseidonSpongeChipset`` (``poseidon/sponge.rs:29``); here both are
functions over the gadget builder:

- full round: state ← MDS · sbox(state + rc)      (sbox on every lane)
- partial round: sbox on lane 0 only
- sponge: rate-WIDTH additive absorb, permute per chunk, squeeze
  state[0] — matching the native ``PoseidonSponge`` exactly so the
  opinion-hash sponge constraint (``dynamic_sets/mod.rs``) can bind to
  the same values the host computes.

Row cost: x⁵ is 3 mul rows; a full round is WIDTH·(1 add-const + 3 mul)
+ WIDTH MDS lincombs ≈ 30 rows at WIDTH=5; the 8-full/60-partial BN254
instance costs ≈ 1.4k rows per permutation.
"""

from __future__ import annotations

from typing import Sequence

from ..crypto.poseidon import poseidon_params
from ..utils.fields import BN254_FR_MODULUS
from .gadgets import Cell, Chips

R = BN254_FR_MODULUS


class PoseidonChip:
    """Width-W Poseidon permutation over a gadget builder."""

    def __init__(self, chips: Chips, width: int = 5):
        self.chips = chips
        self.width = width
        rc, mds, full, partial = poseidon_params(width)
        self.rc, self.mds, self.full_rounds, self.partial_rounds = (
            rc, mds, full, partial)

    def _sbox(self, x: Cell) -> Cell:
        c = self.chips
        x2 = c.mul(x, x)
        x4 = c.mul(x2, x2)
        return c.mul(x4, x)

    def _mds_mul(self, state: list) -> list:
        c = self.chips
        return [
            c.lincomb([(self.mds[i][j], state[j]) for j in range(self.width)])
            for i in range(self.width)
        ]

    def permute(self, state: Sequence[Cell]) -> list:
        """One Hades permutation; returns the new state cells."""
        c = self.chips
        state = list(state)
        assert len(state) == self.width
        half = self.full_rounds // 2
        idx = 0

        for _ in range(half):
            state = [c.add_const(s, self.rc[idx + i]) for i, s in enumerate(state)]
            state = [self._sbox(s) for s in state]
            state = self._mds_mul(state)
            idx += self.width
        for _ in range(self.partial_rounds):
            state = [c.add_const(s, self.rc[idx + i]) for i, s in enumerate(state)]
            state[0] = self._sbox(state[0])
            state = self._mds_mul(state)
            idx += self.width
        for _ in range(half):
            state = [c.add_const(s, self.rc[idx + i]) for i, s in enumerate(state)]
            state = [self._sbox(s) for s in state]
            state = self._mds_mul(state)
            idx += self.width
        return state

    def hash(self, inputs: Sequence[Cell]) -> Cell:
        """Fixed-width hash: one permutation, returns lane 0 (the
        reference ``Hasher::finalize`` shape, lib.rs:86-101)."""
        assert len(inputs) == self.width
        return self.permute(inputs)[0]


class PoseidonSpongeChip:
    """Additive sponge over the permutation chip
    (PoseidonSpongeChipset, poseidon/sponge.rs:29)."""

    def __init__(self, chips: Chips, width: int = 5):
        self.chips = chips
        self.perm = PoseidonChip(chips, width)
        self.width = width
        self.state: list = [chips.constant(0) for _ in range(width)]
        self.absorbed: list = []

    def update(self, cells: Sequence[Cell]) -> None:
        self.absorbed.extend(cells)

    def squeeze(self) -> Cell:
        """Absorb all buffered chunks (state += chunk; permute), clear the
        buffer, return state[0] — native ``PoseidonSponge.squeeze`` parity
        including the absorb-a-zero-on-empty rule."""
        c = self.chips
        if not self.absorbed:
            self.absorbed.append(c.constant(0))
        for start in range(0, len(self.absorbed), self.width):
            chunk = self.absorbed[start : start + self.width]
            self.state = [
                c.add(s, x) if x is not None else s
                for s, x in zip(self.state,
                                list(chunk) + [None] * (self.width - len(chunk)))
            ]
            self.state = self.perm.permute(self.state)
        self.absorbed.clear()
        return self.state[0]
