"""Arity-N Poseidon Merkle path chipset.

Circuit twin of ``crypto/merkle.py`` (``MerklePath.verify``), mirroring
the reference's ``MerklePathChip`` (``eigentrust-zk/src/merkle_tree/
mod.rs``, 586 LoC; exported at ``lib.rs:64``): each level's full
sibling group is witnessed, the previous digest must be a member of the
group (SetChipset membership), the group hashes with the width-5
Poseidon chip, and the last row's first cell is the root."""

from __future__ import annotations

from ..crypto.merkle import WIDTH, MerklePath
from .gadgets import Cell, Chips
from .poseidon_chip import PoseidonChip


class MerklePathChip:
    """Constrains a ``crypto.merkle.MerklePath`` in-circuit."""

    def __init__(self, chips: Chips, arity: int = 2):
        assert arity <= WIDTH
        self.chips = chips
        self.arity = arity
        self.poseidon = PoseidonChip(chips, WIDTH)

    def verify(self, path: MerklePath) -> Cell:
        """Witness the path rows, constrain every level, and return the
        root cell (callers bind it to a public input or another chip)."""
        c = self.chips
        assert path.arity == self.arity
        rows = [[c.witness(int(v)) for v in row[: self.arity]]
                for row in path.path_arr]
        value = c.witness(int(path.value))

        member = c.set_membership(value, rows[0])
        c.assert_equal(member, c.constant(1))
        for level in range(len(rows) - 1):
            group = rows[level] + [
                c.constant(0) for _ in range(WIDTH - self.arity)
            ]
            digest = self.poseidon.hash(group)
            if level + 1 < len(rows) - 1:
                up = c.set_membership(digest, rows[level + 1])
                c.assert_equal(up, c.constant(1))
            else:
                # the top digest must EQUAL the root cell — membership in
                # the witnessed last row would let a prover park the
                # claimed root at index 0 and a forged chain's digest at
                # index 1, proving any value under any root
                c.assert_equal(digest, rows[-1][0])
        return rows[-1][0]
