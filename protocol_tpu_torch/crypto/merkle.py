"""Arity-N Merkle tree over a WIDTH-5 field hasher, with inclusion paths.

Native twin of ``eigentrust-zk/src/merkle_tree/native.rs``: leaves are
zero-padded to ``arity**height``, each node hashes ``arity`` children
zero-padded to the hasher width and takes lane 0
(``build_tree`` :29-57); a ``Path`` stores the full sibling group at
every level plus the root, and verifies by re-hashing each group and
checking membership in the next level's group (``find_path`` :79-97,
``verify`` :100-110).

The hasher is pluggable (Poseidon by default, Rescue-Prime works too) —
any class with ``(inputs, width, field) -> .finalize()[0]`` semantics.
"""

from __future__ import annotations

from typing import Sequence

from ..utils.fields import Fr, FieldElement
from .poseidon import Poseidon

WIDTH = 5


class MerkleTree:
    """Merkle tree keyed by (level -> list of nodes); level 0 = leaves."""

    def __init__(self, leaves: Sequence[FieldElement], height: int,
                 arity: int = 2, hasher: type = Poseidon, field: type = Fr):
        assert arity <= WIDTH, "arity must fit the hasher width"
        capacity = arity**height
        assert len(leaves) <= capacity, "too many leaves for height"
        self.arity = arity
        self.height = height
        self.hasher = hasher
        self.field = field

        level0 = list(leaves) + [field.zero()] * (capacity - len(leaves))
        self.nodes: dict[int, list] = {0: level0}
        for level in range(height):
            cur = self.nodes[level]
            nxt = []
            for i in range(0, len(cur), arity):
                inputs = cur[i : i + arity]
                inputs = inputs + [field.zero()] * (WIDTH - len(inputs))
                nxt.append(hasher(inputs, WIDTH, field).finalize()[0])
            self.nodes[level + 1] = nxt
        self.root = self.nodes[height][0]


class MerklePath:
    """Inclusion path: the full ``arity``-wide sibling group per level.

    The tree's arity/hasher/field bind to the path at ``find_path`` time,
    so ``verify()`` cannot be called with mismatched parameters."""

    def __init__(self, value: FieldElement, path_arr: list, arity: int = 2,
                 hasher: type = Poseidon, field: type = Fr):
        self.value = value
        self.path_arr = path_arr  # (height+1) rows; last row = [root, 0...]
        self.arity = arity
        self.hasher = hasher
        self.field = field

    @classmethod
    def find_path(cls, tree: MerkleTree, value_index: int) -> "MerklePath":
        value = tree.nodes[0][value_index]
        path_arr = []
        idx = value_index
        for level in range(tree.height):
            group_start = (idx // tree.arity) * tree.arity
            path_arr.append(
                list(tree.nodes[level][group_start : group_start + tree.arity])
            )
            idx //= tree.arity
        last = [tree.root] + [tree.field.zero()] * (tree.arity - 1)
        path_arr.append(last)
        return cls(value, path_arr, tree.arity, tree.hasher, tree.field)

    def verify(self) -> bool:
        # the claimed value must actually be the leaf this path opens
        ok = self.value in self.path_arr[0][: self.arity]
        for i in range(len(self.path_arr) - 1):
            group = self.path_arr[i][: self.arity]
            inputs = group + [self.field.zero()] * (WIDTH - len(group))
            digest = self.hasher(inputs, WIDTH, self.field).finalize()[0]
            ok &= digest in self.path_arr[i + 1][: self.arity]
        return ok
