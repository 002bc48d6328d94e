"""Native Poseidon permutation, fixed-width hasher, and sponge.

Semantics mirror the reference's Hades implementation
(``eigentrust-zk/src/poseidon/native/mod.rs`` ``permute``: half full rounds,
partial rounds, half full rounds; round constants added to *every* lane in
every round — the un-optimized schedule of ``params/hasher/mod.rs``) and its
sponge (``poseidon/native/sponge.rs``: rate = WIDTH additive absorb, squeeze
returns ``state[0]``). Constants for the reference's shipped instances
(BN254 Fr width 5/10) come from its vendored tables
(``crypto/tables/``, bit-parity verified against the reference's golden
permutation vectors); other instances are Grain-generated (``grain.py``).

Internals run on raw Python ints mod p for speed; the public API accepts and
returns ``FieldElement``s.
"""

from __future__ import annotations

from typing import Sequence

from ..utils.fields import Fr, FieldElement
from .grain import generate_poseidon_params

# Reference instance: WIDTH=5, x^5 sbox, 8 full / 60 partial rounds over
# BN254 Fr (eigentrust-zk/src/params/hasher/poseidon_bn254_5x5.rs).
DEFAULT_WIDTH = 5
DEFAULT_FULL_ROUNDS = 8
DEFAULT_PARTIAL_ROUNDS = 60


def _table_params(width: int, modulus: int, full_rounds: int,
                  partial_rounds: int):
    """The reference's literal constant tables (vendored by
    tools/gen_hasher_tables.py) for the instances it ships: BN254 Fr at
    width 5 and 10. Using these makes every hash in this framework
    bit-identical to reference-produced data — an attestation signed
    under the reference's Poseidon validates here and vice versa."""
    if modulus != Fr.MODULUS:
        return None
    if (width, full_rounds, partial_rounds) == (5, 8, 60):
        from .tables import poseidon_bn254_5x5 as t
    elif (width, full_rounds, partial_rounds) == (10, 8, 60):
        from .tables import poseidon_bn254_10x5 as t
    else:
        return None
    return tuple(t.ROUND_CONSTANTS), t.MDS


def poseidon_params(width: int = DEFAULT_WIDTH, modulus: int = Fr.MODULUS,
                    full_rounds: int = DEFAULT_FULL_ROUNDS,
                    partial_rounds: int | None = None):
    """(round_constants, mds, full_rounds, partial_rounds) for an instance.

    Instances the reference ships constants for (BN254 Fr, width 5/10)
    use its vendored tables — bit-parity with reference hashes; any
    other instance falls back to Grain-LFSR generation (grain.py)."""
    if partial_rounds is None:
        partial_rounds = DEFAULT_PARTIAL_ROUNDS if width == 5 else 60
    table = _table_params(width, modulus, full_rounds, partial_rounds)
    if table is not None:
        rc, mds = table
    else:
        rc, mds = generate_poseidon_params(modulus, width, full_rounds,
                                           partial_rounds)
    return rc, mds, full_rounds, partial_rounds


def _permute_ints(state: list, modulus: int, rc, mds, full_rounds: int,
                  partial_rounds: int) -> list:
    width = len(state)
    half = full_rounds // 2
    idx = 0

    def full_round(state, idx):
        state = [(state[i] + rc[idx + i]) % modulus for i in range(width)]
        state = [pow(x, 5, modulus) for x in state]
        return _mds_mul(state), idx + width

    def _mds_mul(state):
        return [
            sum(mds[i][j] * state[j] for j in range(width)) % modulus
            for i in range(width)
        ]

    for _ in range(half):
        state, idx = full_round(state, idx)
    for _ in range(partial_rounds):
        state = [(state[i] + rc[idx + i]) % modulus for i in range(width)]
        state[0] = pow(state[0], 5, modulus)
        state = _mds_mul(state)
        idx += width
    for _ in range(half):
        state, idx = full_round(state, idx)
    return state


class Poseidon:
    """Fixed-width Poseidon hasher: ``finalize()`` = one permutation.

    Matches the reference ``Hasher`` trait shape (``eigentrust-zk/src/lib.rs``
    ``Hasher::new(inputs).finalize()``).
    """

    def __init__(self, inputs: Sequence[FieldElement], width: int = DEFAULT_WIDTH,
                 field: type = Fr):
        assert len(inputs) == width, "Poseidon input must be exactly WIDTH wide"
        self.field = field
        self.width = width
        self.inputs = list(inputs)

    def permute(self) -> list:
        rc, mds, fr_, pr_ = poseidon_params(self.width, self.field.MODULUS)
        state = [int(x) for x in self.inputs]
        out = _permute_ints(state, self.field.MODULUS, rc, mds, fr_, pr_)
        return [self.field(v) for v in out]

    def finalize(self) -> list:
        return self.permute()

    @classmethod
    def hash(cls, inputs: Sequence[FieldElement], width: int = DEFAULT_WIDTH,
             field: type = Fr) -> FieldElement:
        """Hash up to ``width`` elements (zero-padded), returning lane 0."""
        padded = list(inputs) + [field.zero()] * (width - len(inputs))
        return cls(padded, width, field).finalize()[0]


class PoseidonSponge:
    """Additive sponge with rate WIDTH, squeeze -> state[0].

    Mirrors ``poseidon/native/sponge.rs``: ``update`` buffers inputs;
    ``squeeze`` absorbs all buffered chunks (state += chunk; permute),
    clears the buffer, and returns ``state[0]``. An empty buffer absorbs a
    single zero.
    """

    def __init__(self, width: int = DEFAULT_WIDTH, field: type = Fr):
        self.width = width
        self.field = field
        self.state = [0] * width
        self.inputs: list = []

    def update(self, inputs: Sequence[FieldElement]):
        self.inputs.extend(int(x) for x in inputs)

    def squeeze(self) -> FieldElement:
        if not self.inputs:
            self.inputs.append(0)
        modulus = self.field.MODULUS
        rc, mds, fr_, pr_ = poseidon_params(self.width, modulus)
        for start in range(0, len(self.inputs), self.width):
            chunk = self.inputs[start : start + self.width]
            chunk = chunk + [0] * (self.width - len(chunk))
            state = [(s + c) % modulus for s, c in zip(self.state, chunk)]
            self.state = _permute_ints(state, modulus, rc, mds, fr_, pr_)
        self.inputs.clear()
        return self.field(self.state[0])
