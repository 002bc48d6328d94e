"""Grain-LFSR parameter generation for Poseidon-family hashers.

The reference ships its Poseidon round constants as literal hex tables
(``eigentrust-zk/src/params/hasher/poseidon_bn254_5x5.rs``). We instead
*generate* constants with the Grain LFSR procedure from the public Poseidon
specification (GKRRS'19, https://eprint.iacr.org/2019/458 — the
``generate_parameters_grain`` reference algorithm): deterministic,
auditable, and no constant tables to maintain. The MDS matrix is a Cauchy
matrix built from subsequent Grain stream elements.

For the instances the reference ships tables for, the table-driven params
in ``crypto/tables/`` are authoritative (see ``poseidon.poseidon_params``);
Grain remains the generator for every other instance. Notably the Grain
output here reproduces the reference's width-5 Poseidon table bit-for-bit
(round constants AND Cauchy MDS — two independent implementations
agreeing; tested in ``tests/test_reference_params.py``), while the
reference's 10x5 MDS and Rescue-Prime constants come from different
procedures and genuinely need the tables.
"""

from __future__ import annotations

from functools import lru_cache


class GrainLFSR:
    """80-bit Grain LFSR in self-shrinking mode, per the Poseidon spec."""

    def __init__(self, field_bits: int, width: int, full_rounds: int, partial_rounds: int):
        bits = []

        def push(value: int, nbits: int):
            for i in reversed(range(nbits)):
                bits.append((value >> i) & 1)

        push(1, 2)  # field type: GF(p)
        push(0, 4)  # sbox: x^alpha
        push(field_bits, 12)
        push(width, 12)
        push(full_rounds, 10)
        push(partial_rounds, 10)
        push((1 << 30) - 1, 30)
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._raw_bit()

    def _raw_bit(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(new)
        return new

    def bit(self) -> int:
        """Self-shrinking output: emit the second of a bit pair when the
        first is 1; discard otherwise."""
        while True:
            b1 = self._raw_bit()
            b2 = self._raw_bit()
            if b1:
                return b2

    def field_element(self, modulus: int, field_bits: int) -> int:
        """Sample a uniform field element by rejection on ``field_bits`` bits."""
        while True:
            v = 0
            for _ in range(field_bits):
                v = (v << 1) | self.bit()
            if v < modulus:
                return v


@lru_cache(maxsize=None)
def generate_poseidon_params(
    modulus: int, width: int, full_rounds: int, partial_rounds: int
):
    """Round constants and MDS matrix for a Poseidon instance.

    Returns ``(round_constants, mds)`` where ``round_constants`` has
    ``(full_rounds + partial_rounds) * width`` entries (one per state lane
    per round, matching the reference's un-optimized constant schedule in
    ``params/hasher/mod.rs``) and ``mds`` is a width×width Cauchy matrix
    ``M[i][j] = 1 / (x_i + y_j)``.
    """
    field_bits = modulus.bit_length()
    lfsr = GrainLFSR(field_bits, width, full_rounds, partial_rounds)

    n_constants = (full_rounds + partial_rounds) * width
    round_constants = [lfsr.field_element(modulus, field_bits) for _ in range(n_constants)]

    # Cauchy MDS from the continued stream; distinctness of {x_i} and {y_j}
    # and x_i + y_j != 0 guarantee invertibility and well-definedness.
    while True:
        xs = [lfsr.field_element(modulus, field_bits) for _ in range(width)]
        ys = [lfsr.field_element(modulus, field_bits) for _ in range(width)]
        ok = len(set(xs)) == width and len(set(ys)) == width
        ok = ok and all((x + y) % modulus != 0 for x in xs for y in ys)
        if ok:
            break
    mds = [[pow((x + y) % modulus, -1, modulus) for y in ys] for x in xs]

    return tuple(round_constants), tuple(tuple(row) for row in mds)
