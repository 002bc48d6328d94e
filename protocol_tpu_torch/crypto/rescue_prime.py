"""Rescue-Prime permutation + sponge — the alternative hasher family.

Native twin of ``eigentrust-zk/src/rescue_prime/native/{mod,sponge}.rs``:
8 full rounds, no partial rounds, x^5 forward sbox and x^(1/5) inverse
sbox (``params/hasher/rescue_prime_bn254_5x5.rs:8-36``). Each round is
sbox → MDS → add-consts(i) → sbox⁻¹ → MDS → add-consts(i+1), run for
``full_rounds - 1`` iterations (``rescue_prime/native/mod.rs:28-56``).

The BN254 width-5 instance uses the reference's literal constant tables
(vendored by ``tools/gen_hasher_tables.py`` from
``params/hasher/rescue_prime_bn254_5x5.rs``) for bit-parity — verified
against the matter-labs/rescue-poseidon golden vector the reference's
own test uses (``rescue_prime/native/mod.rs:93-100``). Other instances
are Grain-generated (``grain.py``). The sponge mirrors the reference's:
buffered absorb, ``state += chunk; permute`` per WIDTH-chunk, squeeze
returns state[0] (``rescue_prime/native/sponge.rs:46-64``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

from ..utils.fields import Fr, FieldElement
from .grain import generate_poseidon_params

DEFAULT_WIDTH = 5
FULL_ROUNDS = 8


@lru_cache(maxsize=None)
def rescue_prime_params(width: int = DEFAULT_WIDTH, modulus: int = Fr.MODULUS):
    """(round_constants, mds, inv_exponent) for a Rescue-Prime instance."""
    if width == 5 and modulus == Fr.MODULUS:
        from .tables import rescue_prime_bn254_5x5 as t

        rc, mds = tuple(t.ROUND_CONSTANTS), t.MDS
    else:
        rc, mds = generate_poseidon_params(modulus, width, FULL_ROUNDS, 0)
    inv5 = pow(5, -1, modulus - 1)
    return rc, mds, inv5


def _permute_ints(state: list, modulus: int, rc, mds, inv5: int) -> list:
    width = len(state)

    def mds_mul(s):
        return [
            sum(mds[i][j] * s[j] for j in range(width)) % modulus
            for i in range(width)
        ]

    def add_consts(s, round_idx):
        base = round_idx * width
        return [(s[i] + rc[base + i]) % modulus for i in range(width)]

    for i in range(FULL_ROUNDS - 1):
        state = [pow(x, 5, modulus) for x in state]
        state = mds_mul(state)
        state = add_consts(state, i)
        state = [pow(x, inv5, modulus) for x in state]
        state = mds_mul(state)
        state = add_consts(state, i + 1)
    return state


class RescuePrime:
    """Fixed-width Rescue-Prime hasher; ``finalize()`` = one permutation."""

    def __init__(self, inputs: Sequence[FieldElement], width: int = DEFAULT_WIDTH,
                 field: type = Fr):
        assert len(inputs) == width, "RescuePrime input must be exactly WIDTH wide"
        self.field = field
        self.width = width
        self.inputs = list(inputs)

    def permute(self) -> list:
        rc, mds, inv5 = rescue_prime_params(self.width, self.field.MODULUS)
        state = [int(x) for x in self.inputs]
        out = _permute_ints(state, self.field.MODULUS, rc, mds, inv5)
        return [self.field(v) for v in out]

    def finalize(self) -> list:
        return self.permute()

    @classmethod
    def hash(cls, inputs: Sequence[FieldElement], width: int = DEFAULT_WIDTH,
             field: type = Fr) -> FieldElement:
        padded = list(inputs) + [field.zero()] * (width - len(inputs))
        return cls(padded, width, field).finalize()[0]


class RescuePrimeSponge:
    """Additive sponge over the Rescue-Prime permutation."""

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
        rc, mds, inv5 = rescue_prime_params(self.width, modulus)
        for start in range(0, len(self.inputs), self.width):
            chunk = self.inputs[start : start + self.width]
            chunk = chunk + [0] * (self.width - len(chunk))
            state = [(s + c) % modulus for s, c in zip(self.state, chunk)]
            self.state = _permute_ints(state, modulus, rc, mds, inv5)
        self.inputs.clear()
        return self.field(self.state[0])
