"""Threshold check: prove-friendly "score ≥ threshold" on rational scores.

Mirrors the reference's native Threshold twin
(``eigentrust-zk/src/circuits/threshold/native.rs``) and its decimal
compose/decompose helpers (``params/rns/mod.rs:202-252``):

- the rational score num/den are scaled by a power of ten so the larger of
  the two has exactly NUM_LIMBS × POWER_OF_TEN decimal digits,
- both are decomposed into NUM_LIMBS base-10^POWER_OF_TEN limbs
  (little-endian: limb 0 least significant),
- the check compares only the most-significant limbs:
  last(num) ≥ last(den) · threshold — a deliberate precision floor,
- consistency with the field score is asserted: compose(num) ·
  compose(den)⁻¹ == score in Fr.

Defaults match the reference's N=4 calibration: NUM_LIMBS=2,
POWER_OF_TEN=72 (``circuits/mod.rs:53-55``).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Sequence

from ..utils.fields import Fr


def decompose_big_decimal(value: int, num_limbs: int, power_of_ten: int) -> list:
    """Split a non-negative int into base-10^power_of_ten limbs (LE)."""
    base = 10**power_of_ten
    limbs = []
    for _ in range(num_limbs):
        value, limb = divmod(value, base)
        limbs.append(Fr(limb))
    assert value == 0, "value does not fit in the limb budget"
    return limbs


def compose_big_decimal(limbs: Sequence[Fr], power_of_ten: int) -> Fr:
    """Recompose limbs into a field element: Σ limb_i · 10^(i·P)."""
    base = Fr(10**power_of_ten)
    acc = Fr.zero()
    for limb in reversed(list(limbs)):
        acc = acc * base + limb
    return acc


class Threshold:
    """Threshold check over one peer's (field score, rational score) pair."""

    def __init__(self, score: Fr, ratio: Fraction, threshold: Fr,
                 num_limbs: int = 2, power_of_ten: int = 72,
                 num_neighbours: int = 4, initial_score: int = 1000):
        self.num_limbs = num_limbs
        self.power_of_ten = power_of_ten
        self.num_neighbours = num_neighbours
        self.initial_score = initial_score

        # Limb capacity sanity check (threshold/native.rs:34-37).
        max_score = num_neighbours * initial_score
        max_limb = 10**power_of_ten - 1
        assert max_score * max_limb < Fr.MODULUS - 1

        num, den = ratio.numerator, ratio.denominator
        max_len = num_limbs * power_of_ten
        dig_len = len(str(max(num, den)))
        assert dig_len <= max_len, (
            f"ratio has {dig_len} digits, exceeding the {max_len}-digit limb "
            "budget; raise num_limbs/power_of_ten (cf. the reference's N=128 "
            "calibration: 61 limbs x 70 digits)"
        )
        scale = 10 ** (max_len - dig_len)

        self.score = score
        self.threshold = threshold
        self.num_decomposed = decompose_big_decimal(num * scale, num_limbs, power_of_ten)
        self.den_decomposed = decompose_big_decimal(den * scale, num_limbs, power_of_ten)

    def check_threshold(self) -> bool:
        """threshold/native.rs:60-96 semantics, including all asserts."""
        max_score = self.num_neighbours * self.initial_score
        assert int(self.threshold) < max_score, "threshold out of range"

        max_limb = 10**self.power_of_ten
        for limb in (*self.num_decomposed, *self.den_decomposed):
            assert int(limb) < max_limb, "limb out of range"

        composed_num = compose_big_decimal(self.num_decomposed, self.power_of_ten)
        composed_den = compose_big_decimal(self.den_decomposed, self.power_of_ten)
        assert composed_num * composed_den.invert() == self.score, \
            "decomposition inconsistent with field score"

        last_num = int(self.num_decomposed[-1])
        last_den = int(self.den_decomposed[-1])
        assert last_den != 0

        comp = int(Fr(last_den) * self.threshold)
        return last_num >= comp
