"""KZG proof aggregation (native side).

Twin of the reference's ``Snark`` / ``NativeAggregator``
(``eigentrust-zk/src/verifier/aggregator/native.rs:75-187``): each snark
is succinctly verified (all algebra, no pairing), yielding a KZG
accumulator pair (lhs, rhs); the aggregator folds the accumulators of
all snarks with a transcript-derived challenge and exposes the folded
pair as 4×68-bit limb instances. One deferred pairing — the *decider* —
attests to every aggregated proof at once.

The in-circuit twin (``AggregatorChipset``, built from the loader /
transcript chip layer) re-derives the same accumulator inside the
Threshold circuit and constrains it to these instances.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.errors import EigenError
from ..utils.fields import BN254_FR_MODULUS
from .integer_chip import to_limbs
from .kzg import KZGParams, decide, g1_add, g1_mul
from .plonk import ProvingKey, succinct_verify
from .transcript import PoseidonTranscript

R = BN254_FR_MODULUS


@dataclass
class Snark:
    """One proof to aggregate (aggregator/native.rs:75-96)."""

    pk: ProvingKey
    instances: list  # public inputs
    proof: bytes


def accumulator_limbs(acc: tuple) -> list:
    """(lhs, rhs) G1 pair → 16 Fr instances: x/y of each point as
    4×68-bit limbs (the reference's accumulator limb exposure,
    aggregator/mod.rs:35-95)."""
    out = []
    for pt in acc:
        if pt is None:
            raise EigenError("proving_error", "identity accumulator")
        for coord in pt:
            out.extend(to_limbs(coord))
    return out


class NativeAggregator:
    """Succinct-verify each snark, fold accumulators, expose limbs
    (aggregator/native.rs:140-187)."""

    def __init__(self, snarks: list):
        if not snarks:
            raise EigenError("proving_error", "nothing to aggregate")
        self.snarks = list(snarks)
        accs = []
        tr = PoseidonTranscript(b"protocol-tpu-aggregator")
        for snark in self.snarks:
            acc = succinct_verify(snark.pk, snark.instances, snark.proof)
            if acc is None:
                raise EigenError("proving_error",
                                 "aggregated snark failed verification")
            accs.append(acc)
            for v in snark.instances:
                tr.absorb_fr(v)
            tr.absorb_point(acc[0])
            tr.absorb_point(acc[1])
        r = tr.challenge()
        lhs, rhs = None, None
        ri = 1
        for al, ar in accs:
            lhs = g1_add(lhs, g1_mul(al, ri))
            rhs = g1_add(rhs, g1_mul(ar, ri))
            ri = ri * r % R
        self.accumulator = (lhs, rhs)
        self.instances = accumulator_limbs(self.accumulator)

    def decide(self, params: KZGParams) -> bool:
        """The one deferred pairing over the folded accumulator."""
        return decide(params, *self.accumulator)
