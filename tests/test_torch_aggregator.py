"""The port's native KZG aggregator and in-circuit transcript against the
JAX package's (twins of ``tests/test_threshold_circuit.py``'s
``TestNativeAggregator`` and ``tests/test_aggregation.py``'s
``TestTranscriptChip``).

Two small real snarks (k = 8) share one seeded SRS; the port proves
them and the reference reads its params, keys and proofs through their
bytes. Each package's ``NativeAggregator`` must give the same 16
accumulator limbs, both must reject a tampered proof and a forged
accumulator, and the limbs must round-trip to the accumulator's
coordinates. The transcript chip's in-circuit challenges must equal
both packages' native Poseidon transcripts and the reference's chip.
"""

import pytest

from protocol_tpu.zk import aggregator as ref_aggregator
from protocol_tpu.zk.kzg import KZGParams as RefParams
from protocol_tpu.zk.plonk import ProvingKey as RefProvingKey
from protocol_tpu_torch.utils.errors import EigenError
from protocol_tpu_torch.zk.aggregator import (
    NativeAggregator,
    Snark,
    accumulator_limbs,
)
from protocol_tpu_torch.zk.api import generate_kzg_params
from protocol_tpu_torch.zk.gadgets import Chips
from protocol_tpu_torch.zk.integer_chip import from_limbs
from protocol_tpu_torch.zk.kzg import KZGParams
from protocol_tpu_torch.zk.plonk import ConstraintSystem, keygen, prove


@pytest.fixture(scope="module")
def snarks():
    """(port params, reference params, [(port Snark, reference Snark)])
    for two multiply-add circuits (the reference's ``small_snark``) on
    one SRS."""
    blob = generate_kzg_params(8, seed=b"agg-a")
    params = KZGParams.from_bytes(blob)
    out = []
    for x, y in ((3, 4), (7, 9)):
        c = Chips(ConstraintSystem())
        c.public(c.mul_add(c.witness(x), c.witness(y), c.constant(5)))
        pk = keygen(params, c.cs)
        proof = prove(params, pk, c.cs)
        pubs = c.cs.public_values()
        ref_pk = RefProvingKey.from_bytes(pk.to_bytes())
        out.append((Snark(pk, pubs, proof),
                    ref_aggregator.Snark(ref_pk, pubs, proof)))
    return params, RefParams.from_bytes(blob), out


@pytest.mark.parametrize("count", [1, 2])
def test_aggregate_and_decide_equal_reference(snarks, count):
    params, ref_params, pairs = snarks
    agg = NativeAggregator([p for p, _ in pairs[:count]])
    ref = ref_aggregator.NativeAggregator([r for _, r in pairs[:count]])
    assert len(agg.instances) == 16
    assert agg.instances == ref.instances
    assert agg.accumulator == ref.accumulator
    assert agg.decide(params) and ref.decide(ref_params)


def test_tampered_proof_rejected_by_both(snarks):
    _, _, [(s, r), _] = snarks
    bad = bytearray(s.proof)
    bad[-1] ^= 1
    with pytest.raises(EigenError):
        NativeAggregator([Snark(s.pk, s.instances, bytes(bad))])
    with pytest.raises(ref_aggregator.EigenError):
        ref_aggregator.NativeAggregator(
            [ref_aggregator.Snark(r.pk, r.instances, bytes(bad))])


def test_forged_accumulator_fails_decide(snarks):
    params, ref_params, [(s, r), _] = snarks
    lhs, rhs = NativeAggregator([s]).accumulator
    swapped = type("A", (), {"accumulator": (rhs, lhs)})()
    assert not NativeAggregator.decide(swapped, params)
    assert not ref_aggregator.NativeAggregator.decide(swapped, ref_params)


def test_limbs_round_trip(snarks):
    _, _, [(s, r), _] = snarks
    agg = NativeAggregator([s])
    limbs = accumulator_limbs(agg.accumulator)
    assert limbs == ref_aggregator.accumulator_limbs(agg.accumulator)
    (lx, ly), (rx, ry) = agg.accumulator
    assert [from_limbs(limbs[i:i + 4]) for i in range(0, 16, 4)] == \
        [lx, ly, rx, ry]


def test_transcript_chip_challenges_equal_reference():
    """Absorb a field element and an on-curve point, squeeze twice: the
    port's chip, the reference's chip and both native transcripts agree,
    and the port's circuit is satisfied."""
    from protocol_tpu.zk import bn254 as ref_bn254
    from protocol_tpu.zk.gadgets import Chips as RefChips
    from protocol_tpu.zk.loader_chip import PlonkVerifierChip as RefVerifier
    from protocol_tpu.zk.loader_chip import TranscriptChip as RefChip
    from protocol_tpu.zk.plonk import ConstraintSystem as RefCS
    from protocol_tpu.zk.transcript import PoseidonTranscript as RefTranscript
    from protocol_tpu_torch.zk import bn254
    from protocol_tpu_torch.zk.loader_chip import (
        PlonkVerifierChip,
        TranscriptChip,
    )
    from protocol_tpu_torch.zk.transcript import PoseidonTranscript

    point = bn254.g1_mul(bn254.G1_GEN, 0xDEADBEEF)
    assert point == ref_bn254.g1_mul(ref_bn254.G1_GEN, 0xDEADBEEF)
    challenges = []
    for transcript in (PoseidonTranscript(), RefTranscript()):
        transcript.absorb_fr(42)
        transcript.absorb_point(point)
        challenges.append([int(transcript.challenge()) for _ in range(2)])
    for chips_t, verifier_t, chip_t, cs_t in (
            (Chips, PlonkVerifierChip, TranscriptChip, ConstraintSystem),
            (RefChips, RefVerifier, RefChip, RefCS)):
        chips = chips_t(cs_t(lookup_bits=17))
        verifier = verifier_t(chips)
        tr = chip_t(chips, verifier.fq)
        tr.absorb_fr(chips.witness(42))
        tr.absorb_point(verifier.ecc.assign_point(point))
        challenges.append([int(chips.value(tr.challenge()))
                           for _ in range(2)])
        chips.cs.check_satisfied()
    assert challenges[0] == challenges[1] == challenges[2] == challenges[3]
