"""The port's Threshold circuit against the JAX package's: the circuit
with its accumulator limbs bound as witnesses, its rejections, and the
fully aggregated circuit (the EigenTrust snark verified in-circuit by
``loader_chip.AggregatorChipset``).

The aggregated circuit is built once per package on the same inner
snark (module fixture, ~18 s each on the CPU): the port's must equal
the reference's row for row, every column, selector, copy and public
row, and its accumulator limbs must equal both packages'
``NativeAggregator``. The inner snark is a small real one whose public
inputs have the EigenTrust layout (the reference's ``et_shaped_snark``
in ``tests/test_aggregation.py``), made once by the port's prover at
k = 8 and read by the reference through its bytes.

The full byte-artifact cycle (k = 21) is ``slow``-marked, as the
reference's ``TestApiThresholdCycle`` is; the card runs it at the
default shape in ``chip_smoke.py``'s phase ``threshold``.
"""

from fractions import Fraction

import pytest

from protocol_tpu.zk.aggregator import NativeAggregator as RefAggregator
from protocol_tpu.zk.aggregator import Snark as RefSnark
from protocol_tpu.zk.kzg import KZGParams as RefParams
from protocol_tpu.zk.plonk import ProvingKey as RefProvingKey
from protocol_tpu.zk.threshold_circuit import ThresholdCircuit as RefThreshold
from protocol_tpu_torch.crypto.secp256k1 import EcdsaKeypair
from protocol_tpu_torch.models.eigentrust import (
    Attestation,
    EigenTrustSet,
    SignedAttestation,
)
from protocol_tpu_torch.utils.errors import EigenError
from protocol_tpu_torch.utils.fields import Fr
from protocol_tpu_torch.zk.aggregator import NativeAggregator, Snark
from protocol_tpu_torch.zk.api import generate_kzg_params
from protocol_tpu_torch.zk.gadgets import Chips
from protocol_tpu_torch.zk.kzg import KZGParams
from protocol_tpu_torch.zk.plonk import ConstraintSystem, keygen, prove
from protocol_tpu_torch.zk.prover_fast import natural_k
from protocol_tpu_torch.zk.threshold_circuit import ThresholdCircuit

DOMAIN = Fr(42)
CS_FIELDS = ("wires", "selectors", "copies", "public_rows", "lookup_bits")


def _native_run(seed: int, rows: dict):
    """Two peers' addresses, converged scores and ratios from a native
    EigenTrustSet run (20 iterations, initial score 1000)."""
    kps = [EcdsaKeypair(seed + i) for i in range(2)]
    addrs = [kp.public_key.to_address() for kp in kps]
    native = EigenTrustSet(2, 20, 1000, DOMAIN)
    for a in addrs:
        native.add_member(a)
    for i, row in rows.items():
        signed = []
        for j in range(2):
            if row[j]:
                att = Attestation(about=addrs[j], domain=DOMAIN,
                                  value=Fr(row[j]), message=Fr.zero())
                signed.append(SignedAttestation(
                    att, kps[i].sign(int(att.hash()))))
            else:
                signed.append(None)
        native.update_op(kps[i].public_key, signed)
    return addrs, native.converge(), native.converge_rational()


@pytest.fixture(scope="module")
def et_snark():
    """The reference's ``et_shaped_snark`` made by the port at k = 8:
    (port params, port pk, publics, proof, addrs, scores, ratios) plus
    the reference's params and pk read from the same bytes."""
    addrs, scores, ratios = _native_run(7000, {0: [None, 400],
                                               1: [600, None]})
    c = Chips(ConstraintSystem(lookup_bits=4))
    # every selector in use, so no vk commitment is the identity
    x, y = c.witness(3), c.witness(4)
    s = c.add(x, y)
    c.lincomb([(2, x), (3, y), (1, s), (1, c.mul(x, y))], const=1)
    c.mul_add(x, y, s)
    c.range_check(c.witness(9), 4)
    c.cs.add_row([0, 0, 2, 3, 0, 0], q_mul_cd=1, q_const=-6)
    for v in ([int(a) for a in addrs] + [int(v) for v in scores]
              + [int(DOMAIN), 12345]):
        c.cs.public_input(v)
    c.cs.check_satisfied()
    # the api's seeded SRS (the native fixed-base path when it is built)
    params = KZGParams.from_bytes(generate_kzg_params(8, seed=b"eta"))
    pk = keygen(params, c.cs)
    proof = prove(params, pk, c.cs)
    ref_params = RefParams.from_bytes(params.to_bytes())
    ref_pk = RefProvingKey.from_bytes(pk.to_bytes())
    return (params, pk, c.cs.public_values(), proof, addrs, scores, ratios,
            ref_params, ref_pk)


@pytest.fixture(scope="module")
def aggregated(et_snark):
    """One aggregated Threshold build per package on the same snark."""
    params, pk, pubs, proof, addrs, scores, ratios, _, ref_pk = et_snark
    args = (addrs[1], Fr(500), Fraction(ratios[1]))
    port = ThresholdCircuit(num_neighbours=2).build_aggregated(
        pk, pubs, proof, *args)
    from protocol_tpu.utils.fields import Fr as RefFr

    ref = RefThreshold(num_neighbours=2).build_aggregated(
        ref_pk, pubs, proof, RefFr(int(addrs[1])), RefFr(500),
        Fraction(ratios[1]))
    return port, ref


def test_aggregated_circuit_equals_reference(aggregated):
    (chips, pubs), (ref_chips, ref_pubs) = aggregated
    assert pubs == ref_pubs
    assert chips.cs.num_rows == ref_chips.cs.num_rows
    assert natural_k(chips.cs) == 21
    assert chips.cs.public_values() == ref_chips.cs.public_values()
    for field in CS_FIELDS:
        assert getattr(chips.cs, field) == getattr(ref_chips.cs, field), \
            field


def test_aggregated_circuit_is_satisfied_and_decides(aggregated, et_snark):
    """The circuit's accumulator is both packages' native aggregator's,
    and the deferred pairing accepts it."""
    params, pk, pubs, proof, addrs, *_, ref_params, ref_pk = et_snark
    (chips, th_pubs), _ = aggregated
    chips.cs.check_satisfied()
    assert th_pubs[0] == int(addrs[1]) and th_pubs[1] == 500
    assert th_pubs[2] in (0, 1)
    native = NativeAggregator([Snark(pk, pubs, proof)])
    ref_native = RefAggregator([RefSnark(ref_pk, pubs, proof)])
    assert th_pubs[3:19] == native.instances == ref_native.instances
    assert native.decide(params) and ref_native.decide(ref_params)


@pytest.fixture(scope="module")
def native_fixture():
    """The reference's ``native_fixture`` (test_threshold_circuit.py):
    addrs, ratios and the ET instances of a 2-peer run."""
    addrs, scores, ratios = _native_run(9000, {0: [None, 300],
                                               1: [700, None]})
    et_instances = ([int(a) for a in addrs] + [int(s) for s in scores]
                    + [int(DOMAIN), 0])
    return addrs, ratios, et_instances


def _both_builds(et_instances, addr, threshold, ratio, limbs):
    from protocol_tpu.utils.fields import Fr as RefFr

    port = ThresholdCircuit(num_neighbours=2).build(
        et_instances, addr, Fr(threshold), ratio, limbs)
    ref = RefThreshold(num_neighbours=2).build(
        et_instances, RefFr(int(addr)), RefFr(threshold), ratio, limbs)
    return port, ref


@pytest.mark.parametrize("idx,th,expect", [(1, 500, True), (1, 1700, False),
                                           (0, 500, True)])
def test_threshold_build_at_and_below(native_fixture, idx, th, expect):
    addrs, ratios, et_instances = native_fixture
    fake_acc = list(range(1, 17))
    (chips, pubs), (ref_chips, ref_pubs) = _both_builds(
        et_instances, addrs[idx], th, Fraction(ratios[idx]), fake_acc)
    chips.cs.check_satisfied()
    assert pubs == ref_pubs
    assert pubs[:3] == [int(addrs[idx]), th, 1 if expect else 0]
    assert pubs[3:19] == fake_acc
    for field in CS_FIELDS:
        assert getattr(chips.cs, field) == getattr(ref_chips.cs, field), \
            field


def test_threshold_rejects_unknown_target_and_bad_ratio(native_fixture):
    addrs, ratios, et_instances = native_fixture
    with pytest.raises(EigenError):
        ThresholdCircuit(num_neighbours=2).build(
            et_instances, Fr(123456), Fr(10), Fraction(ratios[0]),
            list(range(16)))
    with pytest.raises((AssertionError, EigenError)):
        ThresholdCircuit(num_neighbours=2).build(
            et_instances, addrs[0], Fr(10), Fraction(ratios[0]) + 1,
            list(range(16)))


@pytest.mark.slow
def test_th_cycle_on_the_host():
    """The reference's ``TestApiThresholdCycle`` on the port (k = 21, the
    tiny shape, the host prover): th pk over a dummy aggregated circuit,
    a real th proof over another witness, verify with the deferred KZG
    decider, INVALID on a flipped byte. Tens of minutes on the CPU."""
    import torch

    from protocol_tpu_torch.client.circuit_io import ThPublicInputs, ThSetup
    from protocol_tpu_torch.models.threshold import Threshold
    from protocol_tpu_torch.zk import api

    cpu = torch.device("cpu")
    tiny = api.TINY_SHAPE
    params = api.generate_kzg_params(21, seed=b"api-th-cycle")
    th_pk = api.generate_th_pk(params, shape=tiny, device=cpu)
    setup_et = api.demo_et_setup(tiny)
    index, threshold = 1, 500
    ratio = setup_et.rational_scores[index]
    th = Threshold(setup_et.pub_inputs.scores[index], ratio, Fr(threshold),
                   num_limbs=tiny.num_limbs, power_of_ten=tiny.power_of_ten,
                   num_neighbours=tiny.num_neighbours,
                   initial_score=tiny.initial_score)
    setup = ThSetup(
        ThPublicInputs(address=setup_et.pub_inputs.participants[index],
                       threshold=Fr(threshold),
                       threshold_check=th.check_threshold()),
        th.num_decomposed, th.den_decomposed,
        et_setup=setup_et, ratio=ratio)
    proof = api.generate_th_proof(params, th_pk, setup, shape=tiny,
                                  device=cpu)
    assert len(setup.pub_inputs.agg_instances) == 16
    pub_bytes = setup.pub_inputs.to_bytes()
    assert api.verify_th(params, th_pk, pub_bytes, proof, shape=tiny)
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    assert not api.verify_th(params, th_pk, pub_bytes, bytes(bad),
                             shape=tiny)
