"""Threshold circuit: prove "peer X's score ≥ T" against aggregated
EigenTrust public inputs.

Circuit twin of the reference's ``Threshold`` halo2 circuit
(``eigentrust-zk/src/circuits/threshold/mod.rs:284-632``) over the
native twin ``protocol_tpu_torch.models.threshold``:

- the EigenTrust snark is aggregated (mod.rs:401-431): its public
  inputs become cells of this circuit, and the KZG accumulator limbs
  are exposed as public inputs for the deferred pairing decider —
  either re-derived fully in-circuit (``aggregate=True``, the
  AggregatorChipset twin) or bound as witnesses for the native
  aggregator's output,
- target peer's score selected with set-position/select-item chips
  (mod.rs:433-445),
- decimal limbs range-checked (mod.rs:474-516; the reference uses
  252-bit LessEqual chips, here lookup-backed comparisons),
- num/den recomposed and num·den⁻¹ == score constrained
  (mod.rs:518-578),
- threshold comparison on the most-significant limbs with the result
  bit constrained to a public input (mod.rs:580-631).

Public input layout matches ``ThPublicInputs``
(``eigentrust/src/circuit.rs:153-236``):
target_address ‖ threshold ‖ th_check ‖ accumulator limbs (16).
"""

from __future__ import annotations

from fractions import Fraction

from ..models.threshold import Threshold
from ..utils.errors import EigenError
from ..utils.fields import BN254_FR_MODULUS, Fr
from .gadgets import Chips
from .plonk import ConstraintSystem

R = BN254_FR_MODULUS

DEFAULT_LOOKUP_BITS = 17


class ThresholdCircuit:
    """The Threshold4 shape's circuit (``circuits/mod.rs:146-157``)."""

    def __init__(self, num_neighbours: int = 4, num_limbs: int = 2,
                 power_of_ten: int = 72, initial_score: int = 1000,
                 lookup_bits: int = DEFAULT_LOOKUP_BITS):
        self.n = num_neighbours
        self.num_limbs = num_limbs
        self.power_of_ten = power_of_ten
        self.initial_score = initial_score
        self.lookup_bits = lookup_bits
        if 10 ** power_of_ten >= 1 << 250:
            raise EigenError("circuit_error", "decimal limb exceeds compare width")

    def build(self, et_instances: list, target_address: Fr, threshold: Fr,
              ratio: Fraction, aggregator_limbs: list,
              chips: Chips | None = None, et_cells: list | None = None):
        """Returns (chips, public_inputs).

        ``et_instances``: the EigenTrust circuit's public inputs
        (participants ‖ scores ‖ domain ‖ opinions_hash). When an
        AggregatorChipset has already assigned them, pass its cells via
        ``et_cells`` (and its accumulator cells as ``aggregator_limbs``)
        — that is the sound path (``build_aggregated``). Without
        ``et_cells`` the instances enter as FREE witnesses: nothing
        links them to the accumulator limbs, so the result is only
        meaningful for MockProver-style structural testing, never for
        proofs shown to a third party.
        """
        n = self.n
        native = Threshold(
            score=Fr(et_instances[n + self._target_index(et_instances,
                                                         target_address)]),
            ratio=ratio, threshold=threshold, num_limbs=self.num_limbs,
            power_of_ten=self.power_of_ten, num_neighbours=n,
            initial_score=self.initial_score)

        c = chips if chips is not None else Chips(
            ConstraintSystem(lookup_bits=self.lookup_bits))
        if et_cells is None:
            et_cells = [c.witness(int(v)) for v in et_instances]
        participants = et_cells[:n]
        scores = et_cells[n : 2 * n]

        target_cell = c.witness(int(target_address))
        threshold_cell = c.witness(int(threshold))

        # --- select the target's score (mod.rs:433-445) -------------------
        pos = c.set_position(target_cell, participants)
        score = c.select_item(pos, scores)

        # --- decimal limbs (mod.rs:474-516) -------------------------------
        base = 10 ** self.power_of_ten
        limb_bits = (base - 1).bit_length() + 1
        num_limbs = [c.witness(int(v)) for v in native.num_decomposed]
        den_limbs = [c.witness(int(v)) for v in native.den_decomposed]
        base_cell = c.constant(base)
        for limb in (*num_limbs, *den_limbs):
            c.range_check(limb, limb_bits)
            c.assert_equal(c.less_than(limb, base_cell, num_bits=limb_bits),
                           c.constant(1))

        # --- recompose and bind to the field score (mod.rs:518-578) -------
        composed_num = c.lincomb(
            [(pow(base, i, R), limb) for i, limb in enumerate(num_limbs)])
        composed_den = c.lincomb(
            [(pow(base, i, R), limb) for i, limb in enumerate(den_limbs)])
        # score·den == num  (den ≠ 0 enforced by the last-limb check below)
        c.assert_equal(c.mul(score, composed_den), composed_num)

        # --- threshold compare on the top limbs (mod.rs:580-631) ----------
        max_score = self.n * self.initial_score
        c.assert_equal(
            c.less_than(threshold_cell, c.constant(max_score),
                        num_bits=max_score.bit_length() + 1),
            c.constant(1))
        last_num = num_limbs[-1]
        last_den = den_limbs[-1]
        # last_den != 0 (native asserts; here via inverse existence)
        c.inverse(last_den)
        comp = c.mul(last_den, threshold_cell)
        c.range_check(comp, 252)
        th_bit = c.less_eq(comp, last_num, num_bits=252)
        if bool(c.value(th_bit)) != native.check_threshold():
            raise EigenError("circuit_error",
                             "circuit/native threshold verdict divergence")

        # --- public inputs: addr ‖ threshold ‖ bit ‖ accumulator ----------
        c.public(target_cell)
        c.public(threshold_cell)
        c.public(th_bit)
        for limb in aggregator_limbs:
            if hasattr(limb, "wire"):
                c.public(limb)
            else:
                c.public(c.witness(int(limb)))
        return c, c.cs.public_values()

    def build_aggregated(self, et_pk, et_instances: list, et_proof: bytes,
                         target_address: Fr, threshold: Fr,
                         ratio: Fraction):
        """The reference's full Threshold shape (mod.rs:284-632): the ET
        snark is verified in-circuit by the AggregatorChipset; its public
        inputs become this circuit's cells and the derived accumulator
        limbs become public inputs for the host decider."""
        from .loader_chip import AggregatorChipset

        chips = Chips(ConstraintSystem(lookup_bits=self.lookup_bits))
        et_cells = [chips.witness(int(v)) for v in et_instances]
        agg = AggregatorChipset(chips)
        limb_cells, _ = agg.aggregate([(et_pk, et_cells, et_proof)])
        return self.build(et_instances, target_address, threshold, ratio,
                          limb_cells, chips=chips, et_cells=et_cells)

    def _target_index(self, et_instances, target_address: Fr) -> int:
        for i in range(self.n):
            if int(et_instances[i]) == int(target_address):
                return i
        raise EigenError("circuit_error", "target not among participants")
