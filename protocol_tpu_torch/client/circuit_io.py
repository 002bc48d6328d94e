"""Circuit IO types: scores and public-input bundles with byte codecs.

Mirrors ``eigentrust/src/circuit.rs``: ``Score`` (address + three score
encodings), ``ETSetup``/``ETPublicInputs`` (layout: participants ‖ scores
‖ domain ‖ opinion_hash, 32-byte LE field encodings), ``ThSetup``/
``ThPublicInputs``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction

from ..utils.errors import EigenError
from ..utils.fields import Fr


@dataclass
class Score:
    """One peer's score in all encodings (circuit.rs:47-56)."""

    address: bytes  # 20 bytes
    score_fr: bytes  # 32 bytes, big-endian (reference reverses LE repr)
    numerator: int
    denominator: int

    @property
    def score_int(self) -> int:
        return self.numerator // self.denominator

    @property
    def ratio(self) -> Fraction:
        return Fraction(self.numerator, self.denominator)


@dataclass
class ETPublicInputs:
    """EigenTrust circuit public inputs (circuit.rs:84-151)."""

    participants: list  # [Fr] length num_neighbours
    scores: list  # [Fr]
    domain: Fr
    opinion_hash: Fr

    def to_flat(self) -> list:
        return [*self.participants, *self.scores, self.domain, self.opinion_hash]

    def to_bytes(self) -> bytes:
        return b"".join(x.to_bytes_le() for x in self.to_flat())

    @classmethod
    def from_bytes(cls, data: bytes, num_neighbours: int) -> "ETPublicInputs":
        expected = (2 * num_neighbours + 2) * 32
        if len(data) != expected:
            raise EigenError(
                "parsing_error", f"expected {expected} bytes, got {len(data)}"
            )
        vals = [Fr.from_bytes_le(data[i : i + 32]) for i in range(0, len(data), 32)]
        return cls(
            participants=vals[:num_neighbours],
            scores=vals[num_neighbours : 2 * num_neighbours],
            domain=vals[2 * num_neighbours],
            opinion_hash=vals[2 * num_neighbours + 1],
        )


@dataclass
class ETSetup:
    """Everything et_circuit_setup produces (circuit.rs ETSetup)."""

    address_set: list  # [bytes20]
    attestation_matrix: list  # [[SignedAttestation | None]]
    pub_keys: list  # [PublicKey | None]
    pub_inputs: ETPublicInputs
    rational_scores: list  # [Fraction]
    # (matrix, valid): filtered opinion rows as plain ints + slot mask —
    # the hand-off to ConvergeBackend, computed once during setup.
    opinion: tuple = None


@dataclass
class ThPublicInputs:
    """Threshold circuit public inputs (circuit.rs:153-236):
    address ‖ threshold ‖ th_check-bit ‖ aggregator instances."""

    address: Fr
    threshold: Fr
    threshold_check: bool
    agg_instances: list = field(default_factory=list)

    def to_flat(self) -> list:
        return [
            self.address,
            self.threshold,
            Fr(1 if self.threshold_check else 0),
            *self.agg_instances,
        ]

    def to_bytes(self) -> bytes:
        return b"".join(x.to_bytes_le() for x in self.to_flat())

    @classmethod
    def from_bytes(cls, data: bytes) -> "ThPublicInputs":
        if len(data) % 32 != 0 or len(data) < 96:
            raise EigenError("parsing_error", "bad threshold public-input bytes")
        vals = [Fr.from_bytes_le(data[i : i + 32]) for i in range(0, len(data), 32)]
        return cls(
            address=vals[0],
            threshold=vals[1],
            threshold_check=not vals[2].is_zero(),
            agg_instances=vals[3:],
        )


@dataclass
class ThSetup:
    """Threshold circuit setup bundle. ``et_setup``/``ratio`` carry the
    EigenTrust context the prover needs to re-prove and aggregate the
    inner snark (the reference's th_circuit_setup holds the same data
    live while it builds the Snark, lib.rs:469-534)."""

    pub_inputs: ThPublicInputs
    num_decomposed: list  # [Fr] decimal limbs
    den_decomposed: list  # [Fr]
    et_setup: "ETSetup" = None
    ratio: Fraction = None
