"""EigenTrust dynamic peer set — the native (exact) semantics.

This is the framework's correctness oracle, mirroring the reference's
``EigenTrustSet`` native twin (``eigentrust-zk/src/circuits/dynamic_sets/
native.rs``) and ``Opinion`` validation (``circuits/opinion/native.rs``):

- a fixed-capacity slot array of (address, score) pairs where the zero
  address marks an empty slot (native.rs:165-198),
- per-peer opinion ingestion with ECDSA + Poseidon validation
  (opinion/native.rs:63-109),
- filtering: null self-scores and scores about non-members; empty rows are
  redistributed uniformly to all *other* valid members (native.rs:234-283),
- ``converge``: 20-iteration power iteration s ← Cᵀs in the BN254 scalar
  field with modular-inverse row normalization and the score-conservation
  assert (native.rs:286-337),
- ``converge_rational``: the exact rational twin (native.rs:340-392).

Unlike the reference, hyperparameters (set size, iterations, initial score)
are runtime values, not const generics — circuit shape staticness is
enforced at the zk layer instead. The scale path (sparse graphs, millions
of peers) lives in ``protocol_tpu_torch.graph`` /
``protocol_tpu_torch.ops``; this class is the small-set
exact-semantics anchor, and its ``converge`` accepts a pluggable backend
(the ``ConvergeBackend`` seam SURVEY.md §7 mandates).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from ..utils.fields import Fr
from ..crypto.poseidon import Poseidon, PoseidonSponge
from ..crypto.secp256k1 import EcdsaVerifier, PublicKey, Signature

# Poseidon width used for attestation hashes and the opinion sponge
# (reference: eigentrust-zk/src/circuits/mod.rs HASHER_WIDTH = 5).
HASHER_WIDTH = 5


@dataclass(frozen=True)
class Attestation:
    """One rating: (about, domain, value, message), all BN254 Fr.

    Reference: dynamic_sets/native.rs:77-105.
    """

    about: Fr
    domain: Fr
    value: Fr
    message: Fr

    def hash(self) -> Fr:
        """Poseidon_5(about, domain, value, message, 0) lane 0."""
        inputs = [self.about, self.domain, self.value, self.message, Fr.zero()]
        return Poseidon(inputs, HASHER_WIDTH).finalize()[0]


@dataclass(frozen=True)
class SignedAttestation:
    """Attestation + ECDSA signature (dynamic_sets/native.rs:15-75)."""

    attestation: Attestation
    signature: Signature

    @classmethod
    def empty(cls, domain: Fr, about: Fr | None = None) -> "SignedAttestation":
        """Filler for missing opinions: zero attestation with r = s = 1."""
        att = Attestation(about or Fr.zero(), domain, Fr.zero(), Fr.zero())
        return cls(att, Signature.placeholder())


class Opinion:
    """One peer's validated opinion row (opinion/native.rs:14-110)."""

    def __init__(self, from_pk: PublicKey, attestations: Sequence[SignedAttestation],
                 domain: Fr):
        self.from_pk = from_pk
        self.attestations = list(attestations)
        self.domain = domain

    def validate(self, set_addresses: Sequence[Fr]):
        """Returns (signer address, validated score row, opinion hash).

        Per entry i: recompute the Poseidon attestation hash, verify the
        ECDSA signature against it, and null the (score, hash) pair when the
        signature is invalid, the slot address is the zero address, or the
        signer key is the default key (opinion/native.rs:92-101). The
        opinion hash is the sponge over all per-entry hashes.
        """
        assert len(self.attestations) == len(set_addresses), \
            "opinion row width must equal the set capacity"
        addr = self.from_pk.to_address()
        assert any(a == addr for a in set_addresses), "signer not in the set"
        is_default_pk = self.from_pk.is_default()

        scores: list = []
        hashes: list = []
        for i, signed in enumerate(self.attestations):
            att = signed.attestation
            assert att.about == set_addresses[i], "attestation about/slot mismatch"
            assert att.domain == self.domain, "attestation domain mismatch"

            att_hash = att.hash()
            is_valid = EcdsaVerifier(
                signed.signature, int(att_hash), self.from_pk
            ).verify()

            is_default_addr = set_addresses[i].is_zero()
            if (not is_valid) or is_default_addr or is_default_pk:
                scores.append(Fr.zero())
                hashes.append(Fr.zero())
            else:
                scores.append(att.value)
                hashes.append(att_hash)

        sponge = PoseidonSponge(HASHER_WIDTH)
        sponge.update(hashes)
        op_hash = sponge.squeeze()
        return addr, scores, op_hash


class EigenTrustSet:
    """Fixed-capacity dynamic peer set with EigenTrust convergence."""

    def __init__(self, num_neighbours: int, num_iterations: int,
                 initial_score: int, domain: Fr):
        self.num_neighbours = num_neighbours
        self.num_iterations = num_iterations
        self.initial_score = initial_score
        self.domain = domain
        # slot array of (address, score); zero address = empty slot
        self.set: list = [(Fr.zero(), Fr.zero()) for _ in range(num_neighbours)]
        self.ops: dict = {}  # address -> validated score row (list[Fr])

    # --- membership (native.rs:175-198) ----------------------------------
    def add_member(self, addr: Fr) -> None:
        assert not any(a == addr for a, _ in self.set), "already a member"
        index = next(i for i, (a, _) in enumerate(self.set) if a.is_zero())
        self.set[index] = (addr, Fr(self.initial_score))

    def remove_member(self, addr: Fr) -> None:
        index = next(i for i, (a, _) in enumerate(self.set) if a == addr)
        self.set[index] = (Fr.zero(), Fr.zero())
        self.ops.pop(addr, None)

    # --- opinion ingestion (native.rs:201-231) ----------------------------
    def update_op(self, from_pk: PublicKey,
                  op: Sequence[Optional[SignedAttestation]]) -> Fr:
        """Validate and store one peer's opinion row; returns the opinion
        hash. Missing entries are filled with empty attestations about the
        corresponding slot address."""
        assert len(op) == self.num_neighbours, \
            "opinion row width must equal the set capacity"
        set_addresses = [a for a, _ in self.set]
        group = [
            att if att is not None
            else SignedAttestation.empty(self.domain, about=set_addresses[i])
            for i, att in enumerate(op)
        ]
        opinion = Opinion(from_pk, group, self.domain)
        addr, scores, op_hash = opinion.validate(set_addresses)
        self.ops[addr] = scores
        return op_hash

    # --- filtering (native.rs:234-283) ------------------------------------
    def filter_peers_ops(self) -> dict:
        """Null self-scores and scores about empty slots; redistribute empty
        rows uniformly (score 1) to every other valid member."""
        filtered: dict = {}
        n = self.num_neighbours
        for i in range(n):
            addr_i, _ = self.set[i]
            if addr_i.is_zero():
                continue
            ops_i = list(self.ops.get(addr_i, [Fr.zero()] * n))

            for j in range(n):
                addr_j, _ = self.set[j]
                if addr_j.is_zero() or addr_j == addr_i:
                    ops_i[j] = Fr.zero()

            if all(s.is_zero() for s in ops_i):
                for j in range(n):
                    addr_j, _ = self.set[j]
                    if (not addr_j.is_zero()) and addr_j != addr_i:
                        ops_i[j] = Fr.one()

            filtered[addr_i] = ops_i
        return filtered

    def opinion_matrix(self):
        """Filtered opinion rows in slot order (zero rows for empty slots).

        This is the hand-off point to ``ConvergeBackend`` implementations:
        the full matrix as plain ints, plus the slot validity mask.
        """
        filtered = self.filter_peers_ops()
        matrix = []
        valid = []
        for addr, _ in self.set:
            if addr.is_zero():
                matrix.append([0] * self.num_neighbours)
                valid.append(False)
            else:
                matrix.append([int(s) for s in filtered[addr]])
                valid.append(True)
        return matrix, valid

    # --- convergence (native.rs:286-392) ----------------------------------
    def converge(self) -> list:
        """Field-exact power iteration with conservation assert."""
        valid_peers = sum(1 for a, _ in self.set if not a.is_zero())
        assert valid_peers >= 2, "Insufficient peers for calculation!"

        matrix, _ = self.opinion_matrix()
        n = self.num_neighbours

        # Row-normalize in the field: row * (sum row)^-1, inverse-or-zero.
        ops_norm = []
        for i in range(n):
            row = [Fr(v) for v in matrix[i]]
            inv_sum = sum(row, Fr.zero()).invert_or_zero()
            ops_norm.append([v * inv_sum for v in row])

        s = [score for _, score in self.set]
        for _ in range(self.num_iterations):
            s = [
                sum((ops_norm[j][i] * s[j] for j in range(n)), Fr.zero())
                for i in range(n)
            ]

        sum_initial = sum((score for _, score in self.set), Fr.zero())
        sum_final = sum(s, Fr.zero())
        assert sum_initial == sum_final, "score conservation violated"
        return s

    def converge_float(self, backend=None):
        """Real-valued convergence through the ConvergeBackend seam.

        ``backend=None`` uses the exact rational oracle; pass a
        ``protocol_tpu_torch.backend`` instance (e.g. TorchDenseBackend) to
        run the same filtered matrix on the card.
        """
        valid_peers = sum(1 for a, _ in self.set if not a.is_zero())
        assert valid_peers >= 2, "Insufficient peers for calculation!"
        if backend is None:
            from ..backend import NativeRationalBackend

            backend = NativeRationalBackend()
        matrix, _ = self.opinion_matrix()
        return backend.converge(matrix, self.initial_score, self.num_iterations)

    def converge_rational(self) -> list:
        """Exact rational twin; empty-row denominators become 1
        (native.rs:366-377). Delegates to the NativeRationalBackend oracle
        so the rational algorithm lives in exactly one place."""
        from ..backend import NativeRationalBackend

        matrix, _ = self.opinion_matrix()
        return NativeRationalBackend().converge_exact(
            matrix, self.initial_score, self.num_iterations
        )
