"""The Client facade — the SDK's main entry point.

Mirrors the reference ``Client`` (``eigentrust/src/lib.rs:110-674``):
signer setup from a mnemonic, attest, fetch/decode logs, circuit setup
(participant ordering, pubkey recovery, attestation matrix, native
convergence, opinion sponge hash), score calculation, threshold
verification, and proof-generation hooks into the zk layer.

Differences by design:
- the chain is injected (LocalChain simulation or RpcChain), not hardwired
  to an HTTP provider;
- the set size / iteration count are runtime config, not const generics;
- the scale path (`calculate_scores_sparse`) hands raw edge arrays to a
  torch ConvergeBackend instead of building Python object matrices.

The port of ``protocol_tpu/client/client.py``. Its three device seams go
to the port: the batched-ingest auto mode asks
``torch.cuda.is_available()`` and runs ``client.ingest`` on the card
(the field kernels), and ``calculate_scores_sparse`` defaults to
``TorchSparseBackend``. ``Client(device=...)`` is handed to both; the
default ``None`` means the card, as everywhere in the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from ..models.eigentrust import EigenTrustSet
from ..utils import trace
from ..models.threshold import Threshold
from ..crypto.poseidon import PoseidonSponge
from ..utils.errors import EigenError
from ..utils.fields import Fr
from .attestation import AttestationData, SignatureData, SignedAttestationData
from .chain import AttestationStation, LocalChain
from .circuit_io import ETPublicInputs, ETSetup, Score, ThPublicInputs, ThSetup
from .eth import address_from_public_key, ecdsa_keypairs_from_mnemonic

# Reference instantiation constants (eigentrust-zk/src/circuits/mod.rs:38-59)
DEFAULT_NUM_NEIGHBOURS = 4
DEFAULT_NUM_ITERATIONS = 20
DEFAULT_INITIAL_SCORE = 1000
MIN_PEER_COUNT = 2
DEFAULT_NUM_DECIMAL_LIMBS = 2
DEFAULT_POWER_OF_TEN = 72


def _device_present() -> bool:
    """True when a CUDA card is live (batched-ingest auto mode). The
    scalar path needs no device at all."""
    import torch

    return torch.cuda.is_available()


@dataclass
class ClientConfig:
    """CliConfig twin (eigentrust-cli/src/cli.rs:27-43)."""

    as_address: str = "0x" + "00" * 20
    band_id: str = ""
    band_th: str = "500"
    band_url: str = ""
    chain_id: int = 31337
    domain: str = "0x" + "00" * 20
    node_url: str = "memory"

    @classmethod
    def from_dict(cls, d: dict) -> "ClientConfig":
        known = {f: d[f] for f in cls.__dataclass_fields__ if f in d}
        cfg = cls(**known)
        cfg.chain_id = int(cfg.chain_id)
        return cfg

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}


class Client:
    """SDK facade over chain + trust model + zk layer."""

    def __init__(
        self,
        config: ClientConfig,
        mnemonic: str,
        chain: Optional[AttestationStation] = None,
        num_neighbours: int = DEFAULT_NUM_NEIGHBOURS,
        num_iterations: int = DEFAULT_NUM_ITERATIONS,
        initial_score: int = DEFAULT_INITIAL_SCORE,
        batched_ingest: bool | None = None,
        device=None,
    ):
        self.config = config
        self.mnemonic = mnemonic
        self.keypairs = ecdsa_keypairs_from_mnemonic(mnemonic, 1)
        self.num_neighbours = num_neighbours
        self.num_iterations = num_iterations
        self.initial_score = initial_score
        # True routes signer recovery through the batched device path
        # (client.ingest) — worth it for large ingest batches; the host
        # scalar loop stays default for small sets
        # None = auto: batch on the card (the per-attestation scalar
        # path is the reference's ingest hot spot,
        # ecdsa/native.rs:298-331), from 32 attestations up; on a host
        # with no CUDA card the scalar path stays default
        self.batched_ingest = batched_ingest
        # the device of the batched ingest and the sparse scale path:
        # None means the card (and raises without one)
        self.device = device
        if chain is not None:
            self.chain = chain
        elif config.node_url == "memory":
            self.chain = LocalChain()
        else:
            from .chain import RpcChain

            self.chain = RpcChain(
                config.node_url,
                bytes.fromhex(config.as_address.removeprefix("0x")),
                int(config.chain_id),
            )

    # --- helpers ----------------------------------------------------------
    @property
    def signer(self):
        return self.keypairs[0]

    def get_scalar_domain(self) -> Fr:
        raw = self._domain_bytes()
        return Fr.from_bytes_le(raw[::-1] + b"\x00" * 12)

    def _domain_bytes(self) -> bytes:
        try:
            raw = bytes.fromhex(self.config.domain.removeprefix("0x"))
        except ValueError as e:
            raise EigenError("config_error", "domain is not valid hex") from e
        if len(raw) != 20:
            raise EigenError("config_error", "domain must be 20 bytes of hex")
        return raw

    # --- write path (lib.rs attest :152-198) ------------------------------
    def attest(self, about: bytes, value: int, message: bytes = b"\x00" * 32) -> str:
        """Sign an attestation about `about` and submit it on-chain."""
        att = AttestationData(
            about=about, domain=self._domain_bytes(), value=value, message=message
        )
        att_fr = att.to_scalar()
        sig = self.signer.sign(int(att_fr.hash()))
        signed = SignedAttestationData(att, SignatureData.from_signature(sig))

        # sanity: recover must give back our own address (lib.rs:176-178)
        recovered = signed.recover_public_key()
        attestor = address_from_public_key(recovered)
        own = address_from_public_key(self.signer.public_key)
        if attestor != own:
            raise EigenError("attestation_error", "self-recovery mismatch")

        about_addr = att.about
        key = att.get_key()
        payload = signed.to_payload()
        if hasattr(self.chain, "attest_signed"):
            return self.chain.attest_signed(self.signer, [(about_addr, key, payload)])
        return self.chain.attest(attestor, [(about_addr, key, payload)])

    # --- read path (lib.rs get_logs/get_attestations :607-645) ------------
    def get_attestations(self, from_block: int = 0) -> list:
        """Fetch and decode this domain's attestations only — the reference
        filters logs by topic3 == build_att_key(domain) (lib.rs:633-645);
        foreign-domain attestations must never reach the opinion layer."""
        from .attestation import DOMAIN_PREFIX

        expected_key = DOMAIN_PREFIX + self._domain_bytes()
        logs = self.chain.get_logs(from_block)
        return [
            SignedAttestationData.from_log(log.about, log.key, log.val)
            for log in logs
            if log.key == expected_key
        ]

    # --- circuit setup (lib.rs et_circuit_setup :339-466) -----------------
    def et_circuit_setup(self, attestations: Sequence[SignedAttestationData]) -> ETSetup:
        n = self.num_neighbours

        # Defense in depth: scoring must only ever see this client's domain
        # regardless of where the attestation list came from (fetch filters
        # too, but CSV files / direct callers bypass that layer).
        domain_bytes = self._domain_bytes()
        attestations = [
            s for s in attestations if s.attestation.domain == domain_bytes
        ]

        # participant set: BTreeSet ordering = sorted unique addresses.
        # Recover each pubkey exactly once (EC scalar mults dominate setup).
        pub_key_map: dict = {}
        origins: list = []
        participants: set = set()
        use_batched = self.batched_ingest
        if use_batched is None:
            use_batched = len(attestations) >= 32 and _device_present()
        if use_batched and attestations:
            from .ingest import recover_signers_batch

            pks, addr_list, valid = recover_signers_batch(
                attestations, device=self.device)
            if not valid.all():
                bad = int((~valid).argmax())
                raise EigenError("validation_error",
                                 f"attestation {bad} failed batched recovery")
            recovered = list(zip(pks, addr_list))
        else:
            with trace.span("ingest.recover_scalar", n=len(attestations)):
                recovered = [
                    (pk := signed.recover_public_key(),
                     address_from_public_key(pk))
                    for signed in attestations
                ]
        for signed, (pk, origin) in zip(attestations, recovered):
            origins.append(origin)
            pub_key_map[origin] = pk
            participants.add(origin)
            participants.add(signed.attestation.about)
        address_set = sorted(participants)

        if len(address_set) > n:
            raise EigenError(
                "validation_error",
                f"{len(address_set)} participants exceed the set capacity {n}",
            )
        if len(address_set) < MIN_PEER_COUNT:
            raise EigenError(
                "validation_error",
                f"at least {MIN_PEER_COUNT} participants required",
            )

        from .eth import scalar_from_address

        scalar_set = [scalar_from_address(a) for a in address_set]
        scalar_set += [Fr.zero()] * (n - len(scalar_set))
        pub_keys = [
            pub_key_map.get(address_set[i]) if i < len(address_set) else None
            for i in range(n)
        ]

        # attestation matrix in participant order
        matrix: list = [[None] * n for _ in range(n)]
        for signed, origin in zip(attestations, origins):
            i = address_set.index(origin)
            j = address_set.index(signed.attestation.about)
            matrix[i][j] = signed.to_signed_scalar()

        # native set: add members, submit opinions, converge both ways
        domain = self.get_scalar_domain()
        et = EigenTrustSet(n, self.num_iterations, self.initial_score, domain)
        for s in scalar_set[: len(address_set)]:
            et.add_member(s)

        op_hashes = []
        for i, addr in enumerate(address_set):
            pk = pub_key_map.get(addr)
            if pk is not None:
                op_hashes.append(et.update_op(pk, matrix[i]))

        opinion = et.opinion_matrix()
        with trace.span("converge.rational", n=len(address_set)):
            rational_scores = et.converge_rational()
        with trace.span("converge.field", n=len(address_set)):
            field_scores = et.converge()

        sponge = PoseidonSponge()
        sponge.update(op_hashes)
        opinions_hash = sponge.squeeze()

        pub_inputs = ETPublicInputs(scalar_set, field_scores, domain, opinions_hash)
        return ETSetup(
            address_set, matrix, pub_keys, pub_inputs, rational_scores, opinion
        )

    # --- scores (lib.rs calculate_scores :201-236) ------------------------
    def calculate_scores(self, attestations: Sequence[SignedAttestationData]) -> list:
        return self.scores_from_setup(self.et_circuit_setup(attestations))

    def scores_from_setup(self, setup: ETSetup) -> list:
        scores = []
        for addr, score_fr, ratio in zip(
            setup.address_set, setup.pub_inputs.scores, setup.rational_scores
        ):
            scores.append(
                Score(
                    address=addr,
                    score_fr=score_fr.to_bytes_be(),
                    numerator=ratio.numerator,
                    denominator=ratio.denominator,
                )
            )
        return scores

    def calculate_scores_sparse(
        self, n, src, dst, val, valid=None, backend=None, tol=None, alpha=0.0
    ):
        """Scale path: converge raw edge arrays through a ConvergeBackend
        (default: ``TorchSparseBackend`` on the client's device)."""
        if backend is None:
            from ..backend import TorchSparseBackend

            backend = TorchSparseBackend(device=self.device)
        import numpy as np

        if valid is None:
            valid = np.ones(n, dtype=bool)
        return backend.converge_edges(
            n, src, dst, val, valid, self.initial_score, self.num_iterations,
            tol=tol, alpha=alpha,
        )

    # --- threshold (lib.rs th_circuit_setup :469-534, verify_threshold) ---
    def th_circuit_setup(
        self,
        attestations: Sequence[SignedAttestationData],
        participant: bytes,
        threshold: int,
        num_limbs: int = DEFAULT_NUM_DECIMAL_LIMBS,
        power_of_ten: int = DEFAULT_POWER_OF_TEN,
    ) -> ThSetup:
        setup = self.et_circuit_setup(attestations)
        try:
            index = setup.address_set.index(participant)
        except ValueError as e:
            raise EigenError(
                "validation_error", "participant not in the attestation set"
            ) from e

        score_fr = setup.pub_inputs.scores[index]
        ratio = setup.rational_scores[index]
        th = Threshold(
            score_fr,
            ratio,
            Fr(threshold),
            num_limbs=num_limbs,
            power_of_ten=power_of_ten,
            num_neighbours=self.num_neighbours,
            initial_score=self.initial_score,
        )
        check = th.check_threshold()

        from .eth import scalar_from_address

        pub_inputs = ThPublicInputs(
            address=scalar_from_address(participant),
            threshold=Fr(threshold),
            threshold_check=check,
        )
        return ThSetup(pub_inputs, th.num_decomposed, th.den_decomposed,
                       et_setup=setup, ratio=ratio)

    def verify_threshold(
        self, attestations, participant: bytes, threshold: int
    ) -> bool:
        return self.th_circuit_setup(
            attestations, participant, threshold
        ).pub_inputs.threshold_check
