"""Attestation codecs: raw bytes ⇄ eth types ⇄ field scalars.

Wire-format contracts preserved from the reference
(``eigentrust/src/attestation.rs``):

- raw record: about(20) ‖ domain(20) ‖ value(1) ‖ message(32) = 73 bytes
- signature: r(32,be) ‖ s(32,be) ‖ rec_id(1) = 65 bytes
- on-chain payload: signature(65) ‖ value(1) ‖ [message(32) if nonzero]
  = 66 or 98 bytes (attestation.rs to_payload / from_log)
- storage key: b"eigen_trust_" ‖ domain(20) (DOMAIN_PREFIX, build_att_key)
- scalar embedding (to_attestation_fr): about/domain bytes reversed into
  little-endian Fr; value as small int; message via 64-byte LE uniform
  reduction.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto.secp256k1 import Signature, recover_public_key, PublicKey
from ..models.eigentrust import Attestation, SignedAttestation
from ..utils.errors import EigenError
from ..utils.fields import Fr

DOMAIN_PREFIX = b"eigen_trust_"
DOMAIN_PREFIX_LEN = 12


def _require(cond: bool, kind: str, msg: str):
    if not cond:
        raise EigenError(kind, msg)


@dataclass(frozen=True)
class AttestationData:
    """Eth-level attestation: 20-byte about/domain, u8 value, 32-byte msg."""

    about: bytes = b"\x00" * 20
    domain: bytes = b"\x00" * 20
    value: int = 0
    message: bytes = b"\x00" * 32

    def __post_init__(self):
        _require(len(self.about) == 20, "conversion_error", "about must be 20 bytes")
        _require(len(self.domain) == 20, "conversion_error", "domain must be 20 bytes")
        _require(0 <= self.value < 256, "conversion_error", "value must be u8")
        _require(len(self.message) == 32, "conversion_error", "message must be 32 bytes")

    # --- raw 73-byte record (attestation.rs:316-346) ----------------------
    def to_bytes(self) -> bytes:
        return self.about + self.domain + bytes([self.value]) + self.message

    @classmethod
    def from_bytes(cls, data: bytes) -> "AttestationData":
        _require(len(data) == 73, "conversion_error",
                 "raw attestation must be 73 bytes")
        return cls(data[:20], data[20:40], data[40], data[41:])

    # --- storage key (attestation.rs build_att_key) -----------------------
    def get_key(self) -> bytes:
        return DOMAIN_PREFIX + self.domain

    # --- scalar embedding (attestation.rs to_attestation_fr) --------------
    def to_scalar(self) -> Attestation:
        about = Fr(int.from_bytes(self.about, "big"))
        domain = Fr(int.from_bytes(self.domain, "big"))
        value = Fr(self.value)
        # message: 32 LE bytes zero-extended to 64 and uniform-reduced
        message = Fr.from_uniform_bytes_le(self.message[::-1] + b"\x00" * 32)
        return Attestation(about, domain, value, message)


@dataclass(frozen=True)
class SignatureData:
    """Eth-level ECDSA signature triple."""

    r: bytes = b"\x00" * 32
    s: bytes = b"\x00" * 32
    rec_id: int = 0

    def to_bytes(self) -> bytes:
        """65-byte r ‖ s ‖ rec_id (attestation.rs SignatureRaw)."""
        return self.r + self.s + bytes([self.rec_id])

    @classmethod
    def from_bytes(cls, data: bytes) -> "SignatureData":
        _require(len(data) == 65, "conversion_error", "signature must be 65 bytes")
        return cls(data[:32], data[32:64], data[64])

    @classmethod
    def from_signature(cls, sig: Signature) -> "SignatureData":
        return cls(sig.r.to_bytes(32, "big"), sig.s.to_bytes(32, "big"), sig.rec_id)

    def to_signature(self) -> Signature:
        return Signature(
            int.from_bytes(self.r, "big"), int.from_bytes(self.s, "big"), self.rec_id
        )


@dataclass(frozen=True)
class SignedAttestationData:
    """Attestation + signature with the on-chain payload codec."""

    attestation: AttestationData = field(default_factory=AttestationData)
    signature: SignatureData = field(default_factory=SignatureData)

    def to_payload(self) -> bytes:
        """signature(65) ‖ value(1) ‖ [message(32) if nonzero]."""
        out = self.signature.to_bytes() + bytes([self.attestation.value])
        if self.attestation.message != b"\x00" * 32:
            out += self.attestation.message
        return out

    @classmethod
    def from_log(cls, about: bytes, key: bytes, val: bytes) -> "SignedAttestationData":
        """Decode an AttestationCreated log (attestation.rs from_log)."""
        _require(len(val) in (66, 98), "conversion_error",
                 "payload must be 66 or 98 bytes")
        _require(key[:DOMAIN_PREFIX_LEN] == DOMAIN_PREFIX, "parsing_error",
                 "attestation key missing domain prefix")
        signature = SignatureData.from_bytes(val[:65])
        value = val[65]
        message = val[66:] if len(val) == 98 else b"\x00" * 32
        attestation = AttestationData(
            about=about, domain=key[DOMAIN_PREFIX_LEN:], value=value, message=message
        )
        return cls(attestation, signature)

    def recover_public_key(self) -> PublicKey:
        """Recover the attester key from the signature over the Poseidon
        attestation hash (attestation.rs recover_public_key)."""
        att_scalar = self.attestation.to_scalar()
        msg_hash = int(att_scalar.hash())
        return recover_public_key(self.signature.to_signature(), msg_hash)

    def to_signed_scalar(self) -> SignedAttestation:
        return SignedAttestation(
            self.attestation.to_scalar(), self.signature.to_signature()
        )

