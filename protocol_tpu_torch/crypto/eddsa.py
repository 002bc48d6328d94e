"""EdDSA over BabyJubJub — the reference's alternative signature scheme.

Native twin of ``eigentrust-zk/src/eddsa/native.rs``:

- Secret key = two Fr elements derived by wide-reducing the two halves of
  a 64-byte hash of the seed (``SecretKey::from_byte_array`` :51-59). The
  reference uses BLAKE-512 (``blh`` :24-28); this framework uses
  BLAKE2b-512 (stdlib) — a deliberate, documented deviation: EdDSA is not
  on the main EigenTrust4 pipeline (SURVEY.md Z14), so key derivation is a
  framework choice, not a wire-format contract.
- pk = B8 · sk0 (``SecretKey::public`` :69-75).
- sign: r = Poseidon([0, sk1, m, 0, 0])[0]; R = B8·r;
  h = Poseidon([R.x, R.y, pk.x, pk.y, m])[0];
  s = (r + h·sk0) mod suborder  (``sign`` :173-196, integer arithmetic —
  NOT field arithmetic — reduced mod the BabyJubJub suborder).
- verify: s ≤ suborder, and B8·s == R + pk·h (``verify`` :199-218).
"""

from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass

from ..utils.fields import Fr
from .edwards import EdwardsPoint, SUBORDER
from .poseidon import Poseidon


def _derive_parts(seed: bytes) -> tuple[int, int]:
    h = hashlib.blake2b(seed, digest_size=64).digest()
    sk0 = Fr.from_uniform_bytes_le(h[:32] + b"\x00" * 32)
    sk1 = Fr.from_uniform_bytes_le(h[32:] + b"\x00" * 32)
    return int(sk0), int(sk1)


@dataclass(frozen=True)
class EddsaSecretKey:
    """(sk0, sk1): sk0 is the scalar key, sk1 seeds the nonce hash."""

    sk0: int
    sk1: int

    @classmethod
    def from_byte_array(cls, seed: bytes) -> "EddsaSecretKey":
        return cls(*_derive_parts(seed))

    @classmethod
    def random(cls) -> "EddsaSecretKey":
        return cls.from_byte_array(Fr.random().to_bytes_le())

    @classmethod
    def from_raw(cls, raw: tuple[bytes, bytes]) -> "EddsaSecretKey":
        return cls(int(Fr.from_bytes_le(raw[0])), int(Fr.from_bytes_le(raw[1])))

    def to_raw(self) -> tuple[bytes, bytes]:
        return (Fr(self.sk0).to_bytes_le(), Fr(self.sk1).to_bytes_le())

    def public(self) -> "EddsaPublicKey":
        pt = EdwardsPoint.b8().mul_scalar(self.sk0).affine()
        return EddsaPublicKey(pt)


@dataclass(frozen=True)
class EddsaPublicKey:
    point: EdwardsPoint

    @classmethod
    def from_raw(cls, raw: tuple[bytes, bytes]) -> "EddsaPublicKey":
        return cls(EdwardsPoint(int(Fr.from_bytes_le(raw[0])),
                                int(Fr.from_bytes_le(raw[1]))))

    def to_raw(self) -> tuple[bytes, bytes]:
        return (Fr(self.point.x).to_bytes_le(), Fr(self.point.y).to_bytes_le())


@dataclass(frozen=True)
class EddsaSignature:
    """(R, s); R affine, s an integer < suborder."""

    big_r: EdwardsPoint
    s: int

    @classmethod
    def default(cls) -> "EddsaSignature":
        return cls(EdwardsPoint(0, 0), 0)


def _msg_hash(big_r: EdwardsPoint, pk: EddsaPublicKey, message: Fr) -> int:
    inputs = [Fr(big_r.x), Fr(big_r.y), Fr(pk.point.x), Fr(pk.point.y), message]
    return int(Poseidon(inputs).permute()[0])


def sign(sk: EddsaSecretKey, pk: EddsaPublicKey, message: Fr) -> EddsaSignature:
    nonce_in = [Fr.zero(), Fr(sk.sk1), message, Fr.zero(), Fr.zero()]
    r = int(Poseidon(nonce_in).permute()[0])
    big_r = EdwardsPoint.b8().mul_scalar(r).affine()
    h = _msg_hash(big_r, pk, message)
    s = (r + sk.sk0 * h) % SUBORDER
    return EddsaSignature(big_r, s)


def verify(sig: EddsaSignature, pk: EddsaPublicKey, message: Fr) -> bool:
    if sig.s > SUBORDER:
        return False
    cl = EdwardsPoint.b8().mul_scalar(sig.s)
    h = _msg_hash(sig.big_r, pk, message)
    pk_h = pk.point.mul_scalar(h)
    cr = sig.big_r.projective().add(pk_h)
    return cr.affine() == cl.affine()


def random_keypair() -> tuple[EddsaSecretKey, EddsaPublicKey]:
    sk = EddsaSecretKey.from_byte_array(secrets.token_bytes(32))
    return sk, sk.public()
