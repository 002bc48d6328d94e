"""secp256k1 curve arithmetic and ECDSA: keygen / sign / recover / verify.

Native host oracle mirroring the reference's wrong-field ECDSA semantics
(``eigentrust-zk/src/ecdsa/native.rs``):

- ``sign``      — low-s normalized, recovery-id parity flipped when s is
                  rotated (``sign`` at ecdsa/native.rs:405-425).
- ``recover``   — R from (r, y-parity), pk = -r⁻¹·m·G + r⁻¹·s·R
                  (``recover_public_key`` :298-331).
- ``verify``    — u1 = m·s⁻¹, u2 = r·s⁻¹, R' = u1·G + u2·PK, valid iff
                  R'.x reduced into the scalar field equals r (:382-395).
- ``to_address``— keccak256(X_be ‖ Y_be)[12:] as a BN254 Fr element
                  (:90-110).

The batched device twin lives in ``protocol_tpu_torch.ops.secp_batch``.
"""

from __future__ import annotations

import hmac
import hashlib
import secrets
from dataclasses import dataclass, field as dc_field

from ..utils.errors import EigenError
from ..utils.fields import Fr, SECP256K1_P, SECP256K1_N
from ..utils.keccak import keccak256

P = SECP256K1_P
N = SECP256K1_N
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


class AffinePoint:
    """secp256k1 affine point; (None, None) is the identity."""

    __slots__ = ("x", "y")

    def __init__(self, x=None, y=None):
        self.x = x
        self.y = y

    @classmethod
    def identity(cls):
        return cls(None, None)

    def is_identity(self) -> bool:
        return self.x is None

    def __eq__(self, other):
        return self.x == other.x and self.y == other.y

    def __hash__(self):
        return hash((self.x, self.y))

    def neg(self) -> "AffinePoint":
        if self.is_identity():
            return self
        return AffinePoint(self.x, (-self.y) % P)

    def add(self, other: "AffinePoint") -> "AffinePoint":
        if self.is_identity():
            return other
        if other.is_identity():
            return self
        if self.x == other.x:
            if (self.y + other.y) % P == 0:
                return AffinePoint.identity()
            return self.double()
        lam = (other.y - self.y) * pow(other.x - self.x, -1, P) % P
        x3 = (lam * lam - self.x - other.x) % P
        y3 = (lam * (self.x - x3) - self.y) % P
        return AffinePoint(x3, y3)

    def double(self) -> "AffinePoint":
        if self.is_identity() or self.y == 0:
            return AffinePoint.identity()
        lam = 3 * self.x * self.x * pow(2 * self.y, -1, P) % P
        x3 = (lam * lam - 2 * self.x) % P
        y3 = (lam * (self.x - x3) - self.y) % P
        return AffinePoint(x3, y3)

    def mul(self, k: int) -> "AffinePoint":
        k %= N
        result = AffinePoint.identity()
        addend = self
        while k:
            if k & 1:
                result = result.add(addend)
            addend = addend.double()
            k >>= 1
        return result

    def on_curve(self) -> bool:
        if self.is_identity():
            return True
        return (self.y * self.y - self.x**3 - 7) % P == 0

    @classmethod
    def lift_x(cls, x: int, y_odd: bool) -> "AffinePoint":
        """Decompress: find the curve point with this x and y-parity."""
        rhs = (pow(x, 3, P) + 7) % P
        y = pow(rhs, (P + 1) // 4, P)
        if (y * y) % P != rhs:
            raise ValueError("x is not on the curve")
        if (y & 1) != int(y_odd):
            y = P - y
        return cls(x, y)


SECP256K1_GENERATOR = AffinePoint(GX, GY)


@dataclass(frozen=True)
class Signature:
    """ECDSA signature (r, s, recovery-id y-parity bit)."""

    r: int
    s: int
    rec_id: int = 0

    @classmethod
    def placeholder(cls) -> "Signature":
        """r = s = 1 — the empty-attestation filler the reference uses
        (``dynamic_sets/native.rs`` ``SignedAttestation::empty``)."""
        return cls(1, 1, 0)

    def to_bytes(self) -> bytes:
        """65-byte r_be ‖ s_be ‖ rec_id wire format
        (``eigentrust/src/attestation.rs`` SignatureRaw)."""
        return self.r.to_bytes(32, "big") + self.s.to_bytes(32, "big") + bytes([self.rec_id])

    @classmethod
    def from_bytes(cls, data: bytes) -> "Signature":
        assert len(data) == 65
        return cls(
            int.from_bytes(data[:32], "big"),
            int.from_bytes(data[32:64], "big"),
            data[64],
        )


@dataclass(frozen=True)
class PublicKey:
    """secp256k1 public key with Ethereum-style address derivation."""

    point: AffinePoint = dc_field(default_factory=AffinePoint.identity)

    def is_default(self) -> bool:
        return self.point.is_identity()

    def to_address_bytes(self) -> bytes:
        """20-byte Ethereum address: keccak256(X_be ‖ Y_be)[12:]."""
        x = (self.point.x or 0).to_bytes(32, "big")
        y = (self.point.y or 0).to_bytes(32, "big")
        return keccak256(x + y)[12:]

    def to_address(self) -> Fr:
        """Address as a BN254 Fr element (big-endian 20-byte integer) —
        matches ``ecdsa/native.rs`` ``to_address``'s LE uniform embedding."""
        return Fr(int.from_bytes(self.to_address_bytes(), "big"))


def _rfc6979_k(msg_hash: int, priv: int, extra: bytes = b"") -> int:
    """Deterministic nonce (RFC 6979, HMAC-SHA256). The reference draws k
    from an external RNG; deterministic k is strictly safer and removes RNG
    plumbing from the API (callers can still pass ``k=`` explicitly)."""
    h1 = msg_hash.to_bytes(32, "big")
    x = priv.to_bytes(32, "big")
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h1 + extra, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1 + extra, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


class EcdsaKeypair:
    """Keypair with reference-parity sign / recover semantics."""

    def __init__(self, private_key: int):
        assert 0 < private_key < N
        self.private_key = private_key
        self.public_key = PublicKey(SECP256K1_GENERATOR.mul(private_key))

    @classmethod
    def generate(cls) -> "EcdsaKeypair":
        return cls(1 + secrets.randbelow(N - 1))

    def sign_inner(self, msg_hash: int, k: int | None = None) -> Signature:
        """Plain ECDSA (no low-s normalization) — ecdsa/native.rs:274-295."""
        msg_hash %= N
        if k is None:
            k = _rfc6979_k(msg_hash, self.private_key)
        r_point = SECP256K1_GENERATOR.mul(k)
        r = r_point.x % N
        assert r != 0
        s = pow(k, -1, N) * (msg_hash + r * self.private_key) % N
        assert s != 0
        return Signature(r, s, rec_id=r_point.y & 1)

    def sign(self, msg_hash: int, k: int | None = None) -> Signature:
        """Low-s normalized signature; flips the recovery parity when s is
        rotated below n/2 — exactly the reference's secp-specific ``sign``
        (ecdsa/native.rs:405-425, border = (n-1)/2)."""
        sig = self.sign_inner(msg_hash, k)
        border = (N - 1) * pow(2, -1, N) % N
        is_high = sig.s >= border
        if is_high:
            return Signature(sig.r, N - sig.s, sig.rec_id ^ 1)
        return sig


def recover_public_key(sig: Signature, msg_hash: int) -> PublicKey:
    """Recover the signer: pk = r⁻¹·(s·R − m·G) with R decompressed from
    (r, rec_id). Verifies the result (sanity check as the reference does)."""
    r_point = AffinePoint.lift_x(sig.r, bool(sig.rec_id))
    r_inv = pow(sig.r, -1, N)
    u1 = (-(r_inv * msg_hash)) % N
    u2 = r_inv * sig.s % N
    pk_point = SECP256K1_GENERATOR.mul(u1).add(r_point.mul(u2))
    pk = PublicKey(pk_point)
    assert EcdsaVerifier(sig, msg_hash, pk).verify(), "recovered key fails verify"
    return pk


class EcdsaVerifier:
    """Signature verification mirroring ecdsa/native.rs:382-395: the final
    check reduces R'.x (a base-field value) into the scalar field and
    compares with r."""

    def __init__(self, signature: Signature, msg_hash: int, public_key: PublicKey):
        self.signature = signature
        self.msg_hash = msg_hash % N
        self.public_key = public_key

    def verify(self) -> bool:
        sig = self.signature
        if sig.s == 0 or sig.r == 0 or self.public_key.is_default():
            return False
        s_inv = pow(sig.s, -1, N)
        u1 = self.msg_hash * s_inv % N
        u2 = sig.r * s_inv % N
        r_point = SECP256K1_GENERATOR.mul(u1).add(self.public_key.point.mul(u2))
        if r_point.is_identity():
            return False
        return r_point.x % N == sig.r


# --- GLV endomorphism -------------------------------------------------------
# secp256k1 has CM discriminant −3: β³ ≡ 1 (mod p) gives the curve
# endomorphism φ(x, y) = (β·x, y) acting as scalar multiplication by λ
# (λ³ ≡ 1 mod n). Splitting a 256-bit scalar into two ~128-bit halves
# against the lattice {(a, b) : a + b·λ ≡ 0 (mod n)} halves the
# doubling chain of a scalar-mul — the circuit-row lever behind the
# EcdsaChip's shared-doubling verify (zk/ecdsa_chip.py). The constants
# are the standard public secp256k1 GLV parameters (e.g. libsecp256k1's
# endomorphism module); everything is re-verified below at import.

GLV_LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
GLV_BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE
# shortest-vector lattice basis (a1, b1), (a2, b2): a_i + b_i·λ ≡ 0 (mod n)
_GLV_A1 = 0x3086D221A7D46BCDE86C90E49284EB15
_GLV_B1 = -0xE4437ED6010E88286F547FA90ABFE4C3
_GLV_A2 = 0x114CA50F7A8E2F3F657C1108D9D44CFD8
_GLV_B2 = _GLV_A1

assert (GLV_LAMBDA * GLV_LAMBDA + GLV_LAMBDA + 1) % N == 0
assert (GLV_BETA * GLV_BETA + GLV_BETA + 1) % P == 0
assert (_GLV_A1 + _GLV_B1 * GLV_LAMBDA) % N == 0
assert (_GLV_A2 + _GLV_B2 * GLV_LAMBDA) % N == 0

# |s_i| provable bound: max |c_i| rounding error 1/2 each against basis
# vectors of ≤ 2^128.06 norm → |s_i| < 2^129. The circuit allots 33
# 4-bit windows (2^132), comfortably above.
GLV_HALF_BITS = 129


def glv_decompose(u: int) -> tuple:
    """u (mod n) → (s1, e1, s2, e2) with u ≡ e1·s1 + λ·e2·s2 (mod n),
    s_i = |component| < 2^129, e_i ∈ {+1, −1} (Babai rounding against
    the reduced lattice basis)."""
    u %= N
    c1 = (_GLV_B2 * u + N // 2) // N
    c2 = (-_GLV_B1 * u + N // 2) // N
    k1 = u - c1 * _GLV_A1 - c2 * _GLV_A2
    k2 = -c1 * _GLV_B1 - c2 * _GLV_B2
    s1, e1 = (k1, 1) if k1 >= 0 else (-k1, -1)
    s2, e2 = (k2, 1) if k2 >= 0 else (-k2, -1)
    # EigenError (not assert): under python -O an oversized half-scalar
    # would otherwise be truncated by _assign_half_scalar and surface
    # much later as an unsatisfiable congruence with no root cause
    if s1 >= 1 << GLV_HALF_BITS or s2 >= 1 << GLV_HALF_BITS:
        raise EigenError("proving_error",
                         f"GLV half-scalar exceeds 2^{GLV_HALF_BITS}")
    if (e1 * s1 + GLV_LAMBDA * e2 * s2 - u) % N != 0:
        raise EigenError("proving_error",
                         "GLV decomposition congruence failed")
    return s1, e1, s2, e2
