"""Prime-field arithmetic for the native (host, exact) oracle path.

These are the scalar types the reference uses throughout its native twins
(halo2curves ``bn256::Fr`` and ``secp256k1::{Fp, Fq}``; see e.g.
``eigentrust-zk/src/circuits/dynamic_sets/native.rs`` and
``eigentrust-zk/src/ecdsa/native.rs`` in the reference tree). The device
path never touches these classes — it works on limb-decomposed integer
tensors (``protocol_tpu_torch.ops.fieldops``) or floats; these exist so the exact semantics
(field normalization via modular inverse, conservation checks, witness
values) have a fast-enough, obviously-correct host implementation.

Elements are immutable wrappers around a Python int in ``[0, MODULUS)``.
"""

from __future__ import annotations

import secrets

# BN254 (alt_bn128) scalar field r and base field q.
BN254_FR_MODULUS = (
    21888242871839275222246405745257275088548364400416034343698204186575808495617
)
BN254_FQ_MODULUS = (
    21888242871839275222246405745257275088696311157297823662689037894645226208583
)
# secp256k1 base field p and group order n.
SECP256K1_P = 2**256 - 2**32 - 977
SECP256K1_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141


class FieldElement:
    """An element of a prime field; subclasses fix ``MODULUS``."""

    __slots__ = ("v",)
    MODULUS: int = 0

    def __init__(self, v: int = 0):
        self.v = v % self.MODULUS

    # --- constructors -----------------------------------------------------
    @classmethod
    def zero(cls):
        return cls(0)

    @classmethod
    def one(cls):
        return cls(1)

    @classmethod
    def random(cls):
        return cls(secrets.randbelow(cls.MODULUS))

    @classmethod
    def from_bytes_le(cls, data: bytes) -> "FieldElement":
        """Strict little-endian decode; value must be canonical (< MODULUS)."""
        v = int.from_bytes(data, "little")
        if v >= cls.MODULUS:
            raise ValueError("non-canonical field encoding")
        return cls(v)

    @classmethod
    def from_uniform_bytes_le(cls, data: bytes) -> "FieldElement":
        """Uniform reduction of up to 64 little-endian bytes (wide reduce).

        Matches halo2's ``from_uniform_bytes`` used by the reference for
        address/message embedding (``ecdsa/native.rs`` ``to_address``,
        ``eigentrust/src/attestation.rs`` ``to_attestation_fr``).
        """
        return cls(int.from_bytes(data, "little"))

    # --- arithmetic -------------------------------------------------------
    def __add__(self, other):
        return type(self)(self.v + other.v)

    def __sub__(self, other):
        return type(self)(self.v - other.v)

    def __mul__(self, other):
        return type(self)(self.v * other.v)

    def __neg__(self):
        return type(self)(-self.v)

    def __pow__(self, e: int):
        return type(self)(pow(self.v, e, self.MODULUS))

    def invert(self) -> "FieldElement":
        """Multiplicative inverse; raises ZeroDivisionError on zero."""
        if self.v == 0:
            raise ZeroDivisionError("zero has no inverse")
        return type(self)(pow(self.v, -1, self.MODULUS))

    def invert_or_zero(self) -> "FieldElement":
        """``invert().unwrap_or(ZERO)`` as used by the reference's field
        row-normalization (``dynamic_sets/native.rs`` converge)."""
        if self.v == 0:
            return type(self)(0)
        return self.invert()

    def sqrt(self):
        """Square root (Tonelli–Shanks); returns None if non-residue."""
        p = self.MODULUS
        v = self.v
        if v == 0:
            return type(self)(0)
        if p % 4 == 3:
            r = pow(v, (p + 1) // 4, p)
            return type(self)(r) if (r * r) % p == v else None
        if pow(v, (p - 1) // 2, p) != 1:
            return None
        # Tonelli–Shanks for p ≡ 1 (mod 4)
        q, s = p - 1, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        z = 2
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        m, c, t, r = s, pow(z, q, p), pow(v, q, p), pow(v, (q + 1) // 2, p)
        while t != 1:
            i, t2 = 0, t
            while t2 != 1:
                t2 = (t2 * t2) % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, (b * b) % p
            t, r = (t * c) % p, (r * b) % p
        return type(self)(r)

    # --- predicates / conversions ----------------------------------------
    def is_zero(self) -> bool:
        return self.v == 0

    def is_odd(self) -> bool:
        return self.v & 1 == 1

    def to_bytes_le(self, length: int = 32) -> bytes:
        return self.v.to_bytes(length, "little")

    def to_bytes_be(self, length: int = 32) -> bytes:
        return self.v.to_bytes(length, "big")

    def __int__(self):
        return self.v

    def __index__(self):
        return self.v

    def __eq__(self, other):
        return type(self) is type(other) and self.v == other.v

    def __hash__(self):
        return hash((self.MODULUS, self.v))

    def __repr__(self):
        return f"{type(self).__name__}(0x{self.v:x})"


_field_cache: dict = {}


def make_field(modulus: int, name: str) -> type:
    """Create (and cache) a FieldElement subclass for ``modulus``."""
    key = (modulus, name)
    if key not in _field_cache:
        _field_cache[key] = type(name, (FieldElement,), {"MODULUS": modulus})
    return _field_cache[key]


class Fr(FieldElement):
    """BN254 scalar field — the reference's native field ``N`` everywhere."""

    MODULUS = BN254_FR_MODULUS


class SecpBase(FieldElement):
    """secp256k1 base field Fp (curve coordinates)."""

    MODULUS = SECP256K1_P


class SecpScalar(FieldElement):
    """secp256k1 scalar field Fq (ECDSA signatures)."""

    MODULUS = SECP256K1_N
