"""Twisted-Edwards curve arithmetic over BN254 Fr (BabyJubJub).

Native twin of the reference's edwards layer
(``eigentrust-zk/src/edwards/{native,params}.rs``): projective
add/double via the bbjlp-2008 formulas, double-and-add scalar
multiplication over the little-endian bits of an Fr scalar, and the
BabyJubJub parameter set (a = 168700, d = 168696, base point B8,
generator G, suborder l; ``edwards/params.rs:42-80``).

BabyJubJub's base field is BN254's *scalar* field Fr, which is why
points here live in circuit-friendly coordinates — every coordinate is
already a native witness value for the zk layer.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.fields import Fr

P = Fr.MODULUS

# BabyJubJub parameters (edwards/params.rs:42-80, limbs decoded).
A = 168700
D = 168696
B8 = (
    5299619240641551281634865583518297030282874472190772894086521144482721001553,
    16950150798460657717958625567821834550301663161624707787222815936182638968203,
)
GENERATOR = (
    995203441582195749578291179787384436505546430278305826713579947235728471134,
    5472060717959818805561601436314318772137091100104008585924551046643952123905,
)
# Order of the prime-order subgroup containing B8 (= curve order / 8).
SUBORDER = 2736030358979909402780800718157159386076813972158567259200215660948447373041
SUBORDER_SIZE = 252


@dataclass(frozen=True)
class EdwardsPoint:
    """Affine BabyJubJub point; coordinates are raw ints mod Fr.MODULUS."""

    x: int
    y: int

    @classmethod
    def identity(cls) -> "EdwardsPoint":
        return cls(0, 1)

    @classmethod
    def b8(cls) -> "EdwardsPoint":
        return cls(*B8)

    @classmethod
    def generator(cls) -> "EdwardsPoint":
        return cls(*GENERATOR)

    def is_on_curve(self) -> bool:
        x2 = self.x * self.x % P
        y2 = self.y * self.y % P
        return (A * x2 + y2) % P == (1 + D * x2 % P * y2) % P

    def projective(self) -> "ProjectivePoint":
        return ProjectivePoint(self.x, self.y, 1)

    def mul_scalar(self, scalar: int) -> "ProjectivePoint":
        """Double-and-add over the LE bits of ``scalar`` (edwards/native.rs
        ``mul_scalar``). Accepts Fr elements or raw ints."""
        r = ProjectivePoint(0, 1, 1)
        exp = self.projective()
        s = int(scalar)
        while s:
            if s & 1:
                r = r.add(exp)
            exp = exp.double()
            s >>= 1
        return r

    def __neg__(self) -> "EdwardsPoint":
        return EdwardsPoint((-self.x) % P, self.y)


@dataclass(frozen=True)
class ProjectivePoint:
    """Projective twisted-Edwards point (bbjlp-2008 coordinate system)."""

    x: int
    y: int
    z: int

    def affine(self) -> EdwardsPoint:
        if self.z == 0:
            return EdwardsPoint(0, 0)
        zinv = pow(self.z, -1, P)
        return EdwardsPoint(self.x * zinv % P, self.y * zinv % P)

    def add(self, q: "ProjectivePoint") -> "ProjectivePoint":
        # add-2008-bbjlp (edwards/params.rs ``add``)
        a = self.z * q.z % P
        b = a * a % P
        c = self.x * q.x % P
        d = self.y * q.y % P
        e = D * c % P * d % P
        f = (b - e) % P
        g = (b + e) % P
        x3 = a * f % P * (((self.x + self.y) * (q.x + q.y) - c - d) % P) % P
        y3 = a * g % P * ((d - A * c) % P) % P
        z3 = f * g % P
        return ProjectivePoint(x3, y3, z3)

    def double(self) -> "ProjectivePoint":
        # dbl-2008-bbjlp (edwards/params.rs ``double``)
        b = (self.x + self.y) % P
        b = b * b % P
        c = self.x * self.x % P
        d = self.y * self.y % P
        e = A * c % P
        f = (e + d) % P
        h = self.z * self.z % P
        j = (f - 2 * h) % P
        x3 = (b - c - d) % P * j % P
        y3 = f * ((e - d) % P) % P
        z3 = f * j % P
        return ProjectivePoint(x3, y3, z3)
