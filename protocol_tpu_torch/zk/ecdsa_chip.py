"""ECDSA verification chipset (secp256k1 over a BN254-native circuit).

Circuit twin of the reference's ``EcdsaChipset``/``EcdsaAssigner``
(``eigentrust-zk/src/ecdsa/mod.rs:317-530``) against the native oracle
``protocol_tpu_torch.crypto.secp256k1`` (itself mirroring
``ecdsa/native.rs:382-395``):

    s⁻¹·s ≡ 1 (mod n),  u₁ = z·s⁻¹,  u₂ = r·s⁻¹,
    R = u₁·G + u₂·PK,   accept iff  R.x mod n == r.

All checks are hard constraints — an invalid signature makes the circuit
unsatisfiable. The client pipeline therefore nulls invalid attestations
*before* witness generation (replacing them with dummy-signed empty
entries), matching the end-to-end score semantics of the reference's
null-then-redistribute rule (``opinion/native.rs:92-101``) while keeping
the circuit shape static; see ``eigentrust_circuit.py``.

Message-hash binding: the attestation hash is a native (Fr) cell; it is
decomposed into limbs whose recomposition is copy-constrained to the
cell and whose value is proven < r (canonical), so exactly one secp
scalar can be claimed for a given hash cell.
"""

from __future__ import annotations

from ..crypto.secp256k1 import GLV_BETA, GLV_LAMBDA, glv_decompose
from ..utils.errors import EigenError
from ..utils.fields import BN254_FR_MODULUS
from .ecc_chip import (
    TABLE_SIZE,
    WINDOW_BITS,
    AssignedPoint,
    EccChip,
    secp256k1_spec,
)
from .gadgets import Cell, Chips
from .integer_chip import (
    B as LIMB_B,
    LIMB_BITS,
    AssignedInteger,
    IntegerChip,
)

R = BN254_FR_MODULUS

# GLV half-scalars are < 2^129 (crypto/secp256k1.py GLV_HALF_BITS); 33
# 4-bit windows cover 132 bits with margin
GLV_WINDOWS = 33


class EcdsaChip:
    """Shared sub-chips for verifying many signatures in one circuit."""

    def __init__(self, chips: Chips):
        self.chips = chips
        self.spec = secp256k1_spec()
        self.fp = IntegerChip(chips, self.spec.p)
        self.fn = IntegerChip(chips, self.spec.n)
        self.fr = IntegerChip(chips, R)  # only for canonical Fr binding
        self.ecc = EccChip(chips, self.fp, self.spec, tag="secp256k1")

    # --- assignment -------------------------------------------------------
    def assign_pubkey(self, point: tuple) -> AssignedPoint:
        return self.ecc.assign_point(point)

    def assign_scalar(self, value: int) -> AssignedInteger:
        """A canonical mod-n scalar witness (0 ≤ value < n)."""
        if not 0 <= value < self.spec.n:
            raise EigenError("circuit_error", "scalar out of range")
        a = self.fn.assign(value)
        self.fn.assert_canonical(a)
        return a

    def bind_native_scalar(self, cell: Cell) -> AssignedInteger:
        """Decompose a native Fr cell into limbs usable as a secp scalar:
        recomposition is copied to the cell and the value is proven < r,
        so the representative is unique (r < n, so it is canonical mod n
        too)."""
        c = self.chips
        value = c.value(cell)
        limbs = self.fr.assign(value)
        self.fr.assert_canonical(limbs)
        c.assert_equal(self.fr.native(limbs), cell)
        return AssignedInteger(limbs.limbs, limbs.value, limbs.max_limb)

    # --- GLV decomposition -------------------------------------------------
    def _assign_half_scalar(self, value: int) -> tuple:
        """33 LSB-first 4-bit lookup digits of a GLV half-scalar
        (< 2^132) plus the 2-limb ``fn`` integer they compose — the SAME
        digit cells drive the point selects and the congruence
        constraint, so the scalar the loop walks is the scalar the
        congruence binds."""
        c = self.chips
        digits = []
        for w in range(GLV_WINDOWS):
            dv = (value >> (WINDOW_BITS * w)) & (TABLE_SIZE - 1)
            digits.append(c.assign_range(dv, WINDOW_BITS))
        per_limb = LIMB_BITS // WINDOW_BITS  # 17 digits per 68-bit limb
        l0 = c.lincomb([(1 << (WINDOW_BITS * w), digits[w])
                        for w in range(per_limb)])
        l1 = c.lincomb([(1 << (WINDOW_BITS * (w - per_limb)), digits[w])
                        for w in range(per_limb, GLV_WINDOWS)])
        zero = c.constant(0)
        mx1 = (1 << (WINDOW_BITS * (GLV_WINDOWS - per_limb))) - 1
        half = AssignedInteger([l0, l1, zero, zero], value,
                               [LIMB_B - 1, mx1, 0, 0])
        return digits, half

    def _glv_mul(self, pubkey: AssignedPoint,
                 u2: AssignedInteger) -> AssignedPoint:
        """u2·PK via the secp256k1 endomorphism: u2 ≡ ±s1 ± λ·s2
        (mod n) with 129-bit halves (``glv_decompose``), so ±PK and
        ±φPK = (β·x, ±y) share ONE 132-bit doubling chain instead of
        the full 272-bit ladder each — the row cut that fits the
        flagship ET circuit in k=21. Sound for any witnessed
        decomposition: the congruence is CRT-constrained mod n, and
        s·P only depends on s mod n."""
        c, fn, fp, ecc = self.chips, self.fn, self.fp, self.ecc
        s1, e1, s2, e2 = glv_decompose(u2.value % self.spec.n)
        d1, a1 = self._assign_half_scalar(s1)
        d2, a2 = self._assign_half_scalar(s2)
        b1 = c.witness(int(e1 < 0))
        c.assert_bool(b1)
        b2 = c.witness(int(e2 < 0))
        c.assert_bool(b2)
        # congruence: (−1)^{b1}·s1 + λ·(−1)^{b2}·s2 ≡ u2 (mod n)
        zero = fn.constant(0)
        t2 = fn.mul(a2, fn.constant(GLV_LAMBDA))
        m1 = fn.select(b1, fn.sub(zero, a1), a1)
        m2 = fn.select(b2, fn.sub(zero, t2), t2)
        fn.constrain_mul(fn.add(m1, m2), fn.one(), u2)
        # the sign flips move onto the points: s·(±P), λ·s·(±φP)
        y_neg = fp.sub(fp.constant(0), pubkey.y)
        p1 = AssignedPoint(pubkey.x, fp.select(b1, y_neg, pubkey.y))
        phi_x = fp.mul(pubkey.x, fp.constant(GLV_BETA))
        p2 = AssignedPoint(phi_x, fp.select(b2, y_neg, pubkey.y))
        return ecc.msm_digits([(p1, d1), (p2, d2)], GLV_WINDOWS)

    # --- verification -----------------------------------------------------
    def verify(self, sig_r: AssignedInteger, sig_s: AssignedInteger,
               msg_hash: AssignedInteger, pubkey: AssignedPoint) -> None:
        """Hard-constrain signature validity (EcdsaChipset::synthesize
        twin, ecdsa/mod.rs:416-530). The variable-base u2·PK runs on the
        GLV shared-doubling path (:meth:`_glv_mul`)."""
        fn, fp, ecc = self.fn, self.fp, self.ecc
        fn.assert_not_zero(sig_r)
        fn.assert_not_zero(sig_s)
        s_inv = fn.div(fn.one(), sig_s)
        u1 = fn.mul(msg_hash, s_inv)
        u2 = fn.mul(sig_r, s_inv)
        p1 = ecc.scalar_mul_fixed(fn.to_window_digits(u1))
        p2 = self._glv_mul(pubkey, u2)
        r_pt = ecc.add(p1, p2)
        # R.x (canonical mod p) reduced mod n must equal r
        x_can = fp.reduce(r_pt.x)
        fp.assert_canonical(x_can)
        as_n = AssignedInteger(x_can.limbs, x_can.value, x_can.max_limb)
        x_mod_n = fn.reduce(as_n)
        fn.assert_canonical(x_mod_n)
        fn.assert_equal(x_mod_n, sig_r)
