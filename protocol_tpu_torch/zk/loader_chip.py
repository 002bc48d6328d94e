"""In-circuit PLONK verifier: transcript + loader + aggregator chipsets.

Circuit twin of the reference's snark-verifier integration — the
Poseidon transcript chipset (``verifier/transcript/mod.rs:28``), the
halo2 loader (``verifier/loader/mod.rs:33-767``), and the
``AggregatorChipset`` (``verifier/aggregator/mod.rs:99-116``) — rebuilt
for the framework's own PLONK protocol (``plonk.succinct_verify``):

- ``TranscriptChip`` replays the native ``PoseidonTranscript`` absorb
  sequence over cells, so in-circuit challenges equal the host's;
- ``PlonkVerifierChip.succinct_verify`` re-runs the whole verifier
  algebra in-circuit: Fiat–Shamir, gate/permutation/lookup identity at
  ζ, and the GWC batched-opening fold over BN254 G1 (wrong-field Fq
  arithmetic via ``IntegerChip``/``EccChip``), producing the KZG
  accumulator as assigned points — the deferred pairing is left to the
  host decider, exactly like the reference leaves it to the Threshold
  verifier;
- ``AggregatorChipset`` folds per-snark accumulators with the same
  transcript schedule as ``aggregator.NativeAggregator`` and returns
  the 16 accumulator limb cells for the public inputs.

Commitments must be non-identity (true for any blinded proof of a
nontrivial circuit); identity would have no affine coordinates to
assign — same restriction as the reference's EC loader.
"""

from __future__ import annotations

from ..utils.errors import EigenError
from ..utils.fields import BN254_FQ_MODULUS, BN254_FR_MODULUS, Fr
from . import bn254
from .ecc_chip import AssignedPoint, CurveSpec, EccChip
from .gadgets import Cell, Chips
from .integer_chip import IntegerChip, LIMB_BITS, NUM_LIMBS
from .plonk import (
    FIXED_NAMES,
    LOOKUP_WIRE,
    NUM_WIRES,
    QUOTIENT_CHUNKS,
    Proof,
    ProvingKey,
)

R = BN254_FR_MODULUS
Q = BN254_FQ_MODULUS
_MASK128 = (1 << 128) - 1


def bn254_g1_spec() -> CurveSpec:
    return CurveSpec(
        p=Q, n=R, b=3, gen=bn254.G1_GEN,
        add=bn254.g1_add, mul=bn254.g1_mul, neg=bn254.g1_neg)


class TranscriptChip:
    """Cell-level twin of ``transcript.PoseidonTranscript``."""

    def __init__(self, chips: Chips, fq: IntegerChip,
                 label: bytes = b"protocol-tpu-plonk"):
        from .poseidon_chip import PoseidonSpongeChip

        self.chips = chips
        self.fq = fq
        self.sponge = PoseidonSpongeChip(chips)
        self.rounds = 0
        seed = int.from_bytes(label, "little") % R
        self.sponge.update([chips.constant(seed)])

    def absorb_fr(self, cell: Cell) -> None:
        self.sponge.update([cell])

    def absorb_point(self, pt: AssignedPoint) -> None:
        """[2, x_lo128, x_hi, y_lo128, y_hi] — the native encoding
        (transcript.py absorb_point) from 68-bit limbs."""
        c = self.chips
        cells = [c.constant(2)]
        for coord in (pt.x, pt.y):
            if any(m >= 1 << LIMB_BITS for m in coord.max_limb):
                raise EigenError("circuit_error",
                                 "absorb needs reduced coordinates")
            # canonical representative required: the Fiat–Shamir encoding
            # must be unique per point (no x vs x+p grinding freedom)
            self.fq.assert_canonical(coord)
            # lo128 = l0 + (l1 mod 2^60)·2^68 ; hi = l1>>60 + l2·2^8 + l3·2^76
            l1 = coord.limbs[1]
            v1 = c.value(l1)
            lo60 = c.witness(v1 & ((1 << 60) - 1))
            hi8 = c.witness(v1 >> 60)
            c.range_check(lo60, 60)
            c.range_check(hi8, 8)
            c.assert_equal(c.lincomb([(1, lo60), (1 << 60, hi8)]), l1)
            lo128 = c.lincomb([(1, coord.limbs[0]), (1 << 68, lo60)])
            hi = c.lincomb([(1, hi8), (1 << 8, coord.limbs[2]),
                            (1 << 76, coord.limbs[3])])
            cells.extend([lo128, hi])
        self.sponge.update(cells)

    def challenge(self) -> Cell:
        self.rounds += 1
        self.sponge.update([self.chips.constant(self.rounds)])
        return self.sponge.squeeze()


class PlonkVerifierChip:
    """Loader chipset: the verifier computation over cells."""

    def __init__(self, chips: Chips):
        self.chips = chips
        self.spec = bn254_g1_spec()
        self.fq = IntegerChip(chips, Q)
        self.ecc = EccChip(chips, self.fq, self.spec, tag="bn254-g1")

    # --- helpers ----------------------------------------------------------
    def assign_proof(self, pk: ProvingKey, proof_bytes: bytes):
        """Commitments as assigned (on-curve) points, evals as cells."""
        proof = Proof.from_bytes(proof_bytes)
        ec = self.ecc
        commits = {
            "wires": [ec.assign_point(pt) for pt in proof.wire_commits],
            "m": ec.assign_point(proof.m_commit),
            "z": ec.assign_point(proof.z_commit),
            "phi": ec.assign_point(proof.phi_commit),
            "uv": [ec.assign_point(pt) for pt in proof.uv_commits],
            "t": [ec.assign_point(pt) for pt in proof.t_commits],
            "w_x": ec.assign_point(proof.w_x),
            "w_wx": ec.assign_point(proof.w_wx),
        }
        c = self.chips
        evals = {
            "wires": [c.witness(v) for v in proof.wire_evals],
            "m": c.witness(proof.m_eval),
            "z": c.witness(proof.z_eval),
            "z_next": c.witness(proof.z_next_eval),
            "phi": c.witness(proof.phi_eval),
            "phi_next": c.witness(proof.phi_next_eval),
            "uv": [c.witness(v) for v in proof.uv_evals],
            "t": [c.witness(v) for v in proof.t_evals],
            "fixed": [c.witness(v) for v in proof.fixed_evals],
            "sigma": [c.witness(v) for v in proof.sigma_zeta],
        }
        return commits, evals

    def _pow_n(self, x: Cell, k: int) -> Cell:
        out = x
        for _ in range(k):
            out = self.chips.mul(out, out)
        return out

    # --- the verifier -----------------------------------------------------
    def succinct_verify(self, pk: ProvingKey, public_cells: list,
                        proof_bytes: bytes) -> tuple:
        """In-circuit twin of ``plonk.succinct_verify``; returns the
        accumulator (lhs, rhs) as AssignedPoints. All checks that the
        native verifier does with early returns become hard
        constraints."""
        c = self.chips
        d = pk.domain()
        n = d.n
        commits, evals = self.assign_proof(pk, proof_bytes)
        if len(public_cells) != len(pk.public_rows):
            raise EigenError("circuit_error", "public input arity mismatch")

        tr = TranscriptChip(c, self.fq)
        for cell in public_cells:
            tr.absorb_fr(cell)
        for pt in commits["wires"]:
            tr.absorb_point(pt)
        tr.absorb_point(commits["m"])
        beta = tr.challenge()
        gamma = tr.challenge()
        beta_lk = tr.challenge()
        tr.absorb_point(commits["z"])
        tr.absorb_point(commits["phi"])
        for pt in commits["uv"]:
            tr.absorb_point(pt)
        alpha = tr.challenge()
        for pt in commits["t"]:
            tr.absorb_point(pt)
        zeta = tr.challenge()
        for cell in (evals["wires"]
                     + [evals["m"], evals["z"], evals["z_next"],
                        evals["phi"], evals["phi_next"]]
                     + evals["uv"] + evals["t"] + evals["fixed"]
                     + evals["sigma"]):
            tr.absorb_fr(cell)
        v_ch = tr.challenge()
        u_ch = tr.challenge()

        # zh = ζ^n − 1 ; L0 ; PI(ζ)
        zeta_n = self._pow_n(zeta, pk.k)
        zh = c.add_const(zeta_n, -1)
        inv_n = pow(n, -1, R)
        pi = c.constant(0)
        omega_rows = {row: pow(d.omega, row, R) for row in pk.public_rows}
        lag = {}
        for row in pk.public_rows:
            wi = omega_rows[row]
            den = c.mul_const(c.add_const(zeta, -wi), n)
            lag[row] = c.mul_const(c.mul(zh, c.inverse(den)), wi)
        for row, cell in zip(pk.public_rows, public_cells):
            pi = c.sub(pi, c.mul(cell, lag[row]))

        fixed = dict(zip(FIXED_NAMES, evals["fixed"]))
        a, b, cc, dd, e = evals["wires"][:5]
        gate_terms = [
            c.mul(fixed["q_a"], a), c.mul(fixed["q_b"], b),
            c.mul(fixed["q_c"], cc), c.mul(fixed["q_d"], dd),
            c.mul(fixed["q_e"], e),
            c.mul(fixed["q_mul_ab"], c.mul(a, b)),
            c.mul(fixed["q_mul_cd"], c.mul(cc, dd)),
            fixed["q_const"], pi,
        ]
        gate = c.lincomb([(1, t) for t in gate_terms])

        # z-split wire factors and constraints (plonk.py round 2c/3)
        fv, gv = [], []
        for w in range(NUM_WIRES):
            wv = evals["wires"][w]
            shift_zeta = c.mul_const(zeta, pk.shifts[w])
            fv.append(c.add(wv, c.mul_add(beta, shift_zeta, gamma)))
            gv.append(c.add(wv, c.mul_add(beta, evals["sigma"][w], gamma)))
        u1, u2, v1, v2 = evals["uv"]
        link = c.sub(c.mul(c.mul(u2, fv[4]), fv[5]),
                     c.mul(c.mul(v2, gv[4]), gv[5]))
        c_u1 = c.sub(u1, c.mul(c.mul(evals["z"], fv[0]), fv[1]))
        c_u2 = c.sub(u2, c.mul(c.mul(u1, fv[2]), fv[3]))
        c_v1 = c.sub(v1, c.mul(c.mul(evals["z_next"], gv[0]), gv[1]))
        c_v2 = c.sub(v2, c.mul(c.mul(v1, gv[2]), gv[3]))

        l0 = c.mul(zh, c.inverse(c.mul_const(c.add_const(zeta, -1), n)))
        ba = c.add(beta_lk, evals["wires"][LOOKUP_WIRE])
        bt = c.add(beta_lk, fixed["t_lookup"])
        lk = c.add(
            c.sub(c.mul(c.mul(c.sub(evals["phi_next"], evals["phi"]), ba), bt),
                  bt),
            c.mul(evals["m"], ba))

        a2 = c.mul(alpha, alpha)
        a3 = c.mul(a2, alpha)
        a4 = c.mul(a3, alpha)
        a5 = c.mul(a4, alpha)
        a6 = c.mul(a5, alpha)
        a7 = c.mul(a6, alpha)
        a8 = c.mul(a7, alpha)
        total = c.lincomb([
            (1, gate),
            (1, c.mul(alpha, link)),
            (1, c.mul(a2, c.mul(l0, c.add_const(evals["z"], -1)))),
            (1, c.mul(a3, lk)),
            (1, c.mul(a4, c.mul(l0, evals["phi"]))),
            (1, c.mul(a5, c_u1)),
            (1, c.mul(a6, c_u2)),
            (1, c.mul(a7, c_v1)),
            (1, c.mul(a8, c_v2)),
        ])
        t_at_zeta = evals["t"][0]
        acc_pow = zeta_n
        for te in evals["t"][1:]:
            t_at_zeta = c.mul_add(te, acc_pow, t_at_zeta)
            acc_pow = c.mul(acc_pow, zeta_n)
        c.assert_equal(total, c.mul(zh, t_at_zeta))

        # --- batched-opening fold (kzg.fold_batch twin) -------------------
        # One shared-doubling native-scalar MSM (ecc_chip.msm_native, the
        # same-curve chipset) computes the whole GWC fold:
        #   acc_l = Σᵢ vⁱ·Cᵢ + ζ·W₁ − (y₁ + u·y₂)·G
        #           + u·(z + v·φ) + u·ζω·W₂
        #   acc_r = W₁ + u·W₂
        # algebraically identical to the per-point scalar_mul cascade the
        # native verifier runs, so the accumulator limbs match
        # byte-for-byte — but every point shares ONE 252-double chain and
        # the scalars stay native cells (no wrong-field Fr RNS at all).
        vk_pts = pk.commit_list()
        group1 = (
            [(commits["wires"][w], evals["wires"][w], None)
             for w in range(NUM_WIRES)]
            + [(commits["m"], evals["m"], None),
               (commits["z"], evals["z"], None),
               (commits["phi"], evals["phi"], None)]
            + [(commits["uv"][i], evals["uv"][i], None)
               for i in range(len(commits["uv"]))]
            + [(commits["t"][i], evals["t"][i], None)
               for i in range(QUOTIENT_CHUNKS)]
            + [(None, ev, vk_pts[i]) for i, ev in
               enumerate(evals["fixed"] + evals["sigma"])]
        )
        group2 = [(commits["z"], evals["z_next"], None),
                  (commits["phi"], evals["phi_next"], None)]
        omega = d.omega

        # per-point merged native coefficients (z/φ appear in both groups)
        entries: list = []   # [point_or_const, coeff_cell, y-unused]
        index: dict = {}

        def add_term(key, pt, coeff):
            slot = index.get(key)
            if slot is None:
                index[key] = len(entries)
                entries.append([pt, coeff])
            else:
                entries[slot][1] = c.add(entries[slot][1], coeff)

        unit = None  # the coefficient-1 leader joins by plain add
        y_terms = []
        g_pow = None
        for i, (commit, ev, const_pt) in enumerate(group1):
            if g_pow is None:
                unit = commit  # wires[0]
                y_terms.append((1, ev))
            else:
                if const_pt is not None:
                    add_term(("vk", i), const_pt, g_pow)
                else:
                    add_term(("c", id(commit)), commit, g_pow)
                y_terms.append((1, c.mul(g_pow, ev)))
            g_pow = v_ch if g_pow is None else c.mul(g_pow, v_ch)
        add_term(("c", id(commits["w_x"])), commits["w_x"], zeta)
        # group2, weighted by u: items fold with v powers inside
        g2_pow = None
        y2_terms = []
        for commit, ev, _ in group2:
            coeff = u_ch if g2_pow is None else c.mul(u_ch, g2_pow)
            add_term(("c", id(commit)), commit, coeff)
            y2_terms.append((1, ev) if g2_pow is None
                            else (1, c.mul(g2_pow, ev)))
            g2_pow = v_ch if g2_pow is None else c.mul(g2_pow, v_ch)
        zeta_w = c.mul_const(zeta, omega)
        add_term(("c", id(commits["w_wx"])), commits["w_wx"],
                 c.mul(u_ch, zeta_w))
        # −G carries the whole evaluation mass y₁ + u·y₂
        y_total = c.mul_add(u_ch, c.lincomb(y2_terms), c.lincomb(y_terms))
        neg_gen = self.spec.neg(self.spec.gen)
        add_term(("vk", "gen"), neg_gen, y_total)

        msm_items = [(pt, self.ecc.native_digits(coeff))
                     for pt, coeff in entries]
        acc_l = self.ecc.add(self.ecc.msm_native(msm_items), unit)
        acc_r = self.ecc.add(
            self.ecc.msm_native(
                [(commits["w_wx"], self.ecc.native_digits(u_ch))]),
            commits["w_x"])
        return acc_l, acc_r


class AggregatorChipset:
    """In-circuit twin of ``aggregator.NativeAggregator``: succinct-verify
    each snark, fold accumulators with the native transcript schedule,
    return 16 limb cells (aggregator/mod.rs:99-116)."""

    def __init__(self, chips: Chips):
        self.chips = chips
        self.verifier = PlonkVerifierChip(chips)

    def aggregate(self, snarks_with_cells: list) -> tuple:
        """snarks_with_cells: [(ProvingKey, public_cells, proof_bytes)].
        Returns (accumulator_limb_cells, (lhs, rhs) points)."""
        c = self.chips
        tr = TranscriptChip(c, self.verifier.fq,
                            label=b"protocol-tpu-aggregator")
        accs = []
        for pk, public_cells, proof_bytes in snarks_with_cells:
            acc = self.verifier.succinct_verify(pk, public_cells, proof_bytes)
            accs.append(acc)
            for cell in public_cells:
                tr.absorb_fr(cell)
            tr.absorb_point(acc[0])
            tr.absorb_point(acc[1])
        r_ch = tr.challenge()
        lhs, rhs = accs[0]
        r_pow = None
        ecc = self.verifier.ecc
        lhs_items, rhs_items = [], []
        for al, ar in accs[1:]:
            r_pow = r_ch if r_pow is None else c.mul(r_pow, r_ch)
            digits = ecc.native_digits(r_pow)
            lhs_items.append((al, digits))
            rhs_items.append((ar, digits))
        if lhs_items:
            lhs = ecc.add(lhs, ecc.msm_native(lhs_items))
            rhs = ecc.add(rhs, ecc.msm_native(rhs_items))
        limbs = []
        fq = self.verifier.fq
        for pt in (lhs, rhs):
            for coord in (pt.x, pt.y):
                # unique representative so the limb instances match the
                # native aggregator's byte-for-byte
                fq.assert_canonical(coord)
                limbs.extend(coord.limbs[:NUM_LIMBS])
        return limbs, (lhs, rhs)
