"""Device round-3/4 engine for the PLONK prover, on torch: the counterpart
of ``protocol_tpu/zk/prover_tpu.py``.

Replaces the host C++ extension-domain work inside ``prove_fast`` when
the proving key is eval-form (FPK2) and the prove runs on a device:

- extension evaluation: the 4n coset (z-split protocol, zk/plonk.py)
  splits into 4 size-n cosets shift·ωₑʲ·H; each poly's ext chunk is
  ``ntt_tpu.ntt`` of its coset-scaled coefficients (all chunks share
  one n-sized plan). A blinded poly p + b·Z_H needs only the
  closed-form correction zh_c·b(x) per chunk, because Z_H is the
  CONSTANT shift_jⁿ−1 on a coset.
- z(ωX), φ(ωX): multiplying the argument by ω_n stays inside a coset,
  so the shifted polys are a static index roll of the unshifted chunk —
  no extra NTTs.
- the quotient identity (an exact twin of the C++ ``quotient_eval2``)
  runs pointwise per chunk in the limb engine; Z_H and its inverse are
  per-chunk scalars.
- the 4n inverse NTT is 4 per-chunk iNTTs plus a radix-4 cross-chunk
  combine (derivation at ``intt_ext``), emitting the quotient
  coefficient chunks a[u·n:(u+1)·n] directly.
- round 4: γ-power folds of the device-resident coefficient arrays
  (host divides and commits) and ζ-evaluations from the resident
  coefficients (host applies the blinding corrections).

What differs from the reference, and why:

- the arithmetic is the port's limb engine (``ops/fieldops2.py``):
  (n, 22) int32 rows in B2's Montgomery domain (R = 2^264), every
  product one launch of the hand-written ``mont_mul`` (B2), every sum
  one ``add_mod``/``sub_mod``; the NTT's stage products are int8
  tensor-core matmuls (``ops/ntt_tpu.py``);
- the reference's ``@jax.jit`` programs are plain functions on tensors:
  nothing compiles, so ``compile_stats`` stays at zero;
- device arrays are canonical rows, never 16-bit packs: the packing
  halved HBM on a 16 GB chip, and at k = 20 the resident set is a few
  GB of an 80 GB card;
- ``upload_mont``/``download_std`` move the u64 wire form through
  pinned host memory.

Everything is exact field arithmetic: t chunks, folds and evaluations
equal the host path's (tested)."""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..ops import fieldops2 as f2
from ..ops import ntt_tpu
from ..utils import trace
from ..utils.fields import BN254_FR_MODULUS as P

L = f2.L
EXT_COSETS = 4  # the z-split quotient runs on a 4n coset


def _cplane(v: int, device) -> torch.Tensor:
    """(1, 22) Montgomery row of a host scalar."""
    return f2.mont_rows([v], device)


def _bcast(row: torch.Tensor, n: int) -> torch.Tensor:
    """One (1, 22) row as an (n, 22) broadcast (stride 0)."""
    return row.expand(n, L)


def synchronize(x) -> None:
    """Wait for the CUDA work behind ``x`` (tensors, or nested lists and
    tuples of them)."""
    for dev in trace._cuda_devices(x):
        torch.cuda.synchronize(dev)


# (n, 4) u64 standard ↔ (n, 22) Montgomery rows, through pinned memory
upload_mont = f2.upload_mont
download_std = f2.download_std
powers_vector = f2.powers_vector


def _is_zero_poly(x: torch.Tensor) -> int:
    """Device-side all-zero check of a coefficient array: the quotient
    degree gate reads one scalar instead of a chunk."""
    return int((x != 0).any())


def fs_from_natural(x: torch.Tensor, A: int, B: int) -> torch.Tensor:
    """Natural-order (n, 22) → FS layout (element i = k1 + k2·A moves to
    row k1·B + k2)."""
    return x.reshape(B, A, L).transpose(0, 1).reshape(A * B, L)


def natural_from_fs(x: torch.Tensor, A: int, B: int) -> torch.Tensor:
    return x.reshape(A, B, L).transpose(0, 1).reshape(A * B, L)


def fs_roll_next(x: torch.Tensor, A: int, B: int) -> torch.Tensor:
    """FS twin of "value at natural index i+1 (mod n)": p'(xᵢ)=p(ω·xᵢ)."""
    m = x.reshape(A, B, L)
    wrap = torch.roll(m[:1], -1, dims=1)
    return torch.cat([m[1:], wrap]).reshape(A * B, L)


# --- the pointwise pieces -----------------------------------------------------

def _ext_chunk(coeffs, coset, xs_fs, zh_row, blind_rows, plan):
    """One (possibly blinded) FS-layout ext chunk: the coset-scaled
    coefficients' NTT plus zh_c·b(x) for blinds b (Montgomery rows)."""
    chunk = ntt_tpu.ntt(f2.mont_mul(coeffs, coset), plan)
    return _blind(chunk, xs_fs, zh_row, blind_rows)


def _blind(chunk, xs_fs, zh_row, blind_rows):
    """``chunk`` + zh_c·b(x) on the coset points ``xs_fs`` (the same
    rows as the chunk): the blinding of an ext chunk, pointwise."""
    if blind_rows is None:
        return chunk
    n = chunk.shape[0]
    corr = _bcast(blind_rows[0:1], n)
    xp = xs_fs
    for i in range(1, blind_rows.shape[0]):
        corr = f2.add(corr, f2.mont_mul(xp, _bcast(blind_rows[i:i + 1], n)))
        if i + 1 < blind_rows.shape[0]:
            xp = f2.mont_mul(xp, xs_fs)
    return f2.add(chunk, f2.mont_mul(corr, _bcast(zh_row, n)))


# challenge-row layout shared by both quotient variants:
# 0 beta, 1 gamma, 2 beta_lk, 3..10 alpha^1..alpha^8,
# 11..16 beta·shift_k
_CH_ALPHA = 3
_CH_BSHIFT = 11


def quotient_pointwise(w, zi, zwi, mi, phii, phiwi, pii, uv, fx, sg, xs,
                       l0, ch, zh_inv_row):
    """The z-split quotient identity as pointwise limb-engine math — every
    input an (m, 22) Montgomery row batch; ``ch`` the (17, 22) challenge
    rows (layout above). The single home of the identity for the
    resident and the fused streaming quotient."""
    n = w[0].shape[0]

    def cc(idx):
        return _bcast(ch[idx:idx + 1], n)

    one = f2.const_rows(f2.R_MONT, n, w[0].device)
    mul, add, sub = f2.mont_mul, f2.add, f2.sub
    gate = mul(fx[0], w[0])
    for kk in range(1, 5):
        gate = add(gate, mul(fx[kk], w[kk]))
    gate = add(gate, mul(fx[5], mul(w[0], w[1])))
    gate = add(gate, mul(fx[6], mul(w[2], w[3])))
    gate = add(gate, fx[7])
    gate = add(gate, pii)

    # permutation wire factors
    fv, gv = [], []
    for kk in range(6):
        f1 = mul(xs, cc(_CH_BSHIFT + kk))
        fv.append(add(add(f1, w[kk]), cc(1)))
        g2 = mul(sg[kk], cc(0))
        gv.append(add(add(g2, w[kk]), cc(1)))
    link = sub(mul(mul(uv[1], fv[4]), fv[5]),
               mul(mul(uv[3], gv[4]), gv[5]))
    c_u1 = sub(uv[0], mul(mul(zi, fv[0]), fv[1]))
    c_u2 = sub(uv[1], mul(mul(uv[0], fv[2]), fv[3]))
    c_v1 = sub(uv[2], mul(mul(zwi, gv[0]), gv[1]))
    c_v2 = sub(uv[3], mul(mul(uv[2], gv[2]), gv[3]))

    # LogUp: lk = (dphi·ba − 1)·bt + m·ba
    ba = add(w[5], cc(2))
    bt = add(fx[8], cc(2))
    lk = mul(sub(phiwi, phii), ba)
    lk = sub(lk, one)
    lk = mul(lk, bt)
    lk = add(lk, mul(mi, ba))

    a = _CH_ALPHA
    total = add(gate, mul(link, cc(a)))
    total = add(total, mul(mul(l0, sub(zi, one)), cc(a + 1)))
    total = add(total, mul(lk, cc(a + 2)))
    total = add(total, mul(mul(l0, phii), cc(a + 3)))
    total = add(total, mul(c_u1, cc(a + 4)))
    total = add(total, mul(c_u2, cc(a + 5)))
    total = add(total, mul(c_v1, cc(a + 6)))
    total = add(total, mul(c_v2, cc(a + 7)))
    return mul(total, _bcast(zh_inv_row, n))


def _perm_step_x(pn, xs, bshift_row, w, gamma_row):
    """pn · (w + β·shift·x + γ) — one X-side permutation factor."""
    n = w.shape[0]
    f1 = f2.mont_mul(xs, _bcast(bshift_row, n))
    f1 = f2.add(f2.add(f1, w), _bcast(gamma_row, n))
    return f2.mont_mul(pn, f1)


def _perm_step_sg(pd, sg_e, beta_row, w, gamma_row):
    """pd · (w + β·σ + γ) — one σ-side permutation factor."""
    n = w.shape[0]
    g2 = f2.mont_mul(sg_e, _bcast(beta_row, n))
    g2 = f2.add(f2.add(g2, w), _bcast(gamma_row, n))
    return f2.mont_mul(pd, g2)


def _lk(w5, fx8_e, m_e, phii, phiwi, blk_row):
    n = w5.shape[0]
    one = f2.const_rows(f2.R_MONT, n, w5.device)
    blk = _bcast(blk_row, n)
    ba = f2.add(w5, blk)
    bt = f2.add(fx8_e, blk)
    lk = f2.mont_mul(f2.sub(phiwi, phii), ba)
    lk = f2.sub(lk, one)
    lk = f2.mont_mul(lk, bt)
    return f2.add(lk, f2.mont_mul(m_e, ba))


def _qfinal(gate, link_f, link_g, t_u1, t_u2, t_v1, t_v2, uv, lk, z_e,
            phii, l0, ch, zh_inv_row):
    """Streaming-path final combine of the z-split identity terms."""
    n = gate.shape[0]

    def cc(idx):
        return _bcast(ch[idx:idx + 1], n)

    mul, add, sub = f2.mont_mul, f2.add, f2.sub
    one = f2.const_rows(f2.R_MONT, n, gate.device)
    a = _CH_ALPHA
    total = add(gate, mul(sub(link_f, link_g), cc(a)))
    total = add(total, mul(mul(l0, sub(z_e, one)), cc(a + 1)))
    total = add(total, mul(lk, cc(a + 2)))
    total = add(total, mul(mul(l0, phii), cc(a + 3)))
    total = add(total, mul(sub(uv[0], t_u1), cc(a + 4)))
    total = add(total, mul(sub(uv[1], t_u2), cc(a + 5)))
    total = add(total, mul(sub(uv[2], t_v1), cc(a + 6)))
    total = add(total, mul(sub(uv[3], t_v2), cc(a + 7)))
    return mul(total, _bcast(zh_inv_row, n))


def _fold(scalar_rows, polys, acc=None):
    """acc + Σ scalarᵢ·pᵢ (scalar_rows: (m, 22) Montgomery)."""
    n = polys[0].shape[0]
    for i, p in enumerate(polys):
        term = f2.mont_mul(p, _bcast(scalar_rows[i:i + 1], n))
        acc = term if acc is None else f2.add(acc, term)
    return acc


def _dots(weights, evals) -> torch.Tensor:
    """(m, 22): Σ over rows of eᵢ·w for each e in ``evals``."""
    return torch.cat([f2.sum_rows(f2.mont_mul(e, weights)) for e in evals])


class DeviceProver:
    """Per-(k, shift, pk, device) state: NTT plan, coset tables, and the
    pk's fixed/sigma columns resident as coefficients + ext chunks.

    Memory at k = 20, full residency: 15 pk coefficient columns and 60
    pk ext chunks of 92 MB each (the (n, 22) int32 rows) ≈ 7 GB, the
    static tables ≈ 2 GB, and a prove's working set (14 witness columns,
    their 56 ext chunks when predispatched, 4 t chunks, an NTT's planes)
    ≈ 7 GB more: well inside the card's 80 GB. H-domain eval arrays are
    never resident (ζ-evals run from coefficients), as in the
    reference."""

    def __init__(self, k: int, shift: int, fixed_evals_u64, sigma_evals_u64,
                 ext_resident: "bool | str | None" = None, device=None):
        # ``device``: the torch device every tensor of this prover lives
        # on (a proof-pool worker's own card); None means the card and
        # raises without one
        self.device = resolve_device(device)
        self.k = k
        self.n = 1 << k
        with self._on_device():
            self._init_device_state(k, shift, fixed_evals_u64,
                                    sigma_evals_u64, ext_resident)

    def _on_device(self):
        """``torch.cuda.device`` pin for this prover's card (no-op on the
        CPU), so every launch lands on the owning worker's device."""
        import contextlib

        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.device(self.device)

    def _init_device_state(self, k, shift, fixed_evals_u64,
                           sigma_evals_u64, ext_resident):
        # Resident ext chunks are a speed/memory trade — three modes, the
        # reference's:
        #   True    full residency: the 15 pk columns' ext chunks stay
        #           resident and the quotient reads them;
        #   "fixed" partial residency: only the 9 fixed columns' ext
        #           chunks stay resident, σ columns stream;
        #   False   pure streaming — the pk ext chunks are made per
        #           quotient chunk, at most one live at a time.
        # PTPU_EXT_RESIDENT={0,1,fixed} overrides. Defaults are the
        # reference's: k ≤ 20 full, k = 21 partial, beyond streaming.
        if ext_resident is None:
            env = os.environ.get("PTPU_EXT_RESIDENT")
            if env == "fixed":
                ext_resident = "fixed"
            elif env in ("0", "1"):
                ext_resident = env == "1"
            elif k <= 20:
                ext_resident = True
            elif k == 21:
                ext_resident = "fixed"
            else:
                ext_resident = False
        self.ext_resident = ext_resident is True
        self.fixed_ext_resident = (ext_resident is True
                                   or ext_resident == "fixed")
        # One prove = one quotient form: latch the fused-quotient switch
        # here (like ext_resident above) so toggling PTPU_FUSED_QUOTIENT
        # mid-prove cannot mix the two streaming forms in one prove.
        self.fused_quotient = (
            os.environ.get("PTPU_FUSED_QUOTIENT", "1") != "0")
        dev = self.device
        self.plan = ntt_tpu.NttPlan.get(k, dev)
        self.A, self.B = self.plan.A, self.plan.B
        omega_e = ntt_tpu._root_of_unity(k + 2)     # order 4n
        self.omega = self.plan.omega                # order n
        self.omega_e = omega_e
        self.shift = shift
        self.shifts_c = [shift * pow(omega_e, j, P) % P
                         for j in range(EXT_COSETS)]
        self.zh_c = [(pow(s, self.n, P) - 1) % P for s in self.shifts_c]
        self.zh_inv_c = [pow(z, -1, P) for z in self.zh_c]
        self.zh_rows = [_cplane(z, dev) for z in self.zh_c]
        self.zh_inv_rows = [_cplane(z, dev) for z in self.zh_inv_c]

        self._tables_live = False
        self._build_static_tables()

        # pk columns: coefficients resident
        with trace.span("prove_device.pk_upload", k=k):
            self.fixed_coeffs = [self.upload_intt(a)
                                 for a in fixed_evals_u64]
            self.sigma_coeffs = [self.upload_intt(a)
                                 for a in sigma_evals_u64]
            trace.device_sync(self.sigma_coeffs)

        self._bary: dict = {}
        # resident ext-chunk tables per mode — built from the coefficients
        # by resume() (the same rebuild a suspended prover runs when it is
        # reactivated)
        self.fixed_ext = []
        self.sigma_ext = []
        self.resume()

    def _build_static_tables(self) -> None:
        """Device tables that are pure functions of (k, shift): power
        vectors, per-coset xs/L0 tables and the intt_ext combine
        tables. Rebuilt by :meth:`resume` after a deep suspend."""
        n, dev = self.n, self.device
        omega_e = self.omega_e
        shift = self.shift
        self.omega_pows = powers_vector(self.omega, n, dev)   # natural
        self.coset_pows = [powers_vector(s, n, dev) for s in self.shifts_c]
        n_row = _cplane(n, dev)
        one = f2.const_rows(f2.R_MONT, n, dev)
        self.xs_fs, self.l0_fs = [], []
        for j in range(EXT_COSETS):
            xs_nat = f2.mont_mul(self.omega_pows,
                                 _bcast(_cplane(self.shifts_c[j], dev), n))
            den = f2.mont_mul(f2.sub(xs_nat, one), _bcast(n_row, n))
            l0 = f2.mont_mul(f2.batch_inv(den), _bcast(self.zh_rows[j], n))
            # xs and l0 are made in natural order: BOTH go to FS layout
            self.xs_fs.append(fs_from_natural(xs_nat, self.A, self.B)
                              .contiguous())
            self.l0_fs.append(fs_from_natural(l0, self.A, self.B)
                              .contiguous())

        # intt_ext combine tables
        self.we_neg_pows = [powers_vector(pow(omega_e, -j, P), n, dev)
                            for j in range(EXT_COSETS)]
        self.s_neg_pows = powers_vector(pow(shift, -1, P), n, dev)
        zeta_c = pow(omega_e, n, P)        # primitive EXT_COSETS-th root
        inv_c = pow(EXT_COSETS, -1, P)
        s_n_inv = pow(shift, -n, P)
        self.zc_rows = [
            f2.mont_rows([pow(zeta_c, (-j * u) % EXT_COSETS, P) * inv_c % P
                          for j in range(EXT_COSETS)], dev)
            for u in range(EXT_COSETS)]
        self.su_rows = f2.mont_rows([pow(s_n_inv, u, P)
                                     for u in range(EXT_COSETS)], dev)
        self._tables_live = True

    def suspend(self, deep: "bool | None" = None) -> None:
        """Park this prover: release the resident pk ext-chunk tables
        and the per-ζ barycentric cache, keeping the coefficient columns
        (so reactivation is device compute only — no re-uploads). A
        multi-prover cache suspends the inactive prover so the active
        prove keeps its working-set budget.

        Driver model: one driver per ``DeviceProverCache`` (each proof-
        pool worker owns one, pinned to its own card); the cache
        serializes its provers' activations under its own lock.

        ``deep`` (the default; PTPU_DP_SUSPEND=shallow opts out) also
        drops the static (k, shift) tables, rebuilt from host scalars
        on resume."""
        if deep is None:
            deep = os.environ.get("PTPU_DP_SUSPEND", "deep") != "shallow"
        trace.event("prove_device.suspend", k=self.k, deep=bool(deep))
        self.fixed_ext = []
        self.sigma_ext = []
        self._bary = {}
        if deep and self._tables_live:
            for name in ("omega_pows", "coset_pows", "xs_fs", "l0_fs",
                         "we_neg_pows", "s_neg_pows", "zc_rows",
                         "su_rows"):
                setattr(self, name, None)
            self._tables_live = False

    def resume(self) -> None:
        """(Re)build whatever resident tables this prover's mode keeps:
        the static tables if a deep suspend dropped them, then the pk
        ext-chunk tables from the resident coefficients. Identical to a
        fresh init (canonical rows either way)."""
        with self._on_device():
            self._resume_tables()

    def _resume_tables(self) -> None:
        if not self._tables_live:
            with trace.span("prove_device.static_tables_build", k=self.k):
                self._build_static_tables()
        if self.fixed_ext_resident and not self.fixed_ext:
            with trace.span("prove_device.pk_ext_build", k=self.k,
                            which="fixed"):
                self.fixed_ext = [self.ext_chunks(cf)
                                  for cf in self.fixed_coeffs]
                trace.device_sync(self.fixed_ext)
        if self.ext_resident and not self.sigma_ext:
            with trace.span("prove_device.pk_ext_build", k=self.k,
                            which="sigma"):
                self.sigma_ext = [self.ext_chunks(cf)
                                  for cf in self.sigma_coeffs]
                trace.device_sync(self.sigma_ext)

    # --- transforms -------------------------------------------------------

    def intt_natural(self, evals_nat: torch.Tensor) -> torch.Tensor:
        """Natural-order evals on H → natural-order coefficients."""
        return ntt_tpu.intt(fs_from_natural(evals_nat, self.A, self.B)
                            .contiguous(), self.plan)

    def upload_intt(self, arr_u64: np.ndarray) -> torch.Tensor:
        """(n, 4) u64 standard evals on the host → coefficient rows on the
        device: upload, FS reorder, iNTT."""
        return self.intt_natural(upload_mont(arr_u64, self.device))

    def ext_chunk(self, coeffs: torch.Tensor, j: int,
                  blinds=None) -> torch.Tensor:
        """One FS-layout ext chunk of a (possibly blinded) polynomial."""
        rows = f2.mont_rows(blinds, self.device) if blinds else None
        return _ext_chunk(coeffs, self.coset_pows[j], self.xs_fs[j],
                          self.zh_rows[j], rows, self.plan)

    def ext_chunks(self, coeffs: torch.Tensor, blinds=None) -> list:
        return [self.ext_chunk(coeffs, j, blinds)
                for j in range(EXT_COSETS)]

    # --- quotient ---------------------------------------------------------

    def challenge_planes(self, beta, gamma, beta_lk, alpha, shifts
                         ) -> torch.Tensor:
        """(17, 22) challenge rows; layout: see _CH_ALPHA/_CH_BSHIFT."""
        apows = []
        a = 1
        for _ in range(8):
            a = a * alpha % P
            apows.append(a)
        vals = [beta, gamma, beta_lk] + apows + \
            [beta * s % P for s in shifts]
        return f2.mont_rows(vals, self.device)

    def quotient_chunk(self, j, wires_e, z_e, m_e, phi_e, pi_e, uv_e,
                       ch) -> torch.Tensor:
        """Device twin of the C++ quotient_eval2 on coset chunk j;
        ``uv_e`` = [u1, u2, v1, v2] ext chunks; ``ch`` from
        :meth:`challenge_planes`. Without the resident pk ext chunks it
        streams them: all at once for the chunk (the fused form, unless
        PTPU_FUSED_QUOTIENT=0, latched in ``__init__``) or one at a time
        folded into running terms (the chain, the smaller working
        set)."""
        if not self.ext_resident:
            if self.fused_quotient:
                fx = [self._fixed_ext_chunk(i, j) for i in range(9)]
                sg = [self.ext_chunk(self.sigma_coeffs[kk], j)
                      for kk in range(6)]
                return self._quotient(j, wires_e, z_e, m_e, phi_e, pi_e,
                                      uv_e, fx, sg, ch)
            return self._quotient_chunk_streaming(
                j, wires_e, z_e, m_e, phi_e, pi_e, uv_e, ch)
        return self._quotient(j, wires_e, z_e, m_e, phi_e, pi_e, uv_e,
                              [self.fixed_ext[i][j] for i in range(9)],
                              [self.sigma_ext[i][j] for i in range(6)], ch)

    def _quotient(self, j, wires_e, z_e, m_e, phi_e, pi_e, uv_e, fx, sg,
                  ch) -> torch.Tensor:
        zwi = fs_roll_next(z_e, self.A, self.B)
        phiwi = fs_roll_next(phi_e, self.A, self.B)
        return quotient_pointwise(list(wires_e), z_e, zwi, m_e, phi_e,
                                  phiwi, pi_e, list(uv_e), fx, sg,
                                  self.xs_fs[j], self.l0_fs[j], ch,
                                  self.zh_inv_rows[j])

    def _fixed_ext_chunk(self, i: int, j: int) -> torch.Tensor:
        """Fixed column i's ext chunk j: the resident table in "fixed"/
        full residency, an on-the-fly NTT otherwise."""
        if self.fixed_ext:
            return self.fixed_ext[i][j]
        return self.ext_chunk(self.fixed_coeffs[i], j)

    def _quotient_chunk_streaming(self, j, wires_e, z_e, m_e, phi_e,
                                  pi_e, uv_e, ch) -> torch.Tensor:
        """Same math as the resident quotient, but each pk column's ext
        chunk is made on the fly and folded at once, so at most one is
        live. Identical to the resident path (tested)."""
        def cp(idx):  # (1, 22) challenge row
            return ch[idx:idx + 1]

        mul, add = f2.mont_mul, f2.add
        # gate: Σ fx_i·w_i + fx5·w0w1 + fx6·w2w3 + fx7 + pi
        gate = None
        for i in range(5):
            term = mul(self._fixed_ext_chunk(i, j), wires_e[i])
            gate = term if gate is None else add(gate, term)
        gate = add(gate, mul(self._fixed_ext_chunk(5, j),
                             mul(wires_e[0], wires_e[1])))
        gate = add(gate, mul(self._fixed_ext_chunk(6, j),
                             mul(wires_e[2], wires_e[3])))
        gate = add(gate, self._fixed_ext_chunk(7, j))
        gate = add(gate, pi_e)

        # z-split partial-product chains. X-side factors need no pk
        # columns; the σ-side streams one σ ext chunk at a time.
        bs = _CH_BSHIFT
        xs = self.xs_fs[j]
        t_u1 = _perm_step_x(z_e, xs, cp(bs + 0), wires_e[0], cp(1))
        t_u1 = _perm_step_x(t_u1, xs, cp(bs + 1), wires_e[1], cp(1))
        t_u2 = _perm_step_x(uv_e[0], xs, cp(bs + 2), wires_e[2], cp(1))
        t_u2 = _perm_step_x(t_u2, xs, cp(bs + 3), wires_e[3], cp(1))
        link_f = _perm_step_x(uv_e[1], xs, cp(bs + 4), wires_e[4], cp(1))
        link_f = _perm_step_x(link_f, xs, cp(bs + 5), wires_e[5], cp(1))
        zwi = fs_roll_next(z_e, self.A, self.B)
        outs_g = []
        for base, k0 in ((zwi, 0), (uv_e[2], 2), (uv_e[3], 4)):
            acc = base
            for kk in (k0, k0 + 1):
                sg = self.ext_chunk(self.sigma_coeffs[kk], j)
                acc = _perm_step_sg(acc, sg, cp(0), wires_e[kk], cp(1))
                del sg
            outs_g.append(acc)
        t_v1, t_v2, link_g = outs_g

        # LogUp
        phiwi = fs_roll_next(phi_e, self.A, self.B)
        lk = _lk(wires_e[5], self._fixed_ext_chunk(8, j), m_e, phi_e,
                 phiwi, cp(2))

        return _qfinal(gate, link_f, link_g, t_u1, t_u2, t_v1, t_v2,
                       uv_e, lk, z_e, phi_e, self.l0_fs[j], ch,
                       self.zh_inv_rows[j])

    # --- 4n inverse -------------------------------------------------------

    def intt_ext(self, t_chunks: list) -> list:
        """FS coset chunks of t → list of EXT_COSETS (n, 22) coefficient
        chunks a[u·n:(u+1)·n] (derivation: iNTT_n folds coefficients;
        after the ωₑ^{−jd} twiddle, an EXT_COSETS-point inverse DFT
        across chunks recovers b_u[d] = a_{d+un}·s^{d+un}, then the
        s-power unscale).

        CONSUMES ``t_chunks`` (entries are dropped as their iNTT
        completes) and emits output chunks one at a time."""
        hats = []
        for j in range(EXT_COSETS):
            cj = ntt_tpu.intt(t_chunks[j], self.plan)
            t_chunks[j] = None
            hats.append(f2.mont_mul(cj, self.we_neg_pows[j]))
        n = self.n
        out = []
        for u in range(EXT_COSETS):
            acc = _fold(self.zc_rows[u], hats)
            acc = f2.mont_mul(acc, self.s_neg_pows)
            out.append(f2.mont_mul(acc, _bcast(self.su_rows[u:u + 1], n)))
        return out

    # --- round 4 ----------------------------------------------------------

    def fold_coeffs(self, polys: list, scalars: list) -> torch.Tensor:
        """Σ scalarᵢ·pᵢ over same-length device coefficient arrays."""
        return _fold(f2.mont_rows(scalars, self.device), polys)

    def barycentric_weights(self, zeta: int) -> torch.Tensor:
        key = zeta % P
        w = self._bary.get(key)
        if w is None:
            n, dev = self.n, self.device
            zh = (pow(zeta, n, P) - 1) % P
            den = f2.mont_mul(
                f2.sub(_bcast(_cplane(zeta, dev), n), self.omega_pows),
                _bcast(_cplane(n, dev), n))
            w = f2.mont_mul(f2.mont_mul(f2.batch_inv(den), self.omega_pows),
                            _bcast(_cplane(zh, dev), n))
            self._bary = {key: w}
        return w

    @staticmethod
    def _download_scalars(outs: torch.Tensor, count: int) -> list:
        """(m, 22) dot results → host ints."""
        host = download_std(outs)
        return [int.from_bytes(host[i].tobytes(), "little")
                for i in range(count)]

    def eval_at_many(self, evals_list: list, zeta: int) -> list:
        """[pᵢ(ζ)] from natural-order eval arrays (deg pᵢ < n)."""
        w = self.barycentric_weights(zeta)
        return self._download_scalars(_dots(w, evals_list), len(evals_list))

    def eval_at(self, evals_nat: torch.Tensor, zeta: int) -> int:
        return self.eval_at_many([evals_nat], zeta)[0]

    def eval_coeffs_at_many(self, coeffs_list: list, zeta: int) -> list:
        """[pᵢ(ζ)] from device-resident COEFFICIENT arrays: a ζ-power
        dot Σ cᵢ·ζⁱ — the same exact result as the barycentric path,
        with no H-domain eval array resident."""
        zp = powers_vector(zeta, self.n, self.device)
        return self._download_scalars(_dots(zp, coeffs_list),
                                      len(coeffs_list))
