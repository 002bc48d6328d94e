"""BN254 Fr NTT on the card: the four-step matmul form, the counterpart
of ``protocol_tpu/ops/ntt_tpu.py``.

    X[k1 + k2·A] = Σ_{j2} ω^{A·j2·k2} · ( ω^{j2·k1} ·
                   Σ_{j1} ω^{B·j1·k1} · x[j1·B + j2] ),   N = A·B

Both inner sums are length-≤2048 NTTs applied to every row or column at
once: field matmuls by the stage matrices W_A (A×A) and W_B (B×B). A
field matmul splits both operands into 44 six-bit int8 planes
(``fieldops2.to_planes``) and runs one integer matmul per plane of W:
``torch._int_mm`` (int8 × int8 → int32 on the tensor cores) on the card.
It is exact: a 6-bit × 6-bit product summed over ≤ 2^11 terms stays
below 2^23, and the ≤ 44 products that land on one output plane below
2^31. ``fieldops2.reduce_planes`` folds the 87 output planes back to
canonical rows mod p. The data stay in B2's Montgomery domain and the W
planes are plain values, so a stage maps Montgomery rows to Montgomery
rows with no extra R factor; the cross twiddle between the stages is one
B2 ``mont_mul``.

The plain version of the stage product, on a CPU tensor, is a float64
matmul of the same planes: exact (every sum below 2^53) and backed by a
BLAS on either device, so the same function can be timed on the card
beside ``_int_mm``. A wrapper on a CUDA tensor runs ``_int_mm`` and never
the plain version.

Layout: the forward output (and the inverse's input) is the reference's
"FS layout": element X[k1 + k2·A] lives at flat position k1·B + k2.
Pointwise consumers (the quotient) never notice; ``intt`` maps it back
to natural coefficient order. The 4n extension of the prover runs as 4
size-n coset NTTs on one plan (``zk/prover_tpu.py``).
"""

from __future__ import annotations

import torch

from ..utils.fields import BN254_FR_MODULUS as P
from . import fieldops2 as f2

L, L6 = f2.L, f2.L6

# calls of the stage product on the card since the last reset: each is
# one ``torch._int_mm`` (44 a stage, 88 an NTT)
LAUNCHES = {"stage_matmul": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _root_of_unity(k: int) -> int:
    """Primitive 2^k-th root of unity in Fr (matches zk/domain.py)."""
    g = pow(5, (P - 1) >> 28, P)  # 2-adicity 28
    return pow(g, 1 << (28 - k), P)


def stage_matmul_plain(lhs: torch.Tensor, rhs_t: torch.Tensor
                       ) -> torch.Tensor:
    """out[i, o] = Σ_c lhs[i, c] · rhs_t[o, c] on int8 planes, as an
    exact float64 matmul → int32."""
    return (lhs.double() @ rhs_t.double().t()).to(torch.int32)


def stage_matmul(lhs: torch.Tensor, rhs_t: torch.Tensor) -> torch.Tensor:
    """out[i, o] = Σ_c lhs[i, c] · rhs_t[o, c]: int8 (M, C) and (O, C),
    both contiguous with the contracted axis last → int32 (M, O).
    ``torch._int_mm`` on a CUDA tensor (the contracted axis contiguous
    in both operands is the form cuBLASLt's int8 GEMM takes on every
    card), the plain version on a CPU tensor."""
    if lhs.device.type == "cpu":
        return stage_matmul_plain(lhs, rhs_t)
    if lhs.device.type != "cuda":
        raise ValueError(f"stage_matmul: unsupported device {lhs.device}")
    # the int8 GEMM takes a contracted length and an output width that
    # are multiples of 8: zero columns add nothing to a sum (a shard of
    # a sharded stage may contract fewer, parallel/ntt.py)
    o = rhs_t.shape[0]
    pad_c, pad_o = -lhs.shape[1] % 8, -o % 8
    if pad_c or pad_o:
        lhs = torch.nn.functional.pad(lhs, (0, pad_c))
        rhs_t = torch.nn.functional.pad(rhs_t, (0, pad_c, 0, pad_o))
    out = torch._int_mm(lhs, rhs_t.t())
    LAUNCHES["stage_matmul"] += 1
    return out[:, :o].contiguous() if pad_o else out


def stage_accum(x: torch.Tensor, d0: int, d1: int, axis: int,
                w_planes: torch.Tensor, matmul=stage_matmul
                ) -> torch.Tensor:
    """The exact lazy accumulator of one stage: x is (d0·d1, 22)
    canonical rows of a d0 × d1 matrix (row-major), contracted on its
    ``axis`` with the plain matrix W (``w_planes``: (44, S, C) int8,
    W[out, in], C the contracted length). Returns the (87, other, S)
    int32 base-2^6 planes of the products, other = d1 for axis 0 and
    d0 for axis 1. Accumulators over disjoint slices of the contracted
    axis add up, as integers, to the whole one (``parallel/ntt.py``)."""
    x6 = f2.to_planes(x.reshape(d0, d1, L))          # (d0, d1, 44)
    if axis == 0:
        lhs = x6.permute(2, 1, 0).contiguous()        # (44, d1, d0)
        other, c = d1, d0
    else:
        lhs = x6.permute(2, 0, 1).contiguous()        # (44, d0, d1)
        other, c = d0, d1
    lhs = lhs.reshape(L6 * other, c)
    s = w_planes.shape[1]
    acc = torch.zeros(2 * L6 - 1, other, s, dtype=torch.int32,
                      device=x.device)
    for m in range(L6):
        acc[m : m + L6] += matmul(lhs, w_planes[m]).view(L6, other, s)
    return acc


def field_stage(x: torch.Tensor, d0: int, d1: int, axis: int,
                w_planes: torch.Tensor, matmul=stage_matmul
                ) -> torch.Tensor:
    """One stage of the four-step form: :func:`stage_accum` with the
    square (44, S, S) W, folded to canonical rows. Returns (S·d1, 22)
    rows in (out, i1) order for axis 0, (d0·S) rows in (i0, out) order
    for axis 1."""
    acc = stage_accum(x, d0, d1, axis, w_planes, matmul)
    # acc[·, other, out]: axis 0 wants (out, other) rows, axis 1 (other, out)
    return f2.reduce_planes(acc, transpose=(axis == 0))


class NttPlan:
    """Per-(k, device) tables: the stage matrices W_A, W_B as (44, S, S)
    int8 plain planes, their inverses (roots ω⁻¹), and the cross
    twiddles T[k1, j2] = ω^{k1·j2} (and ω^{−k1·j2}) as (n, 22)
    Montgomery rows in (k1, j2) order. Built on the device from the
    host's generators."""

    _cache: dict = {}

    def __init__(self, k: int, device):
        self.k = k
        self.n = 1 << k
        self.device = torch.device(device)
        a = (k + 1) // 2
        self.A, self.B = 1 << a, 1 << (k - a)
        omega = _root_of_unity(k)
        self.omega = omega
        w_a = pow(omega, self.B, P)   # order A
        w_b = pow(omega, self.A, P)   # order B
        self.W_A = self._build_w(w_a, self.A)
        self.W_B = self._build_w(w_b, self.B)
        self.W_A_inv = self._build_w(pow(w_a, -1, P), self.A)
        self.W_B_inv = self._build_w(pow(w_b, -1, P), self.B)
        self.T = self._build_t(omega)
        self.T_inv = self._build_t(pow(omega, -1, P))
        self.n_inv_mont = f2.mont(pow(self.n, -1, P))

    @classmethod
    def get(cls, k: int, device) -> "NttPlan":
        key = (k, torch.device(device))
        plan = cls._cache.get(key)
        if plan is None:
            plan = cls._cache[key] = cls(k, device)
        return plan

    def _build_w(self, root: int, size: int) -> torch.Tensor:
        """(44, size, size) int8 plain planes of W[r, c] = root^{r·c}."""
        gens = [pow(root, r, P) for r in range(size)]
        plain = f2.exit_mont(f2.powers_matrix(gens, size, self.device))
        return f2.to_planes(plain).reshape(size, size, L6).permute(
            2, 0, 1).contiguous()

    def _build_t(self, root: int) -> torch.Tensor:
        """(A·B, 22) Montgomery rows of T[k1, j2] = root^{k1·j2}."""
        gens = [pow(root, k1, P) for k1 in range(self.A)]
        return f2.powers_matrix(gens, self.B, self.device)


def ntt(x: torch.Tensor, plan: NttPlan, matmul=stage_matmul
        ) -> torch.Tensor:
    """Forward NTT: (n, 22) Montgomery rows, natural order → FS layout
    (element X[k1 + k2·A] at row k1·B + k2)."""
    A, B = plan.A, plan.B
    y = field_stage(x, A, B, 0, plan.W_A, matmul)      # rows (k1, j2)
    y = f2.mont_mul(y, plan.T)
    return field_stage(y, A, B, 1, plan.W_B, matmul)   # rows (k1, k2)


def intt(z: torch.Tensor, plan: NttPlan, matmul=stage_matmul
         ) -> torch.Tensor:
    """Inverse NTT: FS layout → natural coefficient order, scaled by
    n⁻¹."""
    A, B = plan.A, plan.B
    y = field_stage(z, A, B, 1, plan.W_B_inv, matmul)  # rows (k1, j2)
    y = f2.mont_mul(y, plan.T_inv)
    x = field_stage(y, A, B, 0, plan.W_A_inv, matmul)  # rows (j1, j2)
    return f2.mont_mul_const(x, plan.n_inv_mont)
