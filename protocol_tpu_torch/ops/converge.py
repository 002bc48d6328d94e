"""EigenTrust converge core on torch: the counterpart of
``protocol_tpu/ops/converge.py``.

- the semiring seam (``Semiring``, ``PLUSMUL``, ``MAXPLUS``);
- the shared sweep tail ``dangling_and_damping`` and the shared
  adaptive loop ``adaptive_loop``;
- the gather path: bucketed-ELL ``spmv`` over the operator from
  ``protocol_tpu_torch.graph.build_operator``. On the card it is plain
  torch indexing, the in-package yardstick for the routed path;
- the dense path: ``s ← s @ C``.

PyTorch runs eagerly, so the reference's ``fori_loop``/``while_loop``
become Python loops. The adaptive loop reads one scalar (the stopping
delta) back to the host per sweep.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..graph import EllOperator


class Semiring(NamedTuple):
    """The pluggable (add, mul) algebra of one converge sweep:
    ``new_s[i] = add_j mul(w_ji, s[j])`` over the same operator layouts.

    - ``add``: binary combiner;
    - ``mul``: edge-weight application to a source score;
    - ``reduce``: the axis form of ``add``, called as ``reduce(x, dim=d)``;
    - ``zero``: identity of ``add``, the value every pad lane yields. It
      is 0.0 for both shipped semirings, an identity for ``max`` only
      over NONNEGATIVE scores (the trust invariant ``s >= 0``).

    ``plusmul`` is classic EigenTrust; ``maxplus`` is bottleneck trust
    (``s[i] = max_j min(w_ji, s[j])``, no dangling redistribution or
    damping; invalid slots are masked to 0).
    """

    name: str
    add: Callable
    mul: Callable
    reduce: Callable
    zero: float


PLUSMUL = Semiring("plusmul", torch.add, torch.mul, torch.sum, 0.0)
MAXPLUS = Semiring("maxplus", torch.maximum, torch.minimum, torch.amax, 0.0)

SEMIRINGS = {"plusmul": PLUSMUL, "maxplus": MAXPLUS}


def resolve_semiring(semiring) -> Semiring:
    """``None`` / name / ``Semiring`` → ``Semiring`` (default (+,×))."""
    if semiring is None:
        return PLUSMUL
    if isinstance(semiring, Semiring):
        return semiring
    try:
        return SEMIRINGS[semiring]
    except KeyError:
        raise ValueError(
            f"unknown semiring {semiring!r} (have: "
            f"{sorted(SEMIRINGS)})") from None


def semiring_tail(sr: Semiring, arrs: dict, s, base):
    """Post-reduce tail of one sweep under ``sr``: (+,×) keeps the
    dangling-mass correction and damping; path algebras only mask
    invalid slots."""
    if sr.name == "plusmul":
        return dangling_and_damping(arrs, s, base)
    return base * arrs["valid"]


def warm_start_scores(prev, n: int, valid, initial_score: float):
    """Project a previous score vector onto a (possibly grown) peer set,
    rescaled to the cold-start mass ``n_valid * initial_score``. ``prev``
    covers the first ``len(prev)`` slots of the new id space; new peers
    start at ``initial_score``; invalid slots are zeroed. A degenerate
    carry-over (empty, or no mass on valid peers) returns the cold
    uniform start. Returns a float64 numpy vector."""
    valid = np.asarray(valid, dtype=bool)
    if valid.shape != (n,):
        raise ValueError(f"valid mask must have shape ({n},)")
    s = np.full(n, float(initial_score), dtype=np.float64)
    m = min(len(prev), n)
    carried = np.asarray(prev[:m], dtype=np.float64)
    if not len(carried) or float((carried * valid[:m]).sum()) <= 0.0:
        return valid.astype(np.float64) * float(initial_score)
    s[:m] = carried
    s *= valid
    target = float(valid.sum()) * float(initial_score)
    return s * (target / float(s.sum()))


def _scalar(v: float, dtype, device) -> torch.Tensor:
    return torch.tensor(float(v), dtype=dtype, device=device)


def operator_arrays(op: EllOperator, dtype=torch.float32, alpha: float = 0.0,
                    pretrust=None, device=None) -> dict:
    """Device tensors of an EllOperator. ``alpha``/``pretrust`` enable
    the damped iteration s ← (1-α)·(Cᵀs + dangling correction) + α·p·Σs;
    ``pretrust`` defaults to uniform over valid peers."""
    device = resolve_device(device)
    if pretrust is None:
        pretrust = op.valid.astype(np.float64) / max(op.n_valid, 1)

    def vec(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    return {
        "bucket_idx": tuple(vec(b, torch.int64) for b in op.bucket_idx),
        "bucket_val": tuple(vec(b) for b in op.bucket_val),
        "row_pos": vec(op.row_pos, torch.int64),
        "valid": vec(op.valid),
        "dangling": vec(op.dangling),
        "n_valid": _scalar(op.n_valid, dtype, device),
        "alpha": _scalar(alpha, dtype, device),
        "pretrust": vec(pretrust),
    }


def dangling_and_damping(arrs: dict, s: torch.Tensor, base: torch.Tensor
                         ) -> torch.Tensor:
    """Shared tail of every SpMV: dangling peers redistribute uniformly
    to every other valid peer (an implicit rank-1 update), then damped
    pre-trust mixing scaled by the current total mass, so Σs is
    conserved for any α."""
    d_mass = torch.sum(s * arrs["dangling"])
    denom = torch.clamp(arrs["n_valid"] - 1.0, min=1.0)
    corr = (d_mass - arrs["dangling"] * s) / denom
    propagated = base + corr * arrs["valid"]

    alpha = arrs["alpha"]
    total = torch.sum(s * arrs["valid"])
    return (1.0 - alpha) * propagated + alpha * arrs["pretrust"] * total


def spmv(arrs: dict, s: torch.Tensor) -> torch.Tensor:
    """One application of the normalized trust operator (gather path):
    per bucket gather source scores, weight, reduce along the width;
    concatenate (plus a zero slot for in-degree-0 rows) and restore row
    order."""
    parts = [(val * s[idx]).sum(dim=-1)
             for idx, val in zip(arrs["bucket_idx"], arrs["bucket_val"])]
    parts.append(s.new_zeros(1))
    base = torch.cat(parts)[arrs["row_pos"]]
    return dangling_and_damping(arrs, s, base)


def spmv_semiring(arrs: dict, s: torch.Tensor, sr: Semiring) -> torch.Tensor:
    """One generalized gather sweep: ``new_s[i] = add_j mul(w_ji, s[j])``
    plus the semiring tail. Pad lanes carry idx 0 and weight 0, so
    ``mul`` yields ``sr.zero`` on them."""
    parts = [sr.reduce(sr.mul(val, s[idx]), dim=-1)
             for idx, val in zip(arrs["bucket_idx"], arrs["bucket_val"])]
    parts.append(s.new_full((1,), sr.zero))
    base = torch.cat(parts)[arrs["row_pos"]]
    return semiring_tail(sr, arrs, s, base)


def adaptive_loop(step, s0: torch.Tensor, tol: float, max_iterations: int,
                  accel_every: int = 0):
    """Shared adaptive loop: iterate ``step`` until the relative L1
    delta ≤ tol (or max_iterations). Every backend runs this loop, so
    tolerance semantics and iteration counts agree between them.

    ``accel_every > 0`` applies the safeguarded rank-1 extrapolation
    every that many iterations: with consecutive differences Δ1, Δ2,
    r = ⟨Δ2,Δ1⟩/⟨Δ1,Δ1⟩ clamped to [0, 0.9] and s ← s + (r/(1−r))·Δ2.
    The jump is an affine combination of mass-conserving iterates, and
    the stopping delta is always the unextrapolated step's. No jump is
    taken on a stopping iteration.

    The delta is compared with ``tol`` rounded to the iterate's dtype,
    as the reference compares them on the device. Returns
    ``(scores, iterations_run, final_relative_delta)``, the last two as
    Python numbers (one scalar is read back per sweep).
    """
    if accel_every == 1:
        # d1 would span the previous jump, corrupting the ratio estimate
        raise ValueError("accel_every must be 0 (off) or >= 2")
    norm = torch.clamp(torch.sum(torch.abs(s0)), min=1.0)
    tol = float(torch.tensor(tol, dtype=s0.dtype))
    tiny = torch.finfo(s0.dtype).tiny
    s_prev, s, i, delta = s0, s0, 0, math.inf
    while delta > tol and i < max_iterations:
        s_next = step(s)
        delta = float(torch.sum(torch.abs(s_next - s)) / norm)
        if (accel_every and i % accel_every == accel_every - 1 and i >= 1
                and delta > tol and i + 1 < max_iterations):
            d1 = s - s_prev
            d2 = s_next - s
            r = torch.sum(d2 * d1) / torch.clamp(torch.sum(d1 * d1), min=tiny)
            r = torch.clamp(r, 0.0, 0.9)
            s_next = s_next + (r / (1.0 - r)) * d2
        s_prev, s, i = s, s_next, i + 1
    return s, i, delta


def converge_fixed(step, s0: torch.Tensor, num_iterations: int):
    """Apply ``step`` exactly ``num_iterations`` times (reference parity:
    the fixed-iteration mode)."""
    s = s0
    for _ in range(num_iterations):
        s = step(s)
    return s


def converge_sparse_fixed(arrs: dict, s0, num_iterations: int):
    """Reference-parity fixed-iteration power iteration, gather path."""
    return converge_fixed(lambda s: spmv(arrs, s), s0, num_iterations)


def converge_sparse_adaptive(arrs: dict, s0, tol: float = 1e-6,
                             max_iterations: int = 100, accel_every: int = 0):
    """Iterate until the relative L1 delta ≤ tol (or max_iterations).
    Returns (scores, iterations_run, final_relative_delta)."""
    return adaptive_loop(lambda s: spmv(arrs, s), s0, tol, max_iterations,
                         accel_every)


def converge_sparse_fixed_semiring(arrs: dict, s0, sr: Semiring,
                                   num_iterations: int):
    return converge_fixed(lambda s: spmv_semiring(arrs, s, sr), s0,
                          num_iterations)


def converge_sparse_adaptive_semiring(arrs: dict, s0, sr: Semiring,
                                      tol: float = 1e-6,
                                      max_iterations: int = 100,
                                      accel_every: int = 0):
    return adaptive_loop(lambda s: spmv_semiring(arrs, s, sr), s0, tol,
                         max_iterations, accel_every)


def _check_no_tf32(c: torch.Tensor) -> None:
    # TF32 keeps ~3 decimal digits: a float32 power iteration must run
    # its products in full float32 on the card
    if (c.is_cuda and c.dtype == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError("dense converge needs full float32 matmuls: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")


def converge_dense_fixed(c_norm: torch.Tensor, s0: torch.Tensor,
                         num_iterations: int):
    """Dense fixed-iteration twin: s ← s @ C (row-stochastic C), so
    new_s[i] = Σⱼ C[j,i]·s[j]."""
    _check_no_tf32(c_norm)
    return converge_fixed(lambda s: s @ c_norm, s0, num_iterations)


def converge_dense_adaptive(c_norm: torch.Tensor, s0: torch.Tensor,
                            tol: float = 1e-6, max_iterations: int = 100):
    _check_no_tf32(c_norm)
    return adaptive_loop(lambda s: s @ c_norm, s0, tol, max_iterations)
