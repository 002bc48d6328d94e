"""EigenTrust converge core on torch: the counterpart of
``protocol_tpu/ops/converge.py``.

- the semiring seam (``Semiring``, ``PLUSMUL``, ``MAXPLUS``);
- the shared sweep tail ``dangling_and_damping`` and the shared
  adaptive loop ``adaptive_loop``;
- the gather path: bucketed-ELL ``spmv`` over the operator from
  ``protocol_tpu_torch.graph.build_operator``. On the card it is plain
  torch indexing, the in-package yardstick for the routed path;
- the dense path: ``s ← s @ C``;
- the instrument seam every backend reports through
  (``record_converge_stats``, ``record_refresh_scope``,
  ``timed_converge``), with the reference's instrument names and labels;
- the topic batch (``converge_sparse_topics``, ``adaptive_loop_topics``):
  K score vectors ``[K, n]`` through one operator;
- ``partial_sweep_device``: one frontier-restricted sweep, the device
  half of the refresh ladder (``incremental.device``).

PyTorch runs eagerly, so the reference's ``fori_loop``/``while_loop``
become Python loops. The adaptive loop reads one scalar (the stopping
delta) back to the host per sweep. The sweep functions take a score
vector ``[n]`` or a batch ``[K, n]``: every reduction runs over the last
axis, so each row of a batch is an independent vector.
"""

from __future__ import annotations

import math
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..graph import EllOperator
from ..utils import trace


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


def record_converge_stats(backend: str, iters: int, delta, seconds: float,
                          n: int | None = None,
                          semiring: str = "plusmul") -> None:
    """Shared converge observability: every backend reports its exit
    through this one seam, labelled ``{backend, semiring}``. Emits

    - ``ptpu_converge_iterations{backend,semiring}``: the iterations the
      power method ran;
    - ``ptpu_converge_residual{backend,semiring}``: the final relative-L1
      delta (adaptive runs only; fixed-iteration runs pass
      ``delta=None``);
    - ``ptpu_converge_sweep_seconds{backend,semiring}``: mean wall time
      per sweep, total/iters.
    """
    iters = int(iters)
    trace.gauge("converge_iterations").set(iters, backend=backend,
                                           semiring=semiring)
    if delta is not None:
        trace.gauge("converge_residual").set(float(delta), backend=backend,
                                             semiring=semiring)
    if iters > 0:
        trace.histogram("converge_sweep_seconds").observe(
            seconds / iters, backend=backend, semiring=semiring)
    trace.event("converge.done", backend=backend, iterations=iters,
                semiring=semiring, seconds=round(seconds, 6),
                **({} if n is None else {"n": n}),
                **({} if delta is None else {"residual": float(delta)}))


def record_refresh_scope(mode: str) -> None:
    """The one seam that says how a refresh swept the graph, on the
    ladder ``partial → device_partial → sampled → full → rebuild``
    (``incremental.ladder_refresh`` serves the first three, a full
    patched-operator converge the fourth, a fresh operator build the
    last). Emits ``ptpu_refresh_sweep_scope_total{mode}``."""
    trace.counter("refresh_sweep_scope").inc(mode=mode)
    trace.event("refresh.sweep_scope", mode=mode)


def _sync_cuda(out) -> None:
    """Wait for the CUDA work behind a converge's result: the tensors in
    ``out`` (a tensor or a tuple of tensors and numbers)."""
    for x in out if isinstance(out, tuple) else (out,):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)


def timed_converge(backend: str, n: int, edges: int, call,
                   fixed_iterations: int | None = None,
                   semiring: str = "plusmul"):
    """The one instrumentation wrapper every backend runs its converge
    through: executes ``call`` under the ``converge.edges`` span and
    synchronises the result's CUDA device before the span closes —
    torch returns at launch, so an unsynchronised wall time would record
    the launches, not the sweeps. (The reference's ``signature`` and
    compile watch have nothing to watch on torch: nothing compiles.)

    ``call`` returns ``scores`` in fixed-iteration mode (pass
    ``fixed_iterations``) or ``(scores, iters, delta)`` in adaptive
    mode, where a topic batch gives per-topic ``iters``/``delta``: the
    recorded count and residual are then the worst topic's. Returns
    ``call``'s result unchanged."""
    t0 = time.perf_counter()
    with trace.span("converge.edges", backend=backend, n=n, edges=edges):
        out = call()
        _sync_cuda(out)
    dt = time.perf_counter() - t0
    if fixed_iterations is not None:
        record_converge_stats(backend, fixed_iterations, None, dt, n=n,
                              semiring=semiring)
    else:
        _, iters, delta = out
        record_converge_stats(backend, int(np.max(np.asarray(iters))),
                              float(np.max(np.asarray(delta))), dt, n=n,
                              semiring=semiring)
    return out


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
    conserved for any α. ``s`` and ``base`` are ``[n]`` or ``[K, n]``;
    the masses are taken per row."""
    d_mass = torch.sum(s * arrs["dangling"], dim=-1, keepdim=True)
    denom = torch.clamp(arrs["n_valid"] - 1.0, min=1.0)
    corr = (d_mass - arrs["dangling"] * s) / denom
    propagated = base + corr * arrs["valid"]

    alpha = arrs["alpha"]
    total = torch.sum(s * arrs["valid"], dim=-1, keepdim=True)
    return (1.0 - alpha) * propagated + alpha * arrs["pretrust"] * total


def spmv_base(arrs: dict, s: torch.Tensor) -> torch.Tensor:
    """The propagated scores of the gather path, before the sweep's
    tail: per bucket gather source scores, weight, reduce along the
    width; concatenate (plus a zero slot for in-degree-0 rows) and
    restore row order. ``s`` holds every source row the buckets index
    (the sharded sweep passes the all-gathered vector, and gets its own
    rows back)."""
    parts = [(val * s[..., idx]).sum(dim=-1)
             for idx, val in zip(arrs["bucket_idx"], arrs["bucket_val"])]
    parts.append(s.new_zeros(s.shape[:-1] + (1,)))
    return torch.cat(parts, dim=-1)[..., arrs["row_pos"]]


def spmv(arrs: dict, s: torch.Tensor) -> torch.Tensor:
    """One application of the normalized trust operator (gather path):
    :func:`spmv_base`, then the dangling correction and damping."""
    return dangling_and_damping(arrs, s, spmv_base(arrs, s))


def spmv_semiring(arrs: dict, s: torch.Tensor, sr: Semiring) -> torch.Tensor:
    """One generalized gather sweep: ``new_s[i] = add_j mul(w_ji, s[j])``
    plus the semiring tail. Pad lanes carry idx 0 and weight 0, so
    ``mul`` yields ``sr.zero`` on them."""
    parts = [sr.reduce(sr.mul(val, s[..., idx]), dim=-1)
             for idx, val in zip(arrs["bucket_idx"], arrs["bucket_val"])]
    parts.append(s.new_full(s.shape[:-1] + (1,), sr.zero))
    base = torch.cat(parts, dim=-1)[..., arrs["row_pos"]]
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


def adaptive_loop_topics(step, s0k: torch.Tensor, tol: float,
                         max_iterations: int):
    """:func:`adaptive_loop` for a batch of K independent vectors
    ``s0k[K, n]`` through one ``step``: each topic keeps its own norm,
    delta and iteration count, and a topic whose delta reached ``tol``
    (or whose count reached ``max_iterations``) is frozen while the
    others sweep on, so its trajectory and count are those of its own
    converge (the reference's ``vmap`` of the while loop select-masks
    the same way). Returns ``(scores[K, n], iters[K], delta[K])``, the
    last two as numpy arrays (K deltas are read back per sweep)."""
    k = s0k.shape[0]
    norm = torch.clamp(torch.sum(torch.abs(s0k), dim=-1), min=1.0)
    tol = float(torch.tensor(tol, dtype=s0k.dtype))
    s = s0k
    iters = np.zeros(k, dtype=np.int64)
    delta = np.full(k, math.inf)
    active = np.ones(k, dtype=bool)
    while active.any():
        s_next = step(s)
        d = torch.sum(torch.abs(s_next - s), dim=-1) / norm
        delta = np.where(active, d.cpu().numpy(), delta)
        live = torch.from_numpy(active).to(s.device).unsqueeze(-1)
        s = torch.where(live, s_next, s)
        iters += active
        active &= (delta > tol) & (iters < max_iterations)
    return s, iters, delta


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


def converge_sparse_topics(arrs: dict, s0k, sr: Semiring, tol: float = 1e-6,
                           max_iterations: int = 100):
    """Topic-batched adaptive converge: K topic vectors ``s0k[K, n]``
    through one gather operator, each topic's trajectory independent
    (:func:`adaptive_loop_topics`). Returns
    ``(scores[K, n], iters[K], delta[K])``."""
    return adaptive_loop_topics(lambda s: spmv_semiring(arrs, s, sr), s0k,
                                tol, max_iterations)


def scatter_sum(values: torch.Tensor, index: torch.Tensor,
                size: int) -> torch.Tensor:
    """``out[i] = Σ values[k] over index[k] == i``, added in one order on
    every run: on the CPU ``index_add_`` adds serially in ``index``
    order; on CUDA ``index_put_(accumulate=True)`` sorts the terms by
    index and adds each slot's terms in one thread. (``index_add_``'s
    CUDA float atomics, and ``index_put_``'s threaded CPU path past
    32,768 terms, add in an order that changes from run to run.)"""
    out = values.new_zeros(size)
    if values.is_cuda:
        return out.index_put_((index,), values, accumulate=True)
    return out.index_add_(0, index, values)


def partial_sweep_device(s, f_idx, f_valid, f_dang, f_ext, e_row, e_src,
                         e_w, scal):
    """One frontier-restricted power-iteration sweep on the device, the
    segment-gather step behind ``incremental.device``: the update of a
    frontier row set only, from its gathered in-edge segments
    (``e_src[k]``/``e_w[k]`` is the k-th in-edge, source node and true
    normalized weight, of frontier row ``e_row[k]``). One gather, two
    segment sums and an elementwise tail: O(frontier fan-in) work
    instead of O(E).

    The dangling-mass shift stays the host scalar that the host twin
    (``incremental/partial.py``) tracks; ``scal`` packs the per-sweep
    host scalars ``[uni, uni_next, d_now, denom, keep, alpha, n_valid,
    total]``.

    The segment sums are :func:`scatter_sum`s (``e_row`` is not sorted:
    tail in-edges follow the built ones and appends start new runs), so
    a rerun gives the same bits. The card adds in another order than the
    host twin, so the two agree to rounding, not bit for bit.

    Returns ``(s2, changed, l1, d_delta, vsum, negl)``: ``s2`` is ``s``
    with the frontier rows updated (in place: the store representation
    true = s + uni·valid), ``changed`` the per-row true-value delta,
    ``l1`` = Σ|changed|, ``d_delta`` the dangling-mass delta of the
    store update, ``vsum`` = Σ valid over the frontier and ``negl`` =
    Σ|changed|·f_ext, the sampled mode's neglected-propagation bound
    (``f_ext`` is zero in the partial mode). The four sums are 0-d
    tensors."""
    uni, uni_next, d_now, denom, keep, alpha, n_valid, total = scal.unbind()
    nf = f_idx.shape[0]
    base = scatter_sum(e_w * s[e_src], e_row, nf)
    in_wsum = scatter_sum(e_w, e_row, nf)
    s_f = s[f_idx]
    base_true = base + uni * in_wsum
    s_true = s_f + uni * f_valid
    corr = (d_now - f_dang * s_true) / denom
    new_true = base_true + corr * f_valid
    # alpha == 0 => keep == 1 and the pretrust term vanishes: the damped
    # form is then exactly the undamped update
    new_true = keep * new_true + alpha * (
        f_valid / torch.clamp(n_valid, min=1.0)) * total
    changed = new_true - s_true
    new_store = new_true - uni_next * f_valid
    s.index_put_((f_idx,), new_store)
    l1 = torch.sum(torch.abs(changed))
    d_delta = torch.sum(f_dang * (new_store - s_f))
    vsum = torch.sum(f_valid)
    negl = torch.sum(torch.abs(changed) * f_ext)
    return s, changed, l1, d_delta, vsum, negl


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
