"""The ConvergeBackend seam on torch: the counterpart of
``protocol_tpu/backend.py``.

Every backend consumes the *filtered* opinion matrix (or, at scale, the
raw edge list that ``graph.filter_edges`` filters with identical
semantics) and returns real-valued scores as numpy, in node order:

- ``NativeRationalBackend``: exact rational arithmetic, the oracle;
- ``TorchDenseBackend``: ``s ← s @ C``;
- ``TorchSparseBackend``: the bucketed-ELL gather SpMV;
- ``TorchRoutedBackend``: the Clos-routed SpMV, whose lane permutations
  run the hand-written CUDA kernel on the card.

The torch backends run on ``cuda`` unless constructed with
``device="cpu"``; with no device given and no GPU they raise. Every
converge runs through ``ops.converge.timed_converge``, so it reports the
``ptpu_converge_*`` instruments under ``backend`` ``torch-sparse`` or
``torch-routed``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from fractions import Fraction
from typing import Sequence

import numpy as np
import torch

from .device import resolve_device


class ConvergeBackend(ABC):
    """Strategy interface for the real-valued convergence computation."""

    @abstractmethod
    def converge(
        self,
        matrix: Sequence[Sequence[float]],
        initial_score: float,
        num_iterations: int,
    ) -> np.ndarray:
        """Run the power iteration on a filtered opinion matrix."""


class NativeRationalBackend(ConvergeBackend):
    """Exact rational arithmetic — the correctness oracle."""

    def converge(self, matrix, initial_score, num_iterations):
        exact = self.converge_exact(matrix, initial_score, num_iterations)
        return np.array([float(x) for x in exact])

    def converge_exact(self, matrix, initial_score, num_iterations):
        """Same, returning the Fractions. Float entries are lifted exactly
        via ``Fraction(v)``; expects a *filtered* opinion matrix (zero row
        ⇔ empty slot that receives no trust)."""
        n = len(matrix)
        norm = []
        for row in matrix:
            row_sum = sum(Fraction(v) for v in row) or Fraction(1)
            norm.append([Fraction(v) / row_sum for v in row])
        s = [Fraction(initial_score)] * n
        for _ in range(num_iterations):
            s = [sum(norm[j][i] * s[j] for j in range(n)) for i in range(n)]
        return s


class _TorchBackend(ConvergeBackend):
    def __init__(self, dtype=None, device=None):
        self.dtype = dtype or torch.float32
        self.device = resolve_device(device)


class TorchDenseBackend(_TorchBackend):
    """Dense power iteration: one matvec per step. Right for
    fully-connected sets up to a few thousand peers."""

    def converge(self, matrix, initial_score, num_iterations):
        from .graph import dense_normalized
        from .ops.converge import converge_dense_fixed

        m = np.asarray(matrix, dtype=np.float64)
        c = torch.as_tensor(dense_normalized(m), dtype=self.dtype,
                            device=self.device)
        has_row = torch.as_tensor(m.sum(axis=1) > 0, device=self.device)
        s0 = has_row.to(self.dtype) * float(initial_score)
        return converge_dense_fixed(c, s0, num_iterations).cpu().numpy()


class TorchSparseBackend(_TorchBackend):
    """Bucketed-ELL gather-SpMV power iteration. Accepts a dense filtered
    matrix through the common interface; large graphs use
    :meth:`converge_edges` with raw edge arrays."""

    def converge(self, matrix, initial_score, num_iterations):
        m = np.asarray(matrix, dtype=np.float64)
        src, dst = np.nonzero(m)
        # a zero-row peer that still receives trust would be read
        # differently by the edge path than by the dense/rational twins:
        # reject rather than silently diverge
        valid = m.sum(axis=1) > 0
        receives = m.sum(axis=0) > 0
        bad = np.nonzero(~valid & receives)[0]
        if len(bad):
            raise ValueError(
                f"matrix is not filtered: zero-row peers {bad.tolist()} still "
                "receive trust; run it through EigenTrustSet.filter_peers_ops "
                "or use converge_edges with an explicit valid mask"
            )
        return self.converge_edges(
            m.shape[0], src, dst, m[src, dst], valid, initial_score,
            num_iterations)

    def converge_edges(
        self, n, src, dst, val, valid, initial_score, num_iterations, tol=None,
        alpha: float = 0.0, s0=None, semiring=None,
    ):
        """Fixed mode (``tol=None``) returns node-order scores; adaptive
        mode returns ``(scores, iterations, delta)``. ``s0`` (node order)
        warm-starts the iteration; ``semiring`` selects the algebra
        (``ops.converge.SEMIRINGS`` name or a ``Semiring``)."""
        from .graph import build_operator
        from .ops.converge import (
            converge_sparse_adaptive_semiring,
            converge_sparse_fixed_semiring,
            operator_arrays,
            resolve_semiring,
            timed_converge,
        )

        sr = resolve_semiring(semiring)
        op = build_operator(n, src, dst, val, valid)
        arrs = operator_arrays(op, dtype=self.dtype, alpha=alpha,
                               device=self.device)
        if s0 is None:
            s0 = torch.as_tensor(op.valid, device=self.device).to(
                self.dtype) * float(initial_score)
        else:
            s0 = torch.as_tensor(np.asarray(s0), device=self.device).to(
                self.dtype)
        if tol is None:
            scores = timed_converge(
                "torch-sparse", n, len(src),
                lambda: converge_sparse_fixed_semiring(arrs, s0, sr,
                                                       num_iterations),
                fixed_iterations=num_iterations, semiring=sr.name)
            return scores.cpu().numpy()
        scores, iters, delta = timed_converge(
            "torch-sparse", n, len(src),
            lambda: converge_sparse_adaptive_semiring(
                arrs, s0, sr, tol=tol, max_iterations=num_iterations),
            semiring=sr.name)
        return scores.cpu().numpy(), int(iters), float(delta)

    def converge_topics(
        self, n, src, dst, val, valid, s0_topics, max_iterations,
        tol=1e-6, alpha: float = 0.0, semiring=None,
    ):
        """Topic-batched adaptive converge: the K node-order topic
        vectors ``s0_topics[K, n]`` through one operator, each topic's
        trajectory independent. Returns
        ``(scores[K, n], iters[K], delta[K])`` as numpy."""
        from .graph import build_operator
        from .ops.converge import (
            converge_sparse_topics,
            operator_arrays,
            resolve_semiring,
            timed_converge,
        )

        sr = resolve_semiring(semiring)
        s0k = _topic_starts(s0_topics, n)
        op = build_operator(n, src, dst, val, valid)
        arrs = operator_arrays(op, dtype=self.dtype, alpha=alpha,
                               device=self.device)
        s0k = torch.as_tensor(s0k, device=self.device).to(self.dtype)
        scores, iters, delta = timed_converge(
            "torch-sparse", n, len(src),
            lambda: converge_sparse_topics(arrs, s0k, sr, tol=tol,
                                           max_iterations=max_iterations),
            semiring=sr.name)
        return scores.cpu().numpy(), iters, delta


class TorchRoutedBackend(TorchSparseBackend):
    """Clos-routed SpMV power iteration (``ops/routed.py``): no general
    gather; the sparse transpose runs as a permutation network of lane
    shuffles. Same converge semantics as :class:`TorchSparseBackend`;
    pays a one-time host routing compilation per graph, reusable through
    ``RoutedOperator.save``/``load`` (``operator=``)."""

    def converge_edges(
        self, n, src, dst, val, valid, initial_score, num_iterations, tol=None,
        alpha: float = 0.0, operator=None, s0=None, semiring=None,
    ):
        from .ops.converge import resolve_semiring, timed_converge
        from .ops.routed import (
            build_routed_operator,
            converge_routed_adaptive_semiring,
            converge_routed_fixed_semiring,
            routed_arrays,
        )

        sr = resolve_semiring(semiring)
        op = operator
        if op is None:
            op = build_routed_operator(n, src, dst, val, valid)
        arrs, static = routed_arrays(op, dtype=self.dtype, alpha=alpha,
                                     device=self.device)
        np_dtype = torch.empty(0, dtype=self.dtype).numpy().dtype
        if s0 is None:
            start = op.initial_scores(initial_score, dtype=np_dtype)
        else:  # node-order warm start → state-slot order
            start = op.scores_from_nodes(np.asarray(s0), dtype=np_dtype)
        s0 = torch.from_numpy(start).to(self.device)
        if tol is None:
            scores = timed_converge(
                "torch-routed", n, int(op.nnz),
                lambda: converge_routed_fixed_semiring(arrs, static, s0, sr,
                                                       num_iterations),
                fixed_iterations=num_iterations, semiring=sr.name)
            return op.scores_for_nodes(scores.cpu().numpy())
        scores, iters, delta = timed_converge(
            "torch-routed", n, int(op.nnz),
            lambda: converge_routed_adaptive_semiring(
                arrs, static, s0, sr, tol=tol,
                max_iterations=num_iterations),
            semiring=sr.name)
        return (op.scores_for_nodes(scores.cpu().numpy()), int(iters),
                float(delta))

    def converge_topics(
        self, n, src, dst, val, valid, s0_topics, max_iterations,
        tol=1e-6, alpha: float = 0.0, operator=None, semiring=None,
    ):
        """Routed topic batch: K node-order topic vectors through one
        routed operator, so one routing-plan build serves all K topics
        and each route stage is one launch for the batch. Returns
        ``(scores[K, n], iters[K], delta[K])`` as numpy."""
        from .ops.converge import resolve_semiring, timed_converge
        from .ops.routed import (
            build_routed_operator,
            converge_routed_topics,
            routed_arrays,
        )

        sr = resolve_semiring(semiring)
        s0k = _topic_starts(s0_topics, n)
        op = operator
        if op is None:
            op = build_routed_operator(n, src, dst, val, valid)
        arrs, static = routed_arrays(op, dtype=self.dtype, alpha=alpha,
                                     device=self.device)
        np_dtype = torch.empty(0, dtype=self.dtype).numpy().dtype
        s0k = torch.from_numpy(np.stack(
            [op.scores_from_nodes(row, dtype=np_dtype) for row in s0k])
        ).to(self.device)
        scores, iters, delta = timed_converge(
            "torch-routed", n, int(op.nnz),
            lambda: converge_routed_topics(arrs, static, s0k, sr, tol=tol,
                                           max_iterations=max_iterations),
            semiring=sr.name)
        return (np.stack([op.scores_for_nodes(row)
                          for row in scores.cpu().numpy()]), iters, delta)


def _topic_starts(s0_topics, n: int) -> np.ndarray:
    s0k = np.asarray(s0_topics, dtype=np.float64)
    if s0k.ndim != 2 or s0k.shape[1] != n:
        raise ValueError(f"s0_topics must be [K, {n}] (got {s0k.shape})")
    return s0k
