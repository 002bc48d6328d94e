"""Robustness outcomes of one adversarial scenario run.

All metrics are pure numpy over (scores, attacker mask) — no backend
or device dependency, so the same functions score a live daemon's
served table (the smoke's scenario phase) and a batch run (the CLI /
bench scripts).
"""

from __future__ import annotations

import math

import numpy as np


def attacker_mass_capture(scores, attacker) -> float:
    """Fraction of the total score mass held by attacker peers — the
    headline sybil-resistance number (0 = none captured)."""
    scores = np.asarray(scores, dtype=np.float64)
    attacker = np.asarray(attacker, dtype=bool)
    total = float(scores.sum())
    if total <= 0.0:
        return 0.0
    return float(scores[attacker].sum()) / total


def rank_displacement(baseline_scores, scores, honest) -> dict:
    """How far the attack moved honest peers in the ranking.

    Both vectors are ranked descending (stable: ties break by peer id,
    so the metric is deterministic), then compared ONLY on the honest
    peers, by their rank among honest peers — attacker rows squeezing
    into the global order is what `attacker_mass_capture` measures;
    this isolates the reordering damage among the honest population.
    Returns mean/max absolute displacement and the fraction of honest
    peers displaced at all."""
    honest = np.asarray(honest, dtype=bool)
    b = np.asarray(baseline_scores, dtype=np.float64)
    a = np.asarray(scores, dtype=np.float64)
    if b.shape != a.shape or b.shape != honest.shape:
        raise ValueError("baseline/attack score vectors disagree on "
                         "the honest population")
    b, a = b[honest], a[honest]
    # rank of each honest peer = position in the stable descending sort
    def ranks(v):
        order = np.argsort(-v, kind="stable")
        r = np.empty(len(v), dtype=np.int64)
        r[order] = np.arange(len(v))
        return r

    shift = np.abs(ranks(a) - ranks(b))
    return {
        "mean": float(shift.mean()) if len(shift) else 0.0,
        "max": int(shift.max()) if len(shift) else 0,
        "moved_fraction": float((shift > 0).mean()) if len(shift) else 0.0,
    }


def attackers_in_top(scores, attacker, top: int = 100) -> int:
    """Attacker peers inside the global top-``top`` ranks (stable
    descending order) — the 'did a sybil reach the leaderboard'
    check."""
    scores = np.asarray(scores, dtype=np.float64)
    attacker = np.asarray(attacker, dtype=bool)
    order = np.argsort(-scores, kind="stable")[:min(top, len(scores))]
    return int(attacker[order].sum())


def iteration_bound(alpha: float, tol: float) -> int | None:
    """Predicted adaptive-iteration count from the damped-convergence
    bound: with pre-trust mixing ``alpha``, the iteration contracts
    geometrically at rate (1 - alpha), so the relative-L1 stop at
    ``tol`` is reached within ``ceil(ln tol / ln(1 - alpha))`` sweeps
    regardless of graph spectrum. ``alpha == 0`` has no spectrum-free
    bound — returns None (the report then records the measured count
    uncompared)."""
    if alpha <= 0.0 or alpha >= 1.0 or tol <= 0.0 or tol >= 1.0:
        return None
    return int(math.ceil(math.log(tol) / math.log(1.0 - alpha)))


def robustness_report(scores, baseline_scores, attacker,
                      iterations: int, alpha: float, tol: float,
                      top: int = 100) -> dict:
    """The full robustness block of one scenario run (deterministic:
    pure functions of the inputs)."""
    attacker = np.asarray(attacker, dtype=bool)
    bound = iteration_bound(alpha, tol)
    return {
        "attacker_mass_capture": attacker_mass_capture(scores, attacker),
        "baseline_attacker_mass": attacker_mass_capture(baseline_scores,
                                                        attacker),
        "honest_rank_displacement": rank_displacement(
            baseline_scores, scores, ~attacker),
        "attackers_in_top": {"top": top,
                             "count": attackers_in_top(scores, attacker,
                                                       top)},
        "iterations": int(iterations),
        "iteration_bound": bound,
        "within_bound": (None if bound is None
                         else bool(int(iterations) <= bound)),
    }
