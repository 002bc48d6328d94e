"""The plain reference against a graph worked by hand, and the
comparison that decides ``correct`` against wrong answers."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from perfbench.generators.ba import barabasi_albert_edges
from perfbench.reference.eigentrust import TrustGraph, compare, trust_edges

BENCH = Path(__file__).resolve().parents[1]
ALPHA = 0.1
INITIAL = 1000.0


def limits(cell: str) -> dict:
    return json.loads((BENCH / "workloads" / f"{cell}.json").read_text())[
        "limits"]


def hand_fixed_point(rows: dict, n: int, valid, alpha: float) -> np.ndarray:
    """The fixed point of the column-stochastic matrix written out
    entry by entry: row ``i`` of ``rows`` gives ``{j: value}``; a valid
    peer without a row gives ``1/(n_valid − 1)`` to every other valid
    peer; damping mixes in ``alpha`` of the uniform pre-trust. Solved as
    the eigenvector of eigenvalue 1, scaled to ``n_valid · INITIAL``."""
    nv = sum(valid)
    m = np.zeros((n, n))
    for i in range(n):
        if not valid[i]:
            continue
        row = {j: v for j, v in rows.get(i, {}).items() if valid[j] and j != i}
        total = sum(row.values())
        if total > 0:
            for j, v in row.items():
                m[j, i] = v / total
        else:
            for j in range(n):
                if valid[j] and j != i:
                    m[j, i] = 1.0 / (nv - 1)
    p = np.array([1.0 / nv if v else 0.0 for v in valid])
    g = (1 - alpha) * m + alpha * np.outer(p, np.array(valid, dtype=float))
    w, vecs = np.linalg.eig(g)
    s = np.real(vecs[:, np.argmin(np.abs(w - 1.0))])
    return s / s.sum() * nv * INITIAL


# peer 3 attests nobody (dangling), peer 4 is not valid; 0 -> 0 is a
# self-loop and 1 -> 2 is attested twice
SRC = np.array([0, 0, 1, 1, 2, 2, 0, 1, 4, 0])
DST = np.array([1, 2, 2, 2, 0, 3, 0, 0, 1, 4])
VAL = np.array([2.0, 2.0, 1.0, 3.0, 3.0, 1.0, 5.0, 4.0, 7.0, 9.0])
VALID = [True, True, True, True, False]


def test_trust_edges_drop_merge_and_sort():
    src, dst, val = trust_edges(5, SRC, DST, VAL, VALID)
    assert list(zip(src, dst, val)) == [
        (0, 1, 2.0), (0, 2, 2.0), (1, 0, 4.0), (1, 2, 4.0), (2, 0, 3.0),
        (2, 3, 1.0)]


def test_reference_matches_hand_worked_graph():
    g = TrustGraph(5, *trust_edges(5, SRC, DST, VAL, VALID), valid=VALID,
                   alpha=ALPHA)
    s, iters, delta = g.fixed_point(INITIAL, 1e-13, 10000)
    rows = {0: {1: 2.0, 2: 2.0}, 1: {0: 4.0, 2: 4.0}, 2: {0: 3.0, 3: 1.0}}
    want = hand_fixed_point(rows, 5, VALID, ALPHA)
    assert delta <= 1e-13 and iters < 10000
    np.testing.assert_allclose(s, want, rtol=1e-10, atol=1e-9)
    assert s[4] == 0.0
    assert s.sum() == pytest.approx(4 * INITIAL, rel=1e-12)


def test_reference_revised_row():
    g = TrustGraph(5, *trust_edges(5, SRC, DST, VAL, VALID), valid=VALID,
                   alpha=ALPHA)
    g.revise([(0, 1, 2.0, 6.0), (2, 3, 1.0, 0.0)])
    s, _, _ = g.fixed_point(INITIAL, 1e-13, 10000)
    # row 0 renormalises to 6:2; row 2 keeps only 2 -> 0
    rows = {0: {1: 6.0, 2: 2.0}, 1: {0: 4.0, 2: 4.0}, 2: {0: 3.0}}
    np.testing.assert_allclose(s, hand_fixed_point(rows, 5, VALID, ALPHA),
                               rtol=1e-10, atol=1e-9)
    with pytest.raises(ValueError):
        g.revise([(3, 0, 0.0, 1.0)])  # a pair the graph does not hold


def test_reference_dangling_row_after_removal():
    g = TrustGraph(5, *trust_edges(5, SRC, DST, VAL, VALID), valid=VALID,
                   alpha=0.0)
    g.revise([(2, 0, 3.0, 0.0), (2, 3, 1.0, 0.0)])  # peer 2 now dangles
    s, _, _ = g.fixed_point(INITIAL, 1e-13, 100000)
    rows = {0: {1: 2.0, 2: 2.0}, 1: {0: 4.0, 2: 4.0}}
    np.testing.assert_allclose(s, hand_fixed_point(rows, 5, VALID, 0.0),
                               rtol=1e-9, atol=1e-8)


def small_graph(seed: int = 5, n: int = 2000):
    src, dst, val = barabasi_albert_edges(n, 8, seed=seed)
    return n, trust_edges(n, src, dst, val)


@pytest.mark.parametrize("cell", ["ba1m.churn", "kron20.scores"])
def test_sound_answer_passes_and_perturbed_answer_fails(cell):
    n, edges = small_graph()
    g = TrustGraph(n, *edges, alpha=ALPHA)
    ref, _, _ = g.fixed_point(INITIAL, 1e-12, 10000)
    sound, _, _ = g.fixed_point(INITIAL, 1e-6, 500)
    lim = limits(cell)
    assert all(v <= lim[k] for k, v in compare(sound, ref).items())
    bad = sound.copy()
    bad[123] *= 1.05  # one score off by 5 %
    got = compare(bad, ref)
    assert any(got[k] > lim[k] for k in lim)
    assert compare(None, ref)["rel_l1"] == float("inf")
    nan = sound.copy()
    nan[0] = np.nan
    assert compare(nan, ref)["max_rel"] == float("inf")


@pytest.mark.parametrize("cell", ["ba1m.churn", "kron20.scores"])
def test_lower_precision_converge_fails(cell):
    """The control: the reference in bfloat16 in the program's place,
    with the configuration's tolerance, fails the cell's limits."""
    n, edges = small_graph()
    ref, _, _ = TrustGraph(n, *edges, alpha=ALPHA).fixed_point(
        INITIAL, 1e-12, 10000)
    low, _, _ = TrustGraph(n, *edges, alpha=ALPHA,
                           precision="bfloat16").fixed_point(INITIAL, 1e-6,
                                                             500)
    lim = limits(cell)
    got = compare(low, ref)
    assert any(got[k] > lim[k] for k in lim), got
