"""The frozen graph generators and the churn draw."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench.generators.ba import barabasi_albert_edges
from perfbench.generators.churn import RevisionStream
from perfbench.generators.kronecker import kronecker_edges

KRON = dict(scale=10, edgefactor=16, a=0.57, b=0.19, c=0.19)


def test_ba_equals_the_programs_generator_bit_for_bit():
    from protocol_tpu_torch.graph import barabasi_albert_edges as program

    for n, m, seed in ((5000, 8, 3), (1500, 4, 2**31 + 7)):
        for a, b in zip(barabasi_albert_edges(n, m, seed=seed),
                        program(n, m, seed=seed)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_kronecker_is_deterministic_by_seed_and_sized_by_the_spec():
    a = kronecker_edges(**KRON, seed=11)
    b = kronecker_edges(**KRON, seed=11)
    c = kronecker_edges(**KRON, seed=12)
    m = 16 * 2**10
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    src, dst, val = a
    assert len(src) == len(dst) == len(val) == m
    assert src.min() >= 0 and max(src.max(), dst.max()) < 2**10
    assert val.min() >= 1 and val.max() <= 10 and np.all(val == np.round(val))


def test_kronecker_initiator_skew():
    """Without the permutation vertex 0 (quadrant A at every level) has
    the most edges, as the initiator 0.57/0.19/0.19/0.05 makes it."""
    src, dst, _ = kronecker_edges(**KRON, seed=3, permute=False)
    deg = np.bincount(src, minlength=2**10) + np.bincount(dst,
                                                          minlength=2**10)
    assert int(np.argmax(deg)) == 0
    # a row bit is set with probability C + D = 0.24
    bits = np.unpackbits(src.astype(">u2").view(np.uint8)).mean() * 16 / 10
    assert bits == pytest.approx(0.24, abs=0.01)


def test_kronecker_permutes_labels():
    """The permuted graph is the unpermuted one under other labels: the
    same degree multiset, but the hub is not vertex 0 and the pairs are
    shuffled."""
    hubs = []
    for seed in range(5):
        ps, pd, _ = kronecker_edges(**KRON, seed=seed)
        us, ud, _ = kronecker_edges(**KRON, seed=seed, permute=False)
        pdeg = np.bincount(ps, minlength=2**10)
        udeg = np.bincount(us, minlength=2**10)
        assert np.array_equal(np.sort(pdeg), np.sort(udeg))
        assert not np.array_equal(ps, us)
        hubs.append(int(np.argmax(pdeg + np.bincount(pd, minlength=2**10))))
    assert sum(h != 0 for h in hubs) >= 4


def test_churn_batch_distinct_and_tuple_form():
    rng = np.random.default_rng(1)
    src = np.arange(600) % 37
    dst = np.arange(600) // 37 + 40
    val = rng.integers(1, 11, 600).astype(np.float64)
    stream = RevisionStream(src, dst, val, np.random.default_rng(9),
                            batch=500)
    cur, orig = val.copy(), val.copy()
    for _ in range(3):
        batch = stream.next_batch()
        assert len(batch) == 500
        pairs = {(s, d) for s, d, _, _ in batch}
        assert len(pairs) == 500  # no repeats inside a batch
        for s, d, old, new in batch:
            assert isinstance(s, int) and isinstance(d, int)
            e = int(np.nonzero((src == s) & (dst == d))[0][0])
            assert old == cur[e]  # the value after every earlier batch
            assert 1 <= new <= 10 and new == int(new)
            cur[e] = new
    assert np.array_equal(val, orig)  # the caller's array is not touched
    with pytest.raises(ValueError):
        RevisionStream(src, dst, val, rng, batch=601)


def test_churn_draw_is_seeded():
    src, dst = np.arange(10**6), np.arange(10**6) + 1
    val = np.ones(10**6)
    a = RevisionStream(src, dst, val, np.random.default_rng(4), 500)
    b = RevisionStream(src, dst, val, np.random.default_rng(4), 500)
    assert a.next_batch() == b.next_batch()
