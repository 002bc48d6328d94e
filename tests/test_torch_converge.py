"""The port's converge core against the reference's ``ops/converge.py``:
the sweep tail, the adaptive loop (with its extrapolation), the
gather SpMV, the dense path and the warm start.

Float64 results agree to 1e-12 (only summation order differs); adaptive
runs keep the reference tests' bounds (iterations ±1, rtol 1e-4,
atol 0.5). Max-min sweeps agree exactly.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from protocol_tpu import backend as ref_backend
from protocol_tpu import graph as ref_graph
from protocol_tpu.ops import converge as ref
from protocol_tpu_torch import backend as port_backend
from protocol_tpu_torch import graph as port_graph
from protocol_tpu_torch.ops import converge as port


def _gather_pair(n, src, dst, val, np_dtype, **kw):
    jd = jnp.float64 if np_dtype == np.float64 else jnp.float32
    td = torch.float64 if np_dtype == np.float64 else torch.float32
    rop = ref_graph.build_operator(n, src, dst, val)
    pop = port_graph.build_operator(n, src, dst, val)
    return (rop, ref.operator_arrays(rop, dtype=jd, **kw),
            port.operator_arrays(pop, dtype=td, device="cpu", **kw))


def _slow_mixing_graph():
    """Two dense clusters joined by a weak bridge (λ₂ near 1): the
    reference's extrapolation test graph."""
    rng = np.random.default_rng(0)
    nc = 150
    src_l, dst_l, val_l = [], [], []
    for base in (0, nc):
        for i in range(nc):
            for j in rng.choice(nc, 6, replace=False):
                if i != j:
                    src_l.append(base + i)
                    dst_l.append(base + j)
                    val_l.append(5.0)
    src_l += [0, nc]
    dst_l += [nc, 0]
    val_l += [0.2, 0.2]
    return 2 * nc, np.asarray(src_l), np.asarray(dst_l), np.asarray(val_l)


def test_graph_operator_build_matches_reference():
    n = 700
    src, dst, val = ref_graph.barabasi_albert_edges(n, 4, seed=3)
    valid = np.ones(n, dtype=bool)
    valid[::37] = False
    a = ref_graph.build_operator(n, src, dst, val, valid)
    b = port_graph.build_operator(n, src, dst, val, valid)
    assert a.widths == b.widths and a.n_valid == b.n_valid
    for name in ("row_pos", "valid", "dangling"):
        assert np.array_equal(getattr(a, name), getattr(b, name))
    for x, y in zip(a.bucket_idx + a.bucket_val, b.bucket_idx + b.bucket_val):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for x, y in zip(ref_graph.filter_edges(n, src, dst, val, valid,
                                           return_raw=True),
                    port_graph.filter_edges(n, src, dst, val, valid,
                                            return_raw=True)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        assert np.array_equal(x, y)
    for x, y in zip(ref_graph.barabasi_albert_edges(300, 3, seed=9),
                    port_graph.barabasi_albert_edges(300, 3, seed=9)):
        assert np.array_equal(x, y)
    m = np.random.default_rng(4).integers(0, 5, (9, 9)).astype(float)
    m[2] = 0.0
    assert np.array_equal(port_graph.dense_normalized(m),
                          ref_graph.dense_normalized(m))
    k = np.random.default_rng(1).integers(0, 1 << 40, 5000)
    assert np.array_equal(port_graph.stable_argsort_bounded(k, 1 << 40),
                          ref_graph.stable_argsort_bounded(k, 1 << 40))


@pytest.mark.parametrize("alpha", [0.0, 0.15])
def test_dangling_and_damping_matches_reference(alpha):
    rng = np.random.default_rng(11)
    n = 257
    valid = (rng.random(n) > 0.1).astype(np.float64)
    dangling = valid * (rng.random(n) > 0.7)
    pretrust = valid / valid.sum()
    s = valid * rng.uniform(0, 2000, n)
    base = rng.uniform(0, 500, n)
    arrs_r = {"valid": jnp.asarray(valid), "dangling": jnp.asarray(dangling),
              "n_valid": jnp.asarray(valid.sum()),
              "alpha": jnp.asarray(alpha), "pretrust": jnp.asarray(pretrust)}
    arrs_p = {k: torch.as_tensor(np.array(v)) for k, v in arrs_r.items()}
    want = np.asarray(ref.dangling_and_damping(arrs_r, jnp.asarray(s),
                                               jnp.asarray(base)))
    got = port.dangling_and_damping(arrs_p, torch.from_numpy(s),
                                    torch.from_numpy(base)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
def test_gather_spmv_and_converge_match_reference(np_dtype):
    n = 900
    src, dst, val = ref_graph.barabasi_albert_edges(n, 4, seed=8)
    rop, ra, pa = _gather_pair(n, src, dst, val, np_dtype, alpha=0.1)
    s0 = (rop.valid * 1000.0).astype(np_dtype)
    tol = (dict(rtol=1e-12, atol=1e-9) if np_dtype == np.float64
           else dict(rtol=1e-6, atol=1e-3))
    np.testing.assert_allclose(
        port.spmv(pa, torch.from_numpy(s0)).numpy(),
        np.asarray(ref.spmv(ra, jnp.asarray(s0))), **tol)
    np.testing.assert_allclose(
        port.converge_sparse_fixed(pa, torch.from_numpy(s0), 20).numpy(),
        np.asarray(ref.converge_sparse_fixed(ra, jnp.asarray(s0), 20)),
        rtol=1e-4, atol=0.5)
    sr, ir, _ = ref.converge_sparse_adaptive(ra, jnp.asarray(s0), tol=1e-6,
                                             max_iterations=300)
    sp, ip, dp = port.converge_sparse_adaptive(pa, torch.from_numpy(s0),
                                               tol=1e-6, max_iterations=300)
    assert abs(ip - int(ir)) <= 1 and dp <= 1e-6
    np.testing.assert_allclose(sp.numpy(), np.asarray(sr), rtol=1e-4,
                               atol=0.5)


def test_maxplus_gather_matches_reference_exactly():
    n = 400
    src, dst, val = ref_graph.barabasi_albert_edges(n, 3, seed=4)
    rop, ra, pa = _gather_pair(n, src, dst, val, np.float64)
    s0 = rop.valid.astype(np.float64) * 1000.0
    want = ref.converge_sparse_adaptive_semiring(
        ra, jnp.asarray(s0), ref.MAXPLUS, tol=1e-9, max_iterations=60)
    got = port.converge_sparse_adaptive_semiring(
        pa, torch.from_numpy(s0), port.MAXPLUS, tol=1e-9, max_iterations=60)
    assert got[1] == int(want[1])
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))


def test_adaptive_loop_accel_matches_reference():
    """``accel_every`` extrapolation: fewer iterations than plain on a
    slow-mixing graph, same fixed point, mass conserved, and the same
    trajectory as the reference's loop."""
    n, src, dst, val = _slow_mixing_graph()
    rop, ra, pa = _gather_pair(n, src, dst, val, np.float64, alpha=0.005)
    s0 = rop.valid.astype(np.float64) * 1000.0
    sp, ip, dp = port.converge_sparse_adaptive(
        pa, torch.from_numpy(s0), tol=1e-7, max_iterations=3000)
    sa, ia, da = port.converge_sparse_adaptive(
        pa, torch.from_numpy(s0), tol=1e-7, max_iterations=3000,
        accel_every=4)
    assert ia < ip and da <= 1e-7
    np.testing.assert_allclose(sa.numpy(), sp.numpy(), rtol=1e-4, atol=0.5)
    total = rop.n_valid * 1000.0
    assert abs(float(sa.sum()) - total) / total < 1e-9
    sr, ir, dr = ref.converge_sparse_adaptive(
        ra, jnp.asarray(s0), tol=1e-7, max_iterations=3000, accel_every=4)
    assert abs(ia - int(ir)) <= 1
    np.testing.assert_allclose(sa.numpy(), np.asarray(sr), rtol=1e-6,
                               atol=1e-3)


def test_adaptive_loop_contract():
    with pytest.raises(ValueError):
        port.adaptive_loop(lambda s: s, torch.ones(4), 1e-6, 10,
                           accel_every=1)
    # max_iterations=0 returns the start untouched with an infinite delta
    s, it, d = port.adaptive_loop(lambda s: 2 * s, torch.ones(4), 1e-6, 0)
    assert it == 0 and d == float("inf") and torch.equal(s, torch.ones(4))
    # the cap stops a run that never reaches tol
    s, it, d = port.adaptive_loop(lambda s: 2 * s, torch.ones(4), 1e-6, 5)
    assert it == 5 and torch.equal(s, torch.full((4,), 32.0))


def test_semiring_resolution():
    assert port.resolve_semiring(None) is port.PLUSMUL
    assert port.resolve_semiring("maxplus") is port.MAXPLUS
    assert port.resolve_semiring(port.MAXPLUS) is port.MAXPLUS
    with pytest.raises(ValueError):
        port.resolve_semiring("minplus")


def test_dense_backend_matches_reference():
    rng = np.random.default_rng(2)
    n = 24
    mat = rng.integers(0, 9, size=(n, n)).astype(np.float64)
    np.fill_diagonal(mat, 0)
    want = ref_backend.JaxDenseBackend(dtype=jnp.float64).converge(
        mat, 1000.0, 30)
    got = port_backend.TorchDenseBackend(dtype=torch.float64,
                                         device="cpu").converge(mat, 1000.0,
                                                                30)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12, atol=1e-9)
    oracle = port_backend.NativeRationalBackend().converge(mat, 1000.0, 30)
    np.testing.assert_allclose(got, oracle, rtol=1e-9, atol=1e-6)
    s0 = torch.full((n,), 1000.0, dtype=torch.float64)
    c = torch.from_numpy(port_graph.dense_normalized(mat))
    sa, ia, da = port.converge_dense_adaptive(c, s0, tol=1e-9,
                                              max_iterations=200)
    sr, ir, _ = ref.converge_dense_adaptive(jnp.asarray(c.numpy()),
                                            jnp.asarray(s0.numpy()),
                                            tol=1e-9, max_iterations=200)
    assert ia == int(ir) and da <= 1e-9
    np.testing.assert_allclose(sa.numpy(), np.asarray(sr), rtol=1e-12)


@pytest.mark.parametrize("case", ["grown", "same", "empty", "all_invalid"])
def test_warm_start_scores_matches_reference(case):
    rng = np.random.default_rng(6)
    n = 50
    valid = rng.random(n) > 0.2
    prev = {"grown": rng.uniform(0, 3000, 40),
            "same": rng.uniform(0, 3000, n),
            "empty": np.zeros(0),
            "all_invalid": np.where(valid[:30], 0.0, 5.0)}[case]
    want = ref.warm_start_scores(prev, n, valid, 1000.0)
    got = port.warm_start_scores(prev, n, valid, 1000.0)
    assert got.dtype == np.float64 and np.array_equal(got, want)
    with pytest.raises(ValueError):
        port.warm_start_scores(prev, n, valid[:-1], 1000.0)
