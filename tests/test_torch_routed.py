"""The port's routed operator and sweep against the reference's.

Inputs are made with numpy from a seed and handed to both packages. The
operator build is pure numpy in both, so its fields must be identical.
The sweep differs only in summation order (the reference's 0/1 einsum
reduce vs the port's segment sum, XLA's vs torch's reductions), so
float64 sweeps agree to 1e-12 and float32 ones to the reference's own
routed-vs-gather bound (rtol 1e-6, atol 1e-3 per sweep; rtol 1e-4,
atol 0.5 over a converge). Max-min sweeps have no rounding at all and
must agree exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from protocol_tpu.graph import barabasi_albert_edges
from protocol_tpu.ops import converge as ref_conv
from protocol_tpu.ops import routed as ref
from protocol_tpu_torch.ops import converge as port_conv
from protocol_tpu_torch.ops import routed as port

_GRAPHS = [(300, 3, 11, 0), (1500, 5, 22, 15)]  # n, m, seed, n_invalid


def _graph(n, m, seed, n_invalid):
    src, dst, val = barabasi_albert_edges(n, m, seed=seed)
    valid = np.ones(n, dtype=bool)
    if n_invalid:
        rng = np.random.default_rng(seed)
        valid[rng.choice(n, n_invalid, replace=False)] = False
    return src, dst, val, valid


_OPS = {}


def _ops(key):
    """(reference operator, port operator) built from the same edges."""
    if key not in _OPS:
        n, m, seed, n_invalid = key
        src, dst, val, valid = _graph(*key)
        _OPS[key] = (ref.build_routed_operator(n, src, dst, val, valid=valid),
                     port.build_routed_operator(n, src, dst, val,
                                                valid=valid))
    return _OPS[key]


def _assert_same_operator(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, list):
            assert len(x) == len(y), f.name
            for u, v in zip(x, y):
                assert np.asarray(u).dtype == np.asarray(v).dtype, f.name
                assert np.array_equal(u, v), f.name
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


def _both_arrays(rop, pop, np_dtype, **kw):
    jd = jnp.float64 if np_dtype == np.float64 else jnp.float32
    td = torch.float64 if np_dtype == np.float64 else torch.float32
    ra, rs = ref.routed_arrays(rop, dtype=jd, pallas=False, **kw)
    pa, ps = port.routed_arrays(pop, dtype=td, device="cpu", **kw)
    return (ra, rs), (pa, ps)


def _tol(np_dtype):
    if np_dtype == np.float64:
        return dict(rtol=1e-12, atol=1e-9)
    return dict(rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("key", _GRAPHS)
def test_operator_fields_match_reference(key):
    rop, pop = _ops(key)
    _assert_same_operator(rop, pop)
    n = key[0]
    assert pop.n == n and pop.nnz > 0
    # the blocked layout of these graphs spans both broadcast/reduce
    # branches (w < 128 and w ≥ 128) only on the larger graph
    if n == 1500:
        assert min(pop.out_widths) < 128 <= max(pop.out_widths)


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("key", _GRAPHS)
def test_spmv_routed_matches_reference(key, np_dtype):
    rop, pop = _ops(key)
    (ra, rs), (pa, ps) = _both_arrays(rop, pop, np_dtype, alpha=0.1)
    rng = np.random.default_rng(3)
    s = (rop.valid * rng.uniform(0, 2000, rop.n_state)).astype(np_dtype)
    want = np.asarray(ref.spmv_routed(ra, rs, jnp.asarray(s)))
    got = port.spmv_routed(pa, ps, torch.from_numpy(s)).numpy()
    assert got.dtype == np_dtype
    np.testing.assert_allclose(got, want, **_tol(np_dtype))


@pytest.mark.parametrize("alpha", [0.0, 0.1])
def test_fixed_sweeps_match_reference(alpha):
    rop, pop = _ops(_GRAPHS[1])
    for np_dtype in (np.float64, np.float32):
        (ra, rs), (pa, ps) = _both_arrays(rop, pop, np_dtype, alpha=alpha)
        s0 = rop.initial_scores(1000.0, dtype=np_dtype)
        want = np.asarray(ref.converge_routed_fixed(ra, rs, jnp.asarray(s0),
                                                    20))
        got = port.converge_routed_fixed(pa, ps, torch.from_numpy(s0),
                                         20).numpy()
        if np_dtype == np.float64:
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.5)
        total = rop.n_valid * 1000.0
        assert abs(float(got.sum()) - total) / total < 1e-4


@pytest.mark.parametrize("key", _GRAPHS)
def test_adaptive_matches_reference(key):
    rop, pop = _ops(key)
    (ra, rs), (pa, ps) = _both_arrays(rop, pop, np.float32, alpha=0.1)
    s0 = rop.initial_scores(1000.0)
    sr, ir, dr = ref.converge_routed_adaptive(ra, rs, jnp.asarray(s0),
                                              tol=1e-6, max_iterations=300)
    sp, ip, dp = port.converge_routed_adaptive(pa, ps, torch.from_numpy(s0),
                                               tol=1e-6, max_iterations=300)
    # different f32 summation orders may put the stopping delta on the
    # other side of tol once: ±1 iteration, as in the reference's tests
    assert abs(ip - int(ir)) <= 1
    assert dp <= 1e-6
    np.testing.assert_allclose(sp.numpy(), np.asarray(sr), rtol=1e-4,
                               atol=0.5)


def test_maxplus_twin_matches_reference_exactly():
    rop, pop = _ops(_GRAPHS[1])
    sr_ref = ref_conv.MAXPLUS
    sr_port = port_conv.MAXPLUS
    (ra, rs), (pa, ps) = _both_arrays(rop, pop, np.float64)
    s0 = rop.initial_scores(1000.0, dtype=np.float64)
    want = np.asarray(ref.converge_routed_fixed_semiring(
        ra, rs, jnp.asarray(s0), sr_ref, 10))
    got = port.converge_routed_fixed_semiring(
        pa, ps, torch.from_numpy(s0), sr_port, 10).numpy()
    assert np.array_equal(got, want)
    sw, iw, _ = ref.converge_routed_adaptive_semiring(
        ra, rs, jnp.asarray(s0), sr_ref, tol=1e-9, max_iterations=50)
    sg, ig, _ = port.converge_routed_adaptive_semiring(
        pa, ps, torch.from_numpy(s0), sr_port, tol=1e-9, max_iterations=50)
    assert ig == int(iw)
    assert np.array_equal(sg.numpy(), np.asarray(sw))


def test_delta_engine_keys_match_reference():
    """``inv_row_scale`` and the COO ``tail_*`` keys of the patched
    matvec, in float64."""
    rop, pop = _ops(_GRAPHS[1])
    (ra, rs), (pa, ps) = _both_arrays(rop, pop, np.float64, alpha=0.1)
    rng = np.random.default_rng(5)
    N = rop.n_state
    live = np.nonzero(rop.valid > 0)[0]
    scale = np.where(rop.valid > 0, rng.uniform(0.5, 1.5, N), 1.0)
    cap = 64
    tsrc = rng.choice(live, cap)
    tdst = rng.choice(live, cap)
    tw = rng.uniform(0, 0.2, cap)
    tw[-8:] = 0.0  # unused capacity
    ra = dict(ra, inv_row_scale=jnp.asarray(scale),
              tail_src=jnp.asarray(tsrc.astype(np.int32)),
              tail_dst=jnp.asarray(tdst.astype(np.int32)),
              tail_w=jnp.asarray(tw))
    pa = dict(pa, inv_row_scale=torch.from_numpy(scale),
              tail_src=torch.from_numpy(tsrc.astype(np.int64)),
              tail_dst=torch.from_numpy(tdst.astype(np.int64)),
              tail_w=torch.from_numpy(tw))
    s = rop.initial_scores(1000.0, dtype=np.float64)
    want = np.asarray(ref.spmv_routed(ra, rs, jnp.asarray(s)))
    got = port.spmv_routed(pa, ps, torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("suffix", ["op.npz", "op_dir"])
def test_save_load_across_packages(tmp_path, suffix):
    rop, pop = _ops(_GRAPHS[0])
    rop.save(tmp_path / f"ref_{suffix}")
    _assert_same_operator(rop, port.RoutedOperator.load(
        str(tmp_path / f"ref_{suffix}")))
    pop.save(tmp_path / f"port_{suffix}")
    _assert_same_operator(pop, ref.RoutedOperator.load(
        str(tmp_path / f"port_{suffix}")))


def test_legacy_v1_operator_loads(tmp_path):
    rop, _ = _ops(_GRAPHS[0])
    payload = {
        "meta": np.asarray(
            [rop.n, rop.n_valid, rop.nnz, rop.n_src_pos,
             rop.edge_e, rop.state_e, rop.in_n_pos], dtype=np.int64),
        "out_widths": np.asarray(rop.out_widths, dtype=np.int64),
        "out_xs": np.asarray(rop.out_xs, dtype=np.int64),
        "in_widths": np.asarray(rop.in_widths, dtype=np.int64),
        "in_xs": np.asarray(rop.in_xs, dtype=np.int64),
        "edge_bits": np.asarray(rop.edge_bits, dtype=np.int64),
        "state_bits": np.asarray(rop.state_bits, dtype=np.int64),
        "edge_stages": np.stack(rop.edge_stages),
        "state_stages": np.stack(rop.state_stages),
        "state_to_node": rop.state_to_node.astype(np.int64),
        "valid": rop.valid,
        "dangling": rop.dangling,
    }
    for i, w in enumerate(rop.out_weight):
        payload[f"out_weight_{i}"] = w
    np.savez(tmp_path / "v1.npz", **payload)
    a = ref.RoutedOperator.load(str(tmp_path / "v1.npz"))
    b = port.RoutedOperator.load(str(tmp_path / "v1.npz"))
    _assert_same_operator(a, b)


def test_operator_from_numpy_carries_reference_operator():
    rop, _ = _ops(_GRAPHS[1])
    fields = {f.name: getattr(rop, f.name) for f in dataclasses.fields(rop)}
    pop = port.operator_from_numpy(fields)
    _assert_same_operator(rop, pop)
    del fields["out_edge_slot"], fields["min_width"]  # optional fields
    assert port.operator_from_numpy(fields).min_width == 8
    del fields["valid"]
    with pytest.raises(ValueError):
        port.operator_from_numpy(fields)


def test_ensure_edge_slots_matches_reference():
    from protocol_tpu_torch.graph import filter_edges

    key = _GRAPHS[1]
    rop, pop = _ops(key)
    src, dst, val, valid = _graph(*key)
    fsrc, fdst, w, _, _ = filter_edges(key[0], src, dst, val, valid)
    slots = pop.out_edge_slot
    pop2 = dataclasses.replace(pop, out_edge_slot=None)
    port.ensure_edge_slots(pop2, fsrc, fdst, w)
    assert np.array_equal(pop2.out_edge_slot, slots)
    assert np.array_equal(pop2.out_edge_slot, rop.out_edge_slot)
