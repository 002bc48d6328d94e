"""The port's delta engine and refresh ladder against the reference's.

Both packages anchor on their own build of the same graph (the builds
are field for field equal, ``test_torch_routed.py``) and take the same
churn: ``revision_batch`` draws from one seed, structural inserts and
removes, a new peer. The host bookkeeping is a copy of the reference's,
so it must match exactly; so must every device array the engine patches
(each value is computed in numpy, or by one IEEE division, in both).

Converges and ladder sweeps run in float64 where they are held against
the reference's x64 run (``tests/conftest.py``): the device sweeps take
the engine's dtype, and a float32 port engine would choose the ladder's
rungs by float32's floor where the reference uses float64's. Bounds:
float64 converges within 1e-12 relative with equal iterations; float32
at ``test_torch_routed.py``'s converge bounds (rtol 1e-4, atol 0.5,
iterations ±1); ladder results with the same mode and sweeps and the
residual within 1e-12 (``test_sublinear.py``'s device-vs-host bound).
"""

import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from protocol_tpu import incremental as ref_inc
from protocol_tpu.graph import barabasi_albert_edges, filter_edges
from protocol_tpu.ops.routed import build_routed_operator as ref_build
from protocol_tpu_torch import incremental as port_inc
from protocol_tpu_torch.ops.routed import build_routed_operator as port_build
from protocol_tpu_torch.ops.routed import routed_arrays

N, M, SEED = 300, 3, 7
ALPHA = 0.15
INITIAL = 1000.0
_DT = {np.float64: (jnp.float64, torch.float64),
       np.float32: (jnp.float32, torch.float32)}


def _graph():
    src, dst, val = barabasi_albert_edges(N, M, seed=SEED)
    return src, dst, val, np.ones(N, dtype=bool)


def _pair(np_dtype=np.float64, ref_kw=None, **kw):
    """(reference engine, port engine) anchored on the same graph;
    ``ref_kw`` goes to the reference's anchor alone."""
    src, dst, val, valid = _graph()
    jd, td = _DT[np_dtype]
    ref = ref_inc.DeltaEngine.anchor(
        N, src, dst, val, valid, ref_build(N, src, dst, val, valid),
        dtype=jd, alpha=ALPHA, **(ref_kw or {}), **kw)
    port = port_inc.DeltaEngine.anchor(
        N, src, dst, val, valid, port_build(N, src, dst, val, valid),
        dtype=td, alpha=ALPHA, device="cpu", **kw)
    return ref, port


def _revisions(count, seed):
    """``count`` revisions drawn by both packages' ``revision_batch`` from
    one seed; the two draws must agree."""
    src, dst, val, valid = _graph()
    fsrc, fdst, _, _, _, raw, _ = filter_edges(N, src, dst, val, valid,
                                               return_raw=True)
    a = ref_inc.revision_batch(np.random.default_rng(seed), fsrc, fdst,
                               raw.copy(), count)
    b = port_inc.revision_batch(np.random.default_rng(seed), fsrc, fdst,
                                raw.copy(), count)
    assert a == b
    return a


def _mixed_windows(eng):
    """Churn windows of every kind: revisions, structural inserts into
    the tail, a tail removal, a built-edge removal, a new peer."""
    keys = set(zip(eng.fsrc.tolist(), eng.fdst.tolist()))
    fresh = [(a, b) for a in range(0, N, 7) for b in range(3, N, 11)
             if a != b and (a, b) not in keys][:6]
    i0, j0 = int(eng.fsrc[5]), int(eng.fdst[5])
    return [
        _revisions(40, 1),
        [(a, b, None, 3.0 + k) for k, (a, b) in enumerate(fresh)]
        + _revisions(10, 2),
        [(fresh[0][0], fresh[0][1], 3.0, 0.0), (i0, j0, None, 0.0),
         (fresh[1][0], fresh[1][1], 4.0, 9.0)],
        [(N, 0, None, 5.0), (2, N, None, 2.0)],
    ]


def _apply(eng, window):
    n = max(max(d[0], d[1]) for d in window) + 1
    return eng.apply_deltas(window, n=max(n, eng.n_now))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _published(ref, port):
    """The reference engine's cold converge, handed to both as the
    published vector."""
    s_pub, _, delta = ref.converge(ref.initial_node_scores(INITIAL), 500,
                                   1e-10)
    assert delta <= 1e-10
    ref.take_frontier()
    port.take_frontier()
    return s_pub


def test_delta_engine_state_matches_reference():
    ref, port = _pair()
    src, dst, val, valid = _graph()
    op_weights = [w.copy() for w in port.op.out_weight]
    s_pub = _published(ref, port)
    for window in _mixed_windows(port):
        assert _apply(ref, window) and _apply(port, window)
        assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
        for name in ("slot", "tail_src_np", "tail_dst_np", "tail_raw_np",
                     "row_sum_now", "dangling_np", "valid_np",
                     "node_to_state", "state_to_node", "valid_state"):
            assert np.array_equal(getattr(port, name), getattr(ref, name)), \
                name
        assert port.tail_index == ref.tail_index
        assert port.dirty_rows == ref.dirty_rows
        assert (port.n_now, port.n_valid, port.nnz_now) \
            == (ref.n_now, ref.n_valid, ref.nnz_now)
        for a, b in zip(ref.arrs["out_weight"], port.arrs["out_weight"]):
            assert np.array_equal(_np(a), _np(b))
        for k in ("inv_row_scale", "dangling", "valid", "n_valid",
                  "pretrust"):
            a, b = _np(ref.arrs[k]), _np(port.arrs[k])
            assert a.shape == b.shape and np.array_equal(a, b), k
        # the port's tail holds one entry per tail edge, the reference's
        # its whole capacity (pads of weight 0)
        for k in ("tail_src", "tail_dst", "tail_w"):
            a, b = _np(ref.arrs[k]), _np(port.arrs[k])
            assert len(b) == len(port.tail_raw_np), k
            assert np.array_equal(a[:len(b)], b) and not a[len(b):].any(), k
        fr, ok_r = ref.take_frontier()
        fp, ok_p = port.take_frontier()
        assert np.array_equal(fr, fp) and ok_r == ok_p
        if ok_r:  # host partial refresh: a copy, so the same bits
            r = ref_inc.partial_refresh(ref, s_pub, fr, 1e-8, 300, N)
            p = port_inc.partial_refresh(port, s_pub, fp, 1e-8, 300, N)
            assert (r is None) == (p is None)
            if r is not None:
                assert np.array_equal(r.scores, p.scores)
                assert (r.sweeps, r.residual, r.frontier_peak,
                        r.budget_spent) == (p.sweeps, p.residual,
                                            p.frontier_peak, p.budget_spent)
    assert port.stats.inserts and port.stats.removes and port.stats.new_peers
    # the patches stayed in the engine's own tensors: the operator's host
    # arrays, and a backend's arrays made from it, are as built
    for w0, w in zip(op_weights, port.op.out_weight):
        assert np.array_equal(w0, w)
    arrs, _ = routed_arrays(port.op, dtype=torch.float64, alpha=ALPHA,
                            device="cpu")
    for w0, w in zip(op_weights, arrs["out_weight"]):
        assert np.array_equal(w0, w.numpy())


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
def test_delta_engine_converge_matches_reference(np_dtype):
    """Cold converge, then a warm one on the patched operator (tail,
    rescaled rows, new peer) from the published vector."""
    ref, port = _pair(np_dtype)
    tol = 1e-10 if np_dtype == np.float64 else 1e-6
    s0 = ref.initial_node_scores(INITIAL)
    runs = [(ref.converge(s0, 500, tol), port.converge(s0, 500, tol))]
    for window in _mixed_windows(port):
        assert _apply(ref, window) and _apply(port, window)
    s_pub = np.concatenate([runs[0][0][0], [INITIAL]])  # the new peer
    runs.append((ref.converge(s_pub, 500, tol), port.converge(s_pub, 500,
                                                              tol)))
    for (sr, ir, dr), (sp, ip, dp) in runs:
        assert sp.dtype == np_dtype and sp.shape == sr.shape
        if np_dtype == np.float64:
            assert ip == ir
            assert np.max(np.abs(sp - sr)) <= 1e-12 * np.max(np.abs(sr))
        else:
            assert abs(ip - ir) <= 1 and dp <= tol
            np.testing.assert_allclose(sp, sr, rtol=1e-4, atol=0.5)


def _ladder_windows(ref, port):
    """A localized window (20 revisions) and a flooded one (400)."""
    out = []
    for count, seed in ((20, 5), (200, 6)):
        window = _revisions(count, seed)
        assert ref.apply_deltas(window) and port.apply_deltas(window)
        fr, _ = ref.take_frontier()
        fp, _ = port.take_frontier()
        assert np.array_equal(fr, fp)
        out.append(fp)
    return out


def _same_result(r, p):
    assert (r is None) == (p is None)
    if r is None:
        return
    assert p.sweeps == r.sweeps and p.frontier_peak == r.frontier_peak
    assert p.resamples == r.resamples
    assert abs(p.residual - r.residual) <= 1e-12
    assert abs(p.budget_spent - r.budget_spent) <= 1e-12
    assert np.max(np.abs(p.scores - r.scores)) \
        <= 1e-9 * np.max(np.abs(r.scores))


def test_device_and_sampled_refresh_match_reference():
    ref, port = _pair()
    s_pub = _published(ref, port)
    local, flooded = _ladder_windows(ref, port)
    for F in (local, flooded):
        _same_result(
            ref_inc.device_partial_refresh(ref, s_pub, F, 1e-8, 300, N),
            port_inc.device_partial_refresh(port, s_pub, F, 1e-8, 300, N))
        for budget, error_budget in ((N, 0.0), (len(F) + 40, 5e-2),
                                     (max(len(F) // 2, 1), 0.0)):
            _same_result(
                ref_inc.sampled_refresh(ref, s_pub, F, 1e-8, 300, budget,
                                        error_budget=error_budget),
                port_inc.sampled_refresh(port, s_pub, F, 1e-8, 300, budget,
                                         error_budget=error_budget))


def test_ladder_refresh_picks_the_reference_rung():
    ref, port = _pair()
    s_pub = _published(ref, port)
    local, flooded = _ladder_windows(ref, port)
    modes = set()
    for F, limit, threshold in (
            (local, N, 0),                        # device_partial
            (local, N, 4096),                     # partial (host)
            (flooded, max(len(flooded) // 4, 1), 0),  # sampled
            (flooded, 1, -1)):
        kw = dict(device_threshold=threshold, sample_budget=N,
                  error_budget=1e-3)
        r, mode_r = ref_inc.ladder_refresh(ref, s_pub, F, 1e-6, 300, limit,
                                           **kw)
        p, mode_p = port_inc.ladder_refresh(port, s_pub, F, 1e-6, 300,
                                            limit, **kw)
        assert mode_p == mode_r
        _same_result(r, p)
        modes.add(mode_p)
    assert {"device_partial", "partial", "sampled"} <= modes


def test_capacity_walls_flip_apply_deltas_like_the_reference():
    # the overflow tail past tail_max
    ref, port = _pair(tail_max=3)
    keys = set(zip(port.fsrc.tolist(), port.fdst.tolist()))
    fresh = [(a, b) for a in range(N) for b in range(N)
             if a != b and (a, b) not in keys][:4]
    window = [(a, b, None, 2.0) for a, b in fresh]
    assert ref.apply_deltas(window) is False
    assert port.apply_deltas(window) is False
    assert port.stats.rebuild_reason == ref.stats.rebuild_reason == "tail_max"
    assert port.should_rebuild() == ref.should_rebuild() == "tail_max"
    assert ref.apply_deltas([]) is False and port.apply_deltas([]) is False

    # a tail past the reference's capacity of 4 (it doubles twice; the
    # port's tail has one entry per edge), then new peers past the
    # build's free state slots
    ref, port = _pair(ref_kw={"tail_min_capacity": 4})
    window = [(a, b, None, 2.0)
              for a, b in [(a, b) for a in range(N) for b in range(N)
                           if a != b and (a, b) not in keys][:9]]
    assert ref.apply_deltas(window) and port.apply_deltas(window)
    assert ref.tail_capacity == 16 and len(port.arrs["tail_w"]) == 9
    assert np.array_equal(port.arrs["tail_w"].numpy(),
                          np.asarray(ref.arrs["tail_w"])[:9])
    headroom = len(port.free_slots) - port._free_ptr
    assert headroom == len(ref.free_slots) - ref._free_ptr
    assert ref.apply_deltas([], n=N + headroom + 1) is False
    assert port.apply_deltas([], n=N + headroom + 1) is False
    assert port.stats.rebuild_reason == ref.stats.rebuild_reason \
        == "state_slots_exhausted"


def test_partial_sweep_segment_sums_repeat_bit_for_bit():
    """The device sweep's segment sums past torch's threaded-scatter size
    (32,768 terms): two runs give the same bits, and the update agrees
    with numpy's ``bincount`` (no dangling rows, α = 0.1)."""
    from protocol_tpu_torch.ops.converge import partial_sweep_device

    rng = np.random.default_rng(3)
    n, nf, ne = 5000, 2048, 100_000
    s = torch.from_numpy(rng.uniform(0, 10, n))
    f_idx = torch.from_numpy(rng.choice(n - 1, nf, replace=False))
    e_row = torch.from_numpy(rng.integers(0, nf, ne))
    e_src = torch.from_numpy(rng.integers(0, n - 1, ne))
    e_w = torch.from_numpy(rng.uniform(0, 1, ne))
    valid = torch.ones(nf, dtype=torch.float64)
    zeros = torch.zeros(nf, dtype=torch.float64)
    # uni, uni_next, d_now, denom, keep, alpha, n_valid, total
    scal = torch.tensor([0.0, 0.0, 5.0, n - 1.0, 0.9, 0.1, n, 5e4],
                        dtype=torch.float64)
    runs = [partial_sweep_device(s.clone(), f_idx, valid, zeros, zeros,
                                 e_row, e_src, e_w, scal)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    base = np.bincount(e_row.numpy(), weights=(e_w * s[e_src]).numpy(),
                       minlength=nf)
    want = 0.9 * (base + 5.0 / (n - 1.0)) + 0.1 / n * 5e4
    np.testing.assert_allclose(runs[0][1].numpy(), want - s[f_idx].numpy(),
                               rtol=1e-12, atol=1e-9)
