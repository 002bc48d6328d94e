"""The port's device mesh (``protocol_tpu_torch/parallel/``: the mesh and
its collectives, the row-sharded gather and Clos-routed converges, the
checkpointed loop, ``sparse-scores --checkpoint-dir`` and
``entry.dryrun_multichip``) against the reference's sharded functions on
the same inputs.

The port's meshes here repeat ``torch.device("cpu")`` (D ∈ {2, 4, 8}),
every shard running the kernels' plain versions; the reference's run on
the conftest's virtual 8-device CPU mesh. Inputs come from numpy seeds.
Tolerances are the reference tests' (``tests/test_sharded.py``,
``tests/test_sharded_routed.py``, ``tests/test_cli.py``).
"""

import csv
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protocol_tpu import parallel as ref
from protocol_tpu.graph import barabasi_albert_edges
from protocol_tpu_torch import parallel as port
from protocol_tpu_torch.backend import TorchSparseBackend
from protocol_tpu_torch.graph import build_operator
from protocol_tpu_torch.ops.converge import (
    converge_sparse_adaptive,
    converge_sparse_fixed,
    operator_arrays,
)
from protocol_tpu_torch.parallel import mesh as pmesh
from protocol_tpu_torch.utils.checkpoint import CheckpointManager

CPU = torch.device("cpu")
INITIAL_SCORE = 1000.0


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for these tests: they run thousands of tiny
    torch ops and small float64 matmuls, which a pool of one thread a
    core slows some fifty times over when the suite's other workers hold
    the cores (the pool's threads wait on each other); alone they run
    as fast either way."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_mesh(d):
    return port.make_mesh(devices=[CPU] * d)


def _single_gather(n, src, dst, val, iters, alpha=0.0, valid=None,
                   tol=None, dtype=torch.float64):
    op = build_operator(n, src, dst, val, valid=valid)
    arrs = operator_arrays(op, dtype=dtype, alpha=alpha, device=CPU)
    s0 = torch.from_numpy(op.valid * INITIAL_SCORE).to(dtype)
    if tol is None:
        return converge_sparse_fixed(arrs, s0, iters).numpy()
    s, it, delta = converge_sparse_adaptive(arrs, s0, tol=tol,
                                            max_iterations=iters)
    return s.numpy(), it, delta


# --- the mesh and its collectives --------------------------------------------

def test_make_mesh_needs_a_gpu_or_named_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.make_mesh(2)
    mesh = port.make_mesh(2, devices=[CPU] * 4)
    assert mesh.size == 2 and mesh.devices == (CPU, CPU)
    assert mesh.axis_names == (port.rows_axis,)
    with pytest.raises(ValueError):
        port.make_mesh(3, devices=[CPU] * 2)


@pytest.mark.parametrize("d", [2, 4, 8])
def test_collectives_match_their_definitions(d):
    """Each collective against the array it stands for: blocks of one
    global array, moved as ``lax``'s tiled collectives move them."""
    mesh = cpu_mesh(d)
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.integers(0, 1 << 20, (8 * d, 16 * d)))
    blocks = pmesh.shard(x, mesh)
    assert torch.equal(pmesh.unshard(blocks), x)
    for full in pmesh.all_gather(blocks, mesh):
        assert torch.equal(full, x)
    total = pmesh.psum([b.sum() for b in blocks], mesh)
    assert all(int(t) == int(x.sum()) for t in total)
    # all_to_all(split 1, concat 0) is the sharded transpose of the blocks
    swapped = pmesh.all_to_all(blocks, mesh, split_dim=1, concat_dim=0)
    for i, s in enumerate(swapped):
        assert torch.equal(s, x.chunk(d, 1)[i])
    back = pmesh.all_to_all(swapped, mesh, split_dim=0, concat_dim=1)
    assert all(torch.equal(a, b) for a, b in zip(back, blocks))
    # psum_scatter: shard i gets tile i of the sum of every shard's array
    parts = [torch.from_numpy(rng.integers(0, 1 << 20, (3, 4 * d)))
             for _ in range(d)]
    summed = sum(parts)
    for i, t in enumerate(pmesh.psum_scatter(parts, mesh, scatter_dim=1)):
        assert torch.equal(t, summed.chunk(d, 1)[i])
    perm = [((i + 1) % d, i) for i in range(d)]
    rolled = pmesh.ppermute(blocks, mesh, perm)
    assert all(torch.equal(rolled[i], blocks[(i + 1) % d]) for i in range(d))


# --- row-sharded gather converge (tests/test_sharded.py) ---------------------

@pytest.fixture(scope="module")
def graph():
    return barabasi_albert_edges(1000, 4, seed=11)


@pytest.mark.parametrize("d", [2, 8])
def test_sharded_operator_equals_reference(graph, d):
    src, dst, val = graph
    want = ref.build_sharded_operator(1000, src, dst, val, num_shards=d)
    got = port.build_sharded_operator(1000, src, dst, val, num_shards=d)
    for f in ("n", "n_pad", "n_local", "num_shards", "n_valid", "widths"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("bucket_idx", "bucket_val"):
        for a, b in zip(getattr(got, f), getattr(want, f)):
            assert np.array_equal(a, b), f
    for f in ("row_pos", "valid", "dangling"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("d", [2, 8])
def test_sharded_matches_reference_and_single_device_fixed(graph, d):
    src, dst, val = graph
    n = 1000
    rsop = ref.build_sharded_operator(n, src, dst, val, num_shards=d)
    want = np.asarray(ref.sharded_converge_fixed(
        rsop, rsop.initial_scores(INITIAL_SCORE, dtype=jnp.float64), 20,
        ref.make_mesh(d)))
    sop = port.build_sharded_operator(n, src, dst, val, num_shards=d)
    got = port.sharded_converge_fixed(
        sop, sop.initial_scores(INITIAL_SCORE, dtype=torch.float64), 20,
        cpu_mesh(d)).numpy()
    assert got.shape == want.shape == (sop.n_pad,)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    single = _single_gather(n, src, dst, val, 20)
    np.testing.assert_allclose(got[:n], single, rtol=1e-12)


def test_sharded_adaptive_matches_reference_and_converges(graph):
    src, dst, val = graph
    n, d = 1000, 8
    rsop = ref.build_sharded_operator(n, src, dst, val, num_shards=d)
    w_scores, w_iters, w_delta = ref.sharded_converge_adaptive(
        rsop, rsop.initial_scores(INITIAL_SCORE, dtype=jnp.float64),
        ref.make_mesh(d), tol=1e-7, max_iterations=300, alpha=0.1)
    sop = port.build_sharded_operator(n, src, dst, val, num_shards=d)
    scores, iters, delta = port.sharded_converge_adaptive(
        sop, sop.initial_scores(INITIAL_SCORE, dtype=torch.float64),
        cpu_mesh(d), tol=1e-7, max_iterations=300, alpha=0.1)
    scores = scores.numpy()[:n]
    assert delta <= 1e-7
    # conservation across shards (psum path)
    assert abs(scores.sum() - sop.n_valid * INITIAL_SCORE) < 1e-3
    assert iters == int(w_iters)
    np.testing.assert_allclose(scores, np.asarray(w_scores)[:n], rtol=1e-10)
    # the unsharded adaptive run, step for step
    single, s_iters, _ = _single_gather(n, src, dst, val, 300, alpha=0.1,
                                        tol=1e-7)
    assert iters == s_iters
    np.testing.assert_allclose(scores, single, rtol=1e-10)


def test_sharded_row_count_not_divisible():
    """n not divisible by shards: padding rows must not perturb scores."""
    n = 997  # prime
    src, dst, val = barabasi_albert_edges(n, 3, seed=13)
    sop = port.build_sharded_operator(n, src, dst, val, num_shards=8)
    assert sop.n_pad % 8 == 0 and sop.n_pad >= n
    out = port.sharded_converge_fixed(
        sop, sop.initial_scores(INITIAL_SCORE, dtype=torch.float64), 15,
        cpu_mesh(8)).numpy()
    assert np.all(out[n:] == 0)  # the padded tail carries no mass
    np.testing.assert_allclose(out[:n], _single_gather(n, src, dst, val, 15),
                               rtol=1e-12)


def test_sharded_with_invalid_peers_and_danglers():
    n = 640
    rng = np.random.default_rng(17)
    src, dst, val = barabasi_albert_edges(n, 3, seed=17)
    valid = rng.random(n) > 0.1  # ~10% invalid
    keep = rng.random(len(src)) > 0.05  # some valid peers become danglers
    src, dst, val = src[keep], dst[keep], val[keep]
    sop = port.build_sharded_operator(n, src, dst, val, valid=valid,
                                      num_shards=8)
    out = port.sharded_converge_fixed(
        sop, sop.initial_scores(INITIAL_SCORE, dtype=torch.float64), 20,
        cpu_mesh(8)).numpy()[:n]
    single = TorchSparseBackend(dtype=torch.float64, device=CPU) \
        .converge_edges(n, src, dst, val, valid, INITIAL_SCORE, 20)
    np.testing.assert_allclose(out, single, rtol=1e-10)
    assert abs(out.sum() - sop.n_valid * INITIAL_SCORE) < 1e-3


def test_sharded_operator_refuses_another_mesh_size(graph):
    src, dst, val = graph
    sop = port.build_sharded_operator(1000, src, dst, val, num_shards=4)
    with pytest.raises(ValueError, match="num_shards=2"):
        port.sharded_converge_fixed(sop, sop.initial_scores(1.0), 1,
                                    cpu_mesh(2))


# --- sharded Clos-routed converge (tests/test_sharded_routed.py) -------------

def _gather_reference(n, src, dst, val, valid, alpha, tol, iters):
    """The reference's float64 gather converge, the comparator of its own
    sharded routed tests."""
    from protocol_tpu.graph import build_operator as ref_build
    from protocol_tpu.ops.converge import (
        converge_sparse_adaptive as ref_adaptive,
        operator_arrays as ref_arrays,
    )

    gop = ref_build(n, src, dst, val, valid=valid)
    garrs = ref_arrays(gop, dtype=jnp.float64, alpha=alpha)
    s0 = jnp.asarray(gop.valid, dtype=jnp.float64) * 1000.0
    s, it, delta = ref_adaptive(garrs, s0, tol=tol, max_iterations=iters)
    return np.asarray(s), int(it), float(delta)


# The adaptive routed twins run in float64, in both packages. The
# reference's run in float32 and allow the gather and routed iteration
# counts to differ by one: at tol = 1e-6 a float32 stopping delta moves
# by several percent with the reduction order (per-shard sums, segment
# sums or matmuls), so two float32 engines can stop two sweeps apart. In
# float64 every engine stops at the same sweep and the scores agree to
# ~1e-13, so the counts are held equal and the scores to rtol 1e-9. The
# float32 sweep is held by the fixed-sweep test below.
F64 = torch.float64


def _routed_adaptive(op, d, tol, iters):
    return port.sharded_routed_converge_adaptive(
        op, op.initial_scores(1000.0, np.float64), cpu_mesh(d), tol=tol,
        max_iterations=iters, alpha=0.1, dtype=F64)


def test_sharded_routed_operator_equals_reference():
    n, m, d = 700, 4, 8
    src, dst, val = barabasi_albert_edges(n, m, seed=31)
    want = ref.build_sharded_routed_operator(n, src, dst, val, num_shards=d)
    got = port.build_sharded_routed_operator(n, src, dst, val, num_shards=d)
    for f in ("n", "n_valid", "nnz", "num_shards", "out_widths", "out_xs",
              "in_widths", "in_xs", "in_n_pos", "n_state_local", "edge_e",
              "edge_bits", "state_e", "state_bits"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("out_weight", "edge_stages", "state_stages"):
        assert len(getattr(got, f)) == len(getattr(want, f))
        for a, b in zip(getattr(got, f), getattr(want, f)):
            assert np.array_equal(a, b), f
    for f in ("state_to_node", "valid", "dangling"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("num_shards", [2, 8])
def test_sharded_routed_matches_gather_and_reference(num_shards):
    n, m = 700, 4
    src, dst, val = barabasi_albert_edges(n, m, seed=31)
    op = port.build_sharded_routed_operator(n, src, dst, val,
                                            num_shards=num_shards)
    scores, iters, delta = _routed_adaptive(op, num_shards, 1e-6, 300)
    sg, itg, _ = _gather_reference(n, src, dst, val, None, 0.1, 1e-6, 300)
    assert iters == itg
    assert delta <= 1e-6
    routed = op.scores_for_nodes(scores)
    np.testing.assert_allclose(routed, sg, rtol=1e-9)
    if num_shards != 8:
        return
    # the reference's sharded routed converge on the same operator, on
    # its virtual 8-device mesh
    rop = ref.build_sharded_routed_operator(n, src, dst, val,
                                            num_shards=num_shards)
    w_scores, w_iters, _ = ref.sharded_routed_converge_adaptive(
        rop, rop.initial_scores(1000.0, np.float64),
        ref.make_mesh(num_shards), tol=1e-6, max_iterations=300, alpha=0.1,
        dtype=jnp.float64)
    assert iters == int(w_iters)
    np.testing.assert_allclose(
        routed, rop.scores_for_nodes(np.asarray(w_scores)), rtol=1e-9)


def test_sharded_routed_fixed_and_conservation(monkeypatch):
    """Twenty fixed sweeps against the reference's, with the route-stage
    count the layout gives: every shard runs each route's 2·levels − 1
    stages, the level-0 ones as middle-form launches."""
    from protocol_tpu_torch.ops.kernels import lane_perm_kernel as lpk

    n, m, d = 900, 3, 8
    rng = np.random.default_rng(7)
    src, dst, val = barabasi_albert_edges(n, m, seed=8)
    valid = np.ones(n, dtype=bool)
    valid[rng.choice(n, 25, replace=False)] = False
    op = port.build_sharded_routed_operator(n, src, dst, val, valid=valid,
                                            num_shards=d)
    forms = []
    plain = lpk.route_stage_plain
    monkeypatch.setattr(lpk, "route_stage_plain",
                        lambda x, i, form, m=1: forms.append(form)
                        or plain(x, i, form, m))
    out = port.sharded_routed_converge_fixed(op, op.initial_scores(1000.0),
                                             20, cpu_mesh(d), alpha=0.1)
    assert len(forms) == 20 * port.routed.lane_perm_launches_per_sweep(op)
    assert port.routed.lane_perm_launches_per_sweep(op) == d * (
        2 * len(op.edge_bits) - 1 + 2 * len(op.state_bits) - 1)
    # per sweep and shard, each route's two level-0 stages are middle-form
    assert forms.count(lpk.MIDDLE) == 20 * d * (
        (3 if len(op.edge_bits) > 1 else 1)
        + (3 if len(op.state_bits) > 1 else 1))
    scores = op.scores_for_nodes(out)
    total = float(scores.sum())
    expected = op.n_valid * 1000.0
    assert abs(total - expected) / expected < 1e-4
    assert np.all(scores[~valid] == 0)  # invalidated peers hold no score
    rop = ref.build_sharded_routed_operator(n, src, dst, val, valid=valid,
                                            num_shards=d)
    want = rop.scores_for_nodes(np.asarray(ref.sharded_routed_converge_fixed(
        rop, rop.initial_scores(1000.0), 20, ref.make_mesh(d), alpha=0.1)))
    np.testing.assert_allclose(scores, want, rtol=1e-4, atol=0.5)


def test_sharded_routed_matches_single_device_routed():
    from protocol_tpu_torch.ops.routed import (
        build_routed_operator,
        converge_routed_adaptive,
        routed_arrays,
    )

    n, m, d = 640, 4, 4
    src, dst, val = barabasi_albert_edges(n, m, seed=12)
    sop = port.build_sharded_routed_operator(n, src, dst, val, num_shards=d)
    s_scores, s_iters, _ = _routed_adaptive(sop, d, 1e-6, 300)
    rop = build_routed_operator(n, src, dst, val)
    arrs, static = routed_arrays(rop, dtype=F64, alpha=0.1, device=CPU)
    r_scores, r_iters, _ = converge_routed_adaptive(
        arrs, static, torch.from_numpy(rop.initial_scores(1000.0,
                                                          np.float64)),
        tol=1e-6, max_iterations=300)
    assert s_iters == r_iters
    np.testing.assert_allclose(sop.scores_for_nodes(s_scores),
                               rop.scores_for_nodes(r_scores.numpy()),
                               rtol=1e-9)


def test_sharded_routed_hub_buckets():
    """A star-heavy graph forces w ≥ 128 (multi-lane-row) buckets on both
    sides; the sharded route must still agree with the gather path."""
    rng = np.random.default_rng(2)
    n, d = 600, 8
    others = np.arange(1, n)
    src = np.concatenate([np.full(n - 1, 0), others, rng.integers(1, n, 800)])
    dst = np.concatenate([others, np.full(n - 1, 0), rng.integers(1, n, 800)])
    val = rng.integers(1, 10, len(src)).astype(np.float64)
    op = port.build_sharded_routed_operator(n, src, dst, val, num_shards=d)
    assert max(op.in_widths) >= 128 or max(op.out_widths) >= 128
    scores, iters, _ = _routed_adaptive(op, d, 1e-6, 400)
    sg, itg, _ = _gather_reference(n, src, dst, val, None, 0.1, 1e-6, 400)
    assert iters == itg
    np.testing.assert_allclose(op.scores_for_nodes(scores), sg, rtol=1e-9)


def test_sharded_routed_checkpoint_resume(tmp_path):
    """An interrupted run resumes from the newest checkpoint and lands
    on the uninterrupted trajectory; the operator round-trips through
    its file, which refuses another shard count."""
    n, m, d = 512, 3, 8
    src, dst, val = barabasi_albert_edges(n, m, seed=17)
    mesh = cpu_mesh(d)
    built = port.build_sharded_routed_operator(n, src, dst, val,
                                               num_shards=d)
    built.save(tmp_path / "op.npz")
    with pytest.raises(ValueError, match="num_shards=8"):
        port.ShardedRoutedOperator.load(tmp_path / "op.npz", num_shards=4)
    op = port.ShardedRoutedOperator.load(tmp_path / "op.npz", num_shards=d)
    assert all(np.array_equal(a, b)
               for a, b in zip(op.edge_stages, built.edge_stages))
    s0 = torch.from_numpy(op.initial_scores(1000.0))
    ref_scores, ref_iters, _ = port.sharded_routed_converge_adaptive(
        op, s0, mesh, tol=1e-6, max_iterations=200, alpha=0.1)
    ck = CheckpointManager(str(tmp_path / "ck"))
    port.sharded_converge_checkpointed(
        op, s0, mesh, ck, tol=1e-6, max_iterations=6, alpha=0.1,
        checkpoint_every=3)
    assert ck.steps() == [3, 6]
    scores, total, delta = port.sharded_converge_checkpointed(
        op, s0, mesh, ck, tol=1e-6, max_iterations=200, alpha=0.1,
        checkpoint_every=50, resume=True)
    assert total == ref_iters
    assert delta <= 1e-6
    np.testing.assert_allclose(op.scores_for_nodes(scores),
                               op.scores_for_nodes(ref_scores),
                               rtol=1e-5, atol=1e-2)
    # a resume under another damping is refused, not blended
    with pytest.raises(ValueError, match="alpha"):
        port.sharded_converge_checkpointed(op, s0, mesh, ck, alpha=0.2)


def test_sharded_routed_rejects_bad_shard_count():
    src, dst, val = barabasi_albert_edges(100, 3, seed=1)
    with pytest.raises(ValueError, match="divide 128"):
        port.build_sharded_routed_operator(100, src, dst, val, num_shards=3)


# --- the checkpointed loop's retries (tests/test_aux.py) ---------------------

def test_run_with_retries(tmp_path):
    n = 400
    src, dst, val = barabasi_albert_edges(n, 3, seed=5)
    sop = port.build_sharded_operator(n, src, dst, val, num_shards=4)
    mesh = cpu_mesh(4)
    s0 = sop.initial_scores(1000.0, dtype=torch.float64)
    cm = CheckpointManager(str(tmp_path / "ck"))
    attempts = {"n": 0}

    def job():
        attempts["n"] += 1
        if attempts["n"] == 1:
            # a device failure after some progress
            port.sharded_converge_checkpointed(
                sop, s0, mesh, cm, tol=1e-8, max_iterations=10,
                checkpoint_every=5, alpha=0.2)
            raise RuntimeError("device lost")
        return port.sharded_converge_checkpointed(
            sop, s0, mesh, cm, tol=1e-8, max_iterations=150,
            checkpoint_every=5, alpha=0.2)

    out, iters, delta = port.run_with_retries(job)
    assert attempts["n"] == 2 and delta <= 1e-8
    single, s_iters, _ = _single_gather(n, src, dst, val, 150, alpha=0.2,
                                        tol=1e-8)
    assert iters == s_iters
    np.testing.assert_allclose(out.numpy()[:n], single, rtol=1e-10)


# --- sparse-scores --checkpoint-dir (tests/test_cli.py) ----------------------

def _cli_edges(path, n=48):
    rng = random.Random(10)
    edges = [(i, (i + 1) % n, 1.0) for i in range(n)]
    edges += [(i, rng.randrange(n), 2.0) for i in range(n)
              if rng.random() < 0.8]
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(e for e in edges if e[0] != e[1])


def _scores_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["peer_id", "score"]
    return np.asarray([float(r[1]) for r in rows[1:]])


def test_sparse_scores_checkpointed(tmp_path, capsys):
    """Beside the reference CLI on the same edges: both converge and
    write checkpoints, the port's on a one-shard CPU mesh, and their
    scores agree; a resume of a converged run exits at once with the
    same scores."""
    from protocol_tpu.cli.main import main as ref_main
    from protocol_tpu_torch.cli.main import main as port_main

    n = 48
    _cli_edges(tmp_path / "edges.csv", n)
    common = ["--assets", str(tmp_path), "sparse-scores", "--edges",
              "edges.csv", "--n", str(n), "--alpha", "0.2", "--tol", "1e-7"]
    assert ref_main([*common, "--checkpoint-dir", "ck_ref",
                     "--checkpoint-every", "10", "--out", "ref.csv"]) == 0
    port_args = [*common, "--checkpoint-dir", "ck", "--out", "port.csv",
                 "--device", "cpu"]
    assert port_main([*port_args, "--checkpoint-every", "10"]) == 0
    assert list((tmp_path / "ck").glob("step-*.npz"))
    assert list((tmp_path / "ck_ref").glob("step-*.npz"))
    out = capsys.readouterr().out
    assert out.count("converged after 36 iterations") == 2
    port_scores = _scores_csv(tmp_path / "port.csv")
    np.testing.assert_allclose(port_scores, _scores_csv(tmp_path / "ref.csv"),
                               rtol=1e-4, atol=0.5)
    # resume idempotently (already converged -> exits immediately, code 0)
    assert port_main(port_args) == 0
    assert "converged after 36 iterations" in capsys.readouterr().out
    np.testing.assert_array_equal(_scores_csv(tmp_path / "port.csv"),
                                  port_scores)


def test_sparse_scores_bad_checkpoint_every_clean_error(tmp_path, capsys):
    from protocol_tpu_torch.cli.main import main as port_main

    (tmp_path / "edges.csv").write_text("0,1,1.0\n1,0,1.0\n")
    base = ["--assets", str(tmp_path), "sparse-scores", "--edges",
            "edges.csv", "--n", "2", "--device", "cpu"]
    assert port_main([*base, "--checkpoint-dir", "ck",
                      "--checkpoint-every", "0"]) == 1
    assert "validation_error" in capsys.readouterr().err
    # checkpoint dir resolves under assets
    assert (tmp_path / "ck").exists()
    # a routed resume of a gather checkpoint is refused the same way
    assert port_main([*base, "--checkpoint-dir", "ck2"]) == 0
    assert port_main([*base, "--checkpoint-dir", "ck2", "--engine",
                      "routed"]) == 1
    assert "validation_error" in capsys.readouterr().err


# --- the dry run (__graft_entry__.dryrun_multichip) --------------------------

def test_dryrun_multichip_on_a_repeated_cpu_mesh(monkeypatch):
    from protocol_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(2, devices=[CPU] * 2)
    # with no devices given it takes the GPUs, and there are none here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)
