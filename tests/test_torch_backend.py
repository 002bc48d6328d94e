"""The port's backends, flagship entry and CLI against the reference's.

Both packages get the same inputs (numpy, from a seed). Where an
operator is involved, the reference builds it once and the port takes
it as is (``operator_from_numpy``), so the two converges differ only in
their arithmetic. Bounds: the reference's routed tests (iterations ±1,
rtol 1e-4, atol 0.5 in float32), and the rational oracle's (rtol 1e-4 /
atol 0.1 at 25 float32 sweeps; rtol 1e-9 / atol 1e-6 at 30 float64 ones).
"""

import csv
import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from protocol_tpu import backend as ref_backend
from protocol_tpu.graph import barabasi_albert_edges
from protocol_tpu.ops import routed as ref_routed
from protocol_tpu_torch import backend as port_backend
from protocol_tpu_torch.ops import routed as port_routed


def _carry(op):
    return port_routed.operator_from_numpy(
        {f.name: getattr(op, f.name) for f in dataclasses.fields(op)})


@pytest.fixture(scope="module")
def shared_graph():
    n = 1200
    src, dst, val = barabasi_albert_edges(n, 4, seed=5)
    valid = np.ones(n, dtype=bool)
    op = ref_routed.build_routed_operator(n, src, dst, val, valid)
    return n, src, dst, val, valid, op


def test_routed_backend_matches_reference_on_same_operator(shared_graph):
    n, src, dst, val, valid, op = shared_graph
    jb = ref_backend.JaxRoutedBackend()
    tb = port_backend.TorchRoutedBackend(device="cpu")
    pop = _carry(op)
    sr, ir, dr = jb.converge_edges(n, src, dst, val, valid, 1000.0, 300,
                                   tol=1e-6, alpha=0.1, operator=op)
    sp, ip, dp = tb.converge_edges(n, src, dst, val, valid, 1000.0, 300,
                                   tol=1e-6, alpha=0.1, operator=pop)
    assert isinstance(ip, int) and isinstance(dp, float)
    assert abs(ip - ir) <= 1 and dp <= 1e-6
    np.testing.assert_allclose(sp, sr, rtol=1e-4, atol=0.5)
    assert abs(sp.sum() - n * 1000.0) / (n * 1000.0) < 1e-4

    # fixed mode, and a warm start from the converged scores
    fr = jb.converge_edges(n, src, dst, val, valid, 1000.0, 20, alpha=0.1,
                           operator=op)
    fp = tb.converge_edges(n, src, dst, val, valid, 1000.0, 20, alpha=0.1,
                           operator=pop)
    np.testing.assert_allclose(fp, fr, rtol=1e-4, atol=0.5)
    wr = jb.converge_edges(n, src, dst, val, valid, 1000.0, 300, tol=1e-6,
                           alpha=0.1, operator=op, s0=sr)
    wp = tb.converge_edges(n, src, dst, val, valid, 1000.0, 300, tol=1e-6,
                           alpha=0.1, operator=pop, s0=sr)
    assert wp[1] < ip and abs(wp[1] - wr[1]) <= 1
    np.testing.assert_allclose(wp[0], wr[0], rtol=1e-4, atol=0.5)

    # the max-min algebra through the same operator: no rounding at all
    mr = ref_backend.JaxRoutedBackend(dtype=jnp.float64).converge_edges(
        n, src, dst, val, valid, 1000.0, 8, operator=op, semiring="maxplus")
    mp = port_backend.TorchRoutedBackend(
        dtype=torch.float64, device="cpu").converge_edges(
        n, src, dst, val, valid, 1000.0, 8, operator=pop, semiring="maxplus")
    assert np.array_equal(mp, mr)


def test_routed_backend_builds_its_own_operator():
    n = 300
    src, dst, val = barabasi_albert_edges(n, 3, seed=11)
    valid = np.ones(n, dtype=bool)
    want = ref_backend.JaxRoutedBackend().converge_edges(
        n, src, dst, val, valid, 1000.0, 20, alpha=0.1)
    got = port_backend.TorchRoutedBackend(device="cpu").converge_edges(
        n, src, dst, val, valid, 1000.0, 20, alpha=0.1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.5)


def test_sparse_backend_matches_reference(shared_graph):
    n, src, dst, val, valid, _ = shared_graph
    sr, ir, _ = ref_backend.JaxSparseBackend().converge_edges(
        n, src, dst, val, valid, 1000.0, 300, tol=1e-6, alpha=0.1)
    sp, ip, dp = port_backend.TorchSparseBackend(device="cpu").converge_edges(
        n, src, dst, val, valid, 1000.0, 300, tol=1e-6, alpha=0.1)
    assert abs(ip - ir) <= 1 and dp <= 1e-6
    np.testing.assert_allclose(sp, sr, rtol=1e-4, atol=0.5)


def test_routed_backends_match_rational_oracle_n10():
    n = 10
    rng = np.random.default_rng(21)
    mat = rng.integers(0, 6, size=(n, n)).astype(np.float64)
    np.fill_diagonal(mat, 0)
    oracle = port_backend.NativeRationalBackend().converge(mat, 1000.0, 25)
    assert np.array_equal(
        oracle, ref_backend.NativeRationalBackend().converge(mat, 1000.0, 25))
    src, dst = np.nonzero(mat)
    args = (n, src, dst, mat[src, dst], mat.sum(axis=1) > 0, 1000.0, 25)
    for backend in (ref_backend.JaxRoutedBackend(),
                    port_backend.TorchRoutedBackend(device="cpu")):
        np.testing.assert_allclose(backend.converge_edges(*args), oracle,
                                   rtol=1e-4, atol=0.1)
    dense = port_backend.TorchSparseBackend(device="cpu").converge(mat, 1000.0,
                                                                   25)
    np.testing.assert_allclose(dense, oracle, rtol=1e-4, atol=0.1)


def test_routed_backends_match_rational_oracle_n12_f64():
    from fractions import Fraction

    n = 12
    rng = np.random.default_rng(3)
    mat = rng.integers(0, 8, size=(n, n)).astype(np.float64)
    np.fill_diagonal(mat, 0)
    src, dst = np.nonzero(mat > 0)
    row_sums = mat.sum(axis=1)
    c = [[Fraction(0)] * n for _ in range(n)]
    for i in range(n):
        for j in range(n):
            if row_sums[i] > 0:
                c[i][j] = Fraction(int(mat[i, j]), int(row_sums[i]))
            elif i != j:
                c[i][j] = Fraction(1, n - 1)  # dangling redistribution
    s = [Fraction(1000)] * n
    for _ in range(30):
        s = [sum(c[j][i] * s[j] for j in range(n)) for i in range(n)]
    expected = np.array([float(x) for x in s])
    args = (n, src, dst, mat[src, dst], None, 1000.0, 30)
    for backend in (ref_backend.JaxRoutedBackend(dtype=jnp.float64),
                    port_backend.TorchRoutedBackend(dtype=torch.float64,
                                                    device="cpu")):
        np.testing.assert_allclose(backend.converge_edges(*args), expected,
                                   rtol=1e-9, atol=1e-6)


def test_sparse_backend_rejects_unfiltered_matrix():
    mat = np.zeros((3, 3))
    mat[0, 1] = 1.0  # peer 1 has no row but receives trust
    with pytest.raises(ValueError, match="not filtered"):
        port_backend.TorchSparseBackend(device="cpu").converge(mat, 1.0, 3)


def test_entry_twin_matches_reference_entry():
    import __graft_entry__
    from protocol_tpu_torch.entry import entry

    fn_r, args_r = __graft_entry__.entry()
    want = np.asarray(fn_r(*args_r))
    fn_p, args_p = entry(device="cpu")
    got = fn_p(*args_p).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.5)


@pytest.mark.parametrize("engine", ["routed", "gather"])
def test_cli_matches_reference_cli(tmp_path, engine, capsys):
    from protocol_tpu.cli.main import main as ref_main
    from protocol_tpu_torch.cli.main import main as port_main

    rng = np.random.default_rng(4)
    n = 200
    rows = [(i, int(j), int(rng.integers(1, 100)))
            for i in range(n) for j in rng.integers(0, n, 3) if j != i]
    with open(tmp_path / "edges.csv", "w", newline="") as f:
        csv.writer(f).writerows(rows)
    common = ["sparse-scores", "--edges", "edges.csv", "--n", str(n),
              "--alpha", "0.1", "--engine", engine]
    assert ref_main(["--assets", str(tmp_path), *common,
                     "--out", "ref.csv"]) == 0
    ref_out = capsys.readouterr().out
    assert port_main(["--assets", str(tmp_path), *common, "--out",
                      "port.csv", "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    assert ref_out.split(":")[0] == port_out.split(":")[0]  # "n peers, k edges"
    with open(tmp_path / "ref.csv") as f:
        want = list(csv.reader(f))
    with open(tmp_path / "port.csv") as f:
        got = list(csv.reader(f))
    assert got[0] == want[0] == ["peer_id", "score"] and len(got) == n + 1
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose([float(r[1]) for r in got[1:]],
                               [float(r[1]) for r in want[1:]],
                               rtol=1e-4, atol=0.5)


def test_cli_refuses_what_it_cannot_do(tmp_path, capsys):
    from protocol_tpu_torch.cli.main import main as port_main

    with open(tmp_path / "edges.csv", "w") as f:
        f.write("0,1,1\n1,0,1\n")
    base = ["--assets", str(tmp_path), "sparse-scores", "--edges",
            "edges.csv", "--device", "cpu"]
    assert port_main([*base, "--n", "2", "--checkpoint-dir", "ck"]) == 1
    assert "not available" in capsys.readouterr().err
    assert port_main([*base, "--n", "1"]) == 1
    assert "endpoints" in capsys.readouterr().err
    (tmp_path / "empty.csv").write_text("")
    assert port_main(["--assets", str(tmp_path), "sparse-scores", "--edges",
                      "empty.csv", "--n", "2", "--device", "cpu"]) == 1
