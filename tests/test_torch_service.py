"""The port's trust-scores service (``protocol_tpu_torch.service``) held
to the reference's service tests (``tests/test_service.py``, one twin
each, with injected provers where the reference injects them) against
the port's mock devnet, on the CPU: tail → ingest → incremental
refresh → HTTP serving → proof jobs → fault injection → graceful drain
→ kill/restart durability (``test_torch_service_durability``); the
slice parity test (``test_torch_service_parity``) tails one chain with
the reference's daemon and the port's, side by side."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import torch

from protocol_tpu_torch.client import Client, ClientConfig
from protocol_tpu_torch.client.chain import RpcChain
from protocol_tpu_torch.client.eth import (
    address_from_public_key,
    ecdsa_keypairs_from_mnemonic,
)
from protocol_tpu_torch.client.mocknode import MockNode
from protocol_tpu_torch.service import (
    FaultInjector,
    ProofJobQueue,
    QueueFullError,
    ServiceConfig,
    TrustService,
)
from protocol_tpu_torch.utils.errors import EigenError

MNEMONIC = "test test test test test test test test test test test junk"


def _get(url, expect=200):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        assert e.code == expect, (e.code, e.read())
        return e.code, json.loads(e.read())


def _get_text(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.read().decode()


def _post(url, obj, expect=(202,)):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert resp.status in expect
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        assert e.code in expect, (e.code, e.read())
        return e.code, json.loads(e.read())


def _wait(pred, timeout=30.0, interval=0.05, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture()
def devnet():
    node = MockNode()
    url = node.start()
    yield node, url
    node.stop()


def _make_service(tmp_path, node_url, provers=None, state_dir=None,
                  chain=None, backend=None, **svc_overrides):
    if chain is None:
        deployer = ecdsa_keypairs_from_mnemonic(MNEMONIC, 1)[0]
        chain = RpcChain.deploy_signed(node_url, deployer)
    config = ClientConfig(
        as_address="0x" + chain.contract_address.hex(),
        node_url=node_url, domain="0x" + "00" * 20)
    client = Client(config, MNEMONIC, device="cpu")
    overrides = dict(
        port=0, poll_interval=0.05, refresh_interval=0.05,
        tol=1e-10, backoff_base=0.05, backoff_max=0.2,
        drain_timeout=10.0)
    overrides.update(svc_overrides)
    svc = TrustService(
        client, ServiceConfig(**overrides), str(tmp_path / "cursor"),
        provers=provers or {"echo": lambda params: {"echo": params}},
        faults=FaultInjector({"rpc": 0.0, "device": 0.0, "disk": 0.0},
                             seed=7),
        state_dir=state_dir, backend=backend)
    return svc, client


def _attest_round(client, kps, addrs, values):
    """Every peer attests every other with ``values[(i, j)]``."""
    for i, kp in enumerate(kps):
        client.keypairs[0] = kp
        for j in range(len(kps)):
            if i != j:
                client.attest(addrs[j], values[(i, j)])


def _oracle(client, base_kp):
    """The batch local-scores oracle over the SAME chain contents."""
    client.keypairs[0] = base_kp
    atts = client.get_attestations()
    scores = client.calculate_scores(atts)
    return {s.address: float(s.ratio) for s in scores}


def test_service_end_to_end(tmp_path, devnet):
    """The acceptance flow: start → stream 2 attestation batches →
    HTTP scores match the batch oracle after each → a proof job
    completes → injected RPC faults retry without dropping the cursor →
    /metrics exposes ingest/refresh/proof counters → drain is clean."""
    _, node_url = devnet
    svc, client = _make_service(tmp_path, node_url)
    url = svc.start()
    try:
        kps = ecdsa_keypairs_from_mnemonic(MNEMONIC, 3)
        addrs = [address_from_public_key(kp.public_key) for kp in kps]

        # --- batch 1 ------------------------------------------------------
        _attest_round(client, kps, addrs,
                      {(i, j): 4 + (i + 2 * j) % 5
                       for i in range(3) for j in range(3) if i != j})
        expected = _oracle(client, kps[0])
        _wait(lambda: svc.refresher.table.revision == svc.graph.revision
              and svc.graph.n == 3,
              what="batch 1 scored")
        _, scores1 = _get(f"{url}/scores")
        got = {bytes.fromhex(r["address"].removeprefix("0x")): r["score"]
               for r in scores1["scores"]}
        assert set(got) == set(expected)
        for addr, ref in expected.items():
            assert got[addr] == pytest.approx(ref, rel=1e-3), \
                f"peer 0x{addr.hex()} diverged from the batch oracle"

        # --- injected RPC faults: retries, cursor intact ------------------
        cursor_before = svc.tailer.cursor
        retries_before = svc.tailer.retries
        svc.faults.rates["rpc"] = 1.0
        _wait(lambda: svc.tailer.retries >= retries_before + 2,
              what="injected RPC faults to be retried")
        assert svc.tailer.cursor == cursor_before, \
            "a failed poll moved the block cursor"
        assert svc.faults.injected["rpc"] >= 2
        svc.faults.rates["rpc"] = 0.0

        # --- batch 2: re-attestations + a new peer (warm refresh) ---------
        kps4 = ecdsa_keypairs_from_mnemonic(MNEMONIC, 4)
        addrs4 = [address_from_public_key(kp.public_key) for kp in kps4]
        _attest_round(client, kps4, addrs4,
                      {(i, j): 1 + (3 * i + j) % 7
                       for i in range(4) for j in range(4) if i != j})
        expected2 = _oracle(client, kps4[0])
        _wait(lambda: svc.graph.n == 4
              and svc.refresher.table.revision == svc.graph.revision,
              what="batch 2 scored")
        for addr, ref in expected2.items():
            code, one = _get(f"{url}/score/0x{addr.hex()}")
            assert code == 200
            assert one["score"] == pytest.approx(ref, rel=1e-3)
        assert svc.refresher.refreshes >= 2
        assert svc.tailer.cursor > cursor_before

        # --- batch 3: ONE changed attestation → warm incremental refresh
        # (reset the edit counter so the staleness bound deterministically
        # classifies the single edit as warm-startable regardless of how
        # the poll loop happened to slice batch 2)
        svc.graph.mark_cold()
        client.keypairs[0] = kps4[0]
        client.attest(addrs4[1], 255)
        expected3 = _oracle(client, kps4[0])
        assert expected3 != expected2  # the edit moves the fixed point
        _wait(lambda: svc.refresher.table.revision == svc.graph.revision
              and _get(f"{url}/score/0x{addrs4[1].hex()}")[1]["score"]
              == pytest.approx(expected3[addrs4[1]], rel=1e-3),
              what="batch 3 scored")
        for addr, ref in expected3.items():
            assert _get(f"{url}/score/0x{addr.hex()}")[1]["score"] \
                == pytest.approx(ref, rel=1e-3)
        assert svc.refresher.cold_refreshes < svc.refresher.refreshes, \
            "no refresh ever warm-started"

        # unknown peer → 404; bad address → 400
        code, _ = _get(f"{url}/score/0x" + "ee" * 20, expect=404)
        assert code == 404
        code, _ = _get(f"{url}/score/zzz", expect=400)
        assert code == 400

        # --- proof job over HTTP ------------------------------------------
        code, job = _post(f"{url}/proofs",
                          {"kind": "echo", "params": {"tag": 42}})
        assert code == 202
        _wait(lambda: _get(f"{url}/proofs/{job['job_id']}")[1]["status"]
              == "done", what="proof job completion")
        _, done = _get(f"{url}/proofs/{job['job_id']}")
        assert done["result"] == {"echo": {"tag": 42}}
        code, _ = _post(f"{url}/proofs", {"kind": "nope"}, expect=(400,))
        assert code == 400
        code, _ = _get(f"{url}/proofs/job-999", expect=404)
        assert code == 404

        # --- health + metrics ---------------------------------------------
        _, health = _get(f"{url}/healthz")
        assert health["ok"] and not health["draining"]
        assert health["peers"] == 4 and health["block_cursor"] > 0
        metrics = _get_text(f"{url}/metrics")
        for needle in ("ptpu_service_ingest_attestations",
                       "ptpu_service_refresh_total",
                       "ptpu_service_proof_completed",
                       "ptpu_service_block_cursor",
                       "ptpu_span_seconds_total"):
            assert needle in metrics, f"/metrics missing {needle}"
    finally:
        assert svc.shutdown() is True, "drain was not clean"
    # post-drain: POSTs are refused (the server is down entirely)
    with pytest.raises(urllib.error.URLError):
        _get(f"{url}/healthz")


def test_cursor_survives_restart(tmp_path, devnet):
    """A restarted service resumes from the persisted cursor: already-
    delivered blocks are not re-fetched (from_block > cursor), and new
    attestations keep flowing."""
    _, node_url = devnet
    svc, client = _make_service(tmp_path, node_url)
    svc.start()
    kps = ecdsa_keypairs_from_mnemonic(MNEMONIC, 2)
    addrs = [address_from_public_key(kp.public_key) for kp in kps]
    _attest_round(client, kps, addrs, {(0, 1): 5, (1, 0): 7})
    _wait(lambda: svc.tailer.attestations == 2, what="first service ingest")
    cursor = svc.tailer.cursor
    assert svc.shutdown() is True

    svc2, client2 = _make_service(tmp_path, node_url)
    # same contract: point the second service at the FIRST deployment
    svc2.client.chain = client.chain
    svc2.tailer.chain = client.chain
    assert svc2.tailer.cursor == cursor, "cursor did not persist"
    svc2.start()
    try:
        client.keypairs[0] = kps[0]
        client.attest(addrs[1], 9)
        _wait(lambda: svc2.tailer.cursor > cursor, what="resumed tailing")
        # only the post-restart block was delivered to the sink
        assert svc2.tailer.attestations == 1
    finally:
        svc2.shutdown()


def test_proof_queue_backpressure():
    """Bounded queue: submits beyond capacity raise QueueFullError
    (→ HTTP 429), the worker drains FIFO, failures are isolated, and
    drain cancels what it cannot finish."""
    gate = threading.Event()
    done = []

    def slow(params):
        gate.wait(10)
        done.append(params["i"])
        return {"i": params["i"]}

    def boom(params):
        raise EigenError("proving_error", "synthetic failure")

    q = ProofJobQueue({"slow": slow, "boom": boom}, capacity=2)
    q.start()
    running = q.submit("slow", {"i": 0})
    # let the worker claim job 0 so the QUEUE (not the worker) fills
    deadline = time.monotonic() + 5
    while q.get(running.job_id).status != "running":
        assert time.monotonic() < deadline
        time.sleep(0.01)
    q.submit("slow", {"i": 1})
    q.submit("boom", {"i": 2})
    with pytest.raises(QueueFullError):
        q.submit("slow", {"i": 3})
    with pytest.raises(EigenError, match="unknown proof kind"):
        q.submit("nope", {})
    gate.set()
    deadline = time.monotonic() + 10
    while q.completed + q.failed < 3:
        assert time.monotonic() < deadline, "worker stalled"
        time.sleep(0.01)
    assert done == [0, 1]
    assert q.failed == 1
    boom_job = [q.get(f"job-{i}") for i in (1, 2, 3)][2]
    assert boom_job.status == "failed"
    assert "synthetic failure" in boom_job.error
    assert q.drain(5.0) is True
    with pytest.raises(EigenError, match="draining"):
        q.submit("slow", {"i": 9})


def test_device_fault_injection_keeps_table_live(tmp_path, devnet):
    """An injected device fault fails one refresh; the previously
    published table stays served and the retry converges once the
    fault clears."""
    _, node_url = devnet
    svc, client = _make_service(tmp_path, node_url)
    url = svc.start()
    try:
        kps = ecdsa_keypairs_from_mnemonic(MNEMONIC, 2)
        addrs = [address_from_public_key(kp.public_key) for kp in kps]
        _attest_round(client, kps, addrs, {(0, 1): 5, (1, 0): 7})
        _wait(lambda: svc.refresher.table.revision == svc.graph.revision
              and svc.graph.n == 2, what="initial scores")
        table_rev = svc.refresher.table.revision

        svc.faults.rates["device"] = 1.0
        client.keypairs[0] = kps[0]
        client.attest(addrs[1], 2)
        _wait(lambda: svc.graph.revision > table_rev,
              what="ingest past the fault")
        time.sleep(0.3)  # a few refresh attempts under 100% fault rate
        assert svc.refresher.table.revision == table_rev, \
            "a faulted refresh replaced the published table"
        _, scores = _get(f"{url}/scores")  # still served
        assert len(scores["scores"]) == 2

        svc.faults.rates["device"] = 0.0
        _wait(lambda: svc.refresher.table.revision == svc.graph.revision,
              what="refresh recovery after the fault cleared")
        assert svc.faults.injected["device"] >= 1
    finally:
        svc.shutdown()


def test_warm_start_matches_cold_fixed_point():
    """ops.converge.warm_start_scores + the backend ``s0`` seam: a
    warm-started adaptive converge lands on the SAME fixed point as a
    cold one (same tolerance), in no more iterations."""
    from protocol_tpu_torch.backend import TorchSparseBackend
    from protocol_tpu_torch.graph import barabasi_albert_edges
    from protocol_tpu_torch.ops.converge import warm_start_scores

    n = 400
    src, dst, val = barabasi_albert_edges(n, 3, seed=3)
    valid = np.ones(n, dtype=bool)
    backend = TorchSparseBackend(dtype=torch.float64, device="cpu")
    # damping guarantees geometric convergence at rate (1-alpha): the
    # mutual-attestation BA graph has a period-2 mode that undamped
    # power iteration never fully sheds (delta plateaus ~5e-5)
    tol, alpha = 1e-10, 0.1
    cold, cold_iters, _ = backend.converge_edges(
        n, src, dst, val, valid, 1000.0, 500, tol=tol, alpha=alpha)

    # perturb one row's weights (a "small slice" of the matrix) and
    # re-converge both ways
    val2 = val.copy()
    val2[src == 7] *= 3.0
    cold2, cold2_iters, d2 = backend.converge_edges(
        n, src, dst, val2, valid, 1000.0, 500, tol=tol, alpha=alpha)
    s0 = warm_start_scores(cold, n, valid, 1000.0)
    warm2, warm2_iters, dw = backend.converge_edges(
        n, src, dst, val2, valid, 1000.0, 500, tol=tol, alpha=alpha,
        s0=s0)
    assert dw <= tol and d2 <= tol
    np.testing.assert_allclose(warm2, cold2, rtol=1e-6, atol=1e-8)
    assert warm2_iters <= cold2_iters, \
        (warm2_iters, cold2_iters, "warm start did not help")
    # mass conservation through the warm start
    assert np.isclose(warm2.sum(), n * 1000.0, rtol=1e-6)


def test_history_eviction_never_drops_live_jobs():
    """Regression: eviction used to size excess off len(self._jobs)
    including pending entries, over-evicting terminal history whenever
    jobs were in flight; it must bound the TERMINAL count alone and
    never touch queued/running jobs."""
    gate = threading.Event()

    def slow(params):
        gate.wait(10)
        return {}

    q = ProofJobQueue({"fast": lambda p: {}, "slow": slow},
                      capacity=16, history=3)
    q.start()
    fast = [q.submit("fast", {}) for _ in range(3)]
    deadline = time.monotonic() + 10
    while q.completed < 3:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    # exactly `history` terminal jobs retained; park a slow job so one
    # is RUNNING, then queue more — none of that may evict history
    running = q.submit("slow", {})
    while q.get(running.job_id).status != "running":
        assert time.monotonic() < deadline
        time.sleep(0.01)
    queued = [q.submit("slow", {}) for _ in range(4)]
    for j in fast:
        got = q.get(j.job_id)
        assert got is not None and got.status == "done", \
            "in-flight jobs evicted terminal history inside the bound"
    for j in [running] + queued:
        assert q.get(j.job_id) is not None, "a live job was evicted"
    # overflow still evicts: more completions push the oldest out
    gate.set()
    deadline = time.monotonic() + 10
    while q.completed < 3 + 1 + 4:
        assert time.monotonic() < deadline, "worker stalled"
        time.sleep(0.01)
    for _ in range(2):
        q.submit("fast", {})
    while q.completed < 10:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    q.submit("fast", {})  # eviction runs on submit
    with q._lock:
        terminal = [j for j in q._jobs.values()
                    if j.status in ("done", "failed", "cancelled")]
        # the bound, +1 for the job that may have completed since the
        # last submit-time eviction ran
        assert len(terminal) <= 4
    assert q.get(fast[0].job_id) is None, "history bound not enforced"
    q.drain(5.0)


def test_refresher_routed_operator_cache(tmp_path):
    """Past ``routed_edge_threshold`` the refresh runs through
    TorchRoutedBackend with a digest-keyed operator cache: a fresh
    refresher on the same graph (the restart shape) LOADS the compiled
    operator instead of rebuilding, warm vectors flow through
    ``scores_from_nodes``, and the scores match the gather backend."""
    from types import SimpleNamespace

    from protocol_tpu_torch.backend import TorchSparseBackend
    from protocol_tpu_torch.service.refresh import ScoreRefresher
    from protocol_tpu_torch.service.state import OpinionGraph

    def att(i, j, v):
        return SimpleNamespace(attestation=SimpleNamespace(
            about=bytes([j + 1]) * 20, value=v))

    def build_graph():
        g = OpinionGraph()
        batch = [att(i, j, 2 + (i + 3 * j) % 7)
                 for i in range(5) for j in range(5) if i != j]
        # signer = row owner: peer i attests the 4 others
        signers = []
        for i in range(5):
            signers.extend([bytes([i + 1]) * 20] * 4)
        g.apply(batch, signers)
        return g

    cache_dir = str(tmp_path / "ops")
    config = ServiceConfig(routed_edge_threshold=1, tol=1e-10,
                           max_iterations=400, cold_every=0)
    backend = TorchSparseBackend(dtype=torch.float64, device="cpu")

    graph = build_graph()
    r1 = ScoreRefresher(graph, config, backend=backend,
                        operator_cache_dir=cache_dir)
    t1 = r1.refresh()
    assert r1.operator_builds == 1 and r1.operator_hits == 0
    assert len(t1.scores) == 5

    # ground truth through the plain gather backend
    n, src, dst, val, _, _ = graph.snapshot()
    ref, _, _ = backend.converge_edges(
        n, src, dst, val, np.ones(n, dtype=bool), config.initial_score,
        config.max_iterations, tol=config.tol)
    np.testing.assert_allclose(t1.scores, ref, rtol=1e-6, atol=1e-8)

    # restart shape: same graph, fresh refresher, same cache dir →
    # the operator is LOADED, not rebuilt
    r2 = ScoreRefresher(build_graph(), config, backend=backend,
                        operator_cache_dir=cache_dir)
    t2 = r2.refresh()
    assert r2.operator_builds == 0 and r2.operator_hits == 1, \
        "the on-disk operator cache was not reused"
    np.testing.assert_allclose(t2.scores, t1.scores, rtol=1e-9)

    # steady state: the in-memory slot answers without touching disk
    n, src, dst, val, _, _ = r2.graph.snapshot()
    import shutil

    shutil.rmtree(cache_dir)
    op = r2._routed_operator(n, src, dst, val, np.ones(n, dtype=bool))
    assert op is not None
    assert r2.operator_hits == 2 and r2.operator_builds == 0

    # a warm refresh routes through the routed backend's
    # scores_from_nodes path and converges to the perturbed fixed point
    g = r2.graph
    g.apply([att(0, 1, 9)], [bytes([1]) * 20])
    t3 = r2.refresh()
    assert t3.revision == g.revision
    assert not t3.cold, "the single-edit refresh should warm-start"


def test_status_endpoint_schema_and_scrape_lint(tmp_path, devnet):
    """``GET /status`` serves the operator JSON (uptime, cursor, graph,
    freshness, queue, last refresh) and ``/metrics`` passes the pure-
    python exposition lint with the typed observability series."""
    from protocol_tpu_torch.service.metrics import lint_exposition

    _, node_url = devnet
    svc, client = _make_service(tmp_path, node_url,
                                state_dir=str(tmp_path / "state"))
    url = svc.start()
    try:
        kps = ecdsa_keypairs_from_mnemonic(MNEMONIC, 2)
        addrs = [address_from_public_key(kp.public_key) for kp in kps]
        _attest_round(client, kps, addrs, {(0, 1): 5, (1, 0): 7})
        _wait(lambda: svc.graph.n_edges == 2
              and svc.refresher.table.revision == svc.graph.revision,
              what="scores published")

        code, status = _get(f"{url}/status")
        assert code == 200
        assert status["ok"] and not status["draining"]
        assert status["uptime_seconds"] > 0
        assert status["block_cursor"] == svc.tailer.cursor
        assert status["graph"]["peers"] == 2
        assert status["graph"]["edges"] == 2
        assert status["tailer"]["attestations"] == 2
        assert 0.0 <= status["score_freshness_seconds"] < 60.0
        last = status["last_refresh"]
        assert last["revision"] == svc.graph.revision
        assert last["iterations"] >= 1 and last["refreshes"] >= 1
        assert isinstance(last["cold"], bool)
        assert status["queue"] == {"depth": 0, "completed": 0,
                                   "failed": 0}
        assert status["store"]["wal_segments"] >= 1

        metrics = _get_text(f"{url}/metrics")
        errors = lint_exposition(metrics)
        assert not errors, "scrape lint failed:\n" + "\n".join(errors)
        for needle in ("ptpu_http_request_seconds_bucket",
                       "ptpu_wal_append_seconds_bucket",
                       "ptpu_refresh_seconds_bucket",
                       "ptpu_score_freshness_seconds",
                       "ptpu_service_ingest_attestations_total",
                       "ptpu_span_total"):
            assert needle in metrics, f"/metrics missing {needle}"
        # per-request middleware: the request id comes back as a header
        with urllib.request.urlopen(f"{url}/healthz", timeout=10) as r:
            assert r.headers.get("X-Request-Id", "").startswith("req-")
    finally:
        assert svc.shutdown() is True


def test_score_freshness_drops_after_refresh(tmp_path, devnet):
    """``ptpu_score_freshness_seconds`` measures ingest→served lag: a
    pending (unrefreshed) batch leaves the gauge anchored at the OLD
    newest-reflected attestation, and the refresh that publishes the
    new batch snaps it down to the new one's arrival time."""
    _, node_url = devnet
    svc, client = _make_service(tmp_path, node_url)
    # no threads: drive the tailer + refresher by hand for determinism
    kps = ecdsa_keypairs_from_mnemonic(MNEMONIC, 2)
    addrs = [address_from_public_key(kp.public_key) for kp in kps]
    assert svc.score_freshness_seconds() == -1.0, \
        "freshness must be the 'never' sentinel before any ingest"

    _attest_round(client, kps, addrs, {(0, 1): 5, (1, 0): 7})
    svc.tailer.poll_once()
    assert svc.score_freshness_seconds() == -1.0, \
        "an ingested-but-unpublished batch is not reflected yet"
    svc.refresher.refresh()
    first = svc.score_freshness_seconds()
    assert 0.0 <= first < 10.0

    time.sleep(0.3)
    aged = svc.score_freshness_seconds()
    assert aged >= first + 0.25, "freshness must age with wall time"

    # a new attestation arrives but is NOT yet refreshed: the gauge
    # stays anchored at the old batch (still aging)...
    client.keypairs[0] = kps[0]
    client.attest(addrs[1], 9)
    svc.tailer.poll_once()
    before = svc.score_freshness_seconds()
    assert before >= aged
    # ... and the refresh that publishes it drops the gauge
    svc.refresher.refresh()
    after = svc.score_freshness_seconds()
    assert after < before, \
        f"freshness did not drop after the refresh ({after} vs {before})"
    assert 0.0 <= after < 1.0
    if svc.store is not None:
        svc.store.close()


def test_warm_start_scores_projection():
    """The projection contract: new peers seeded at initial_score,
    invalid zeroed, total mass rescaled to n_valid·initial."""
    from protocol_tpu_torch.ops.converge import warm_start_scores

    prev = np.array([3000.0, 1000.0])
    valid = np.array([True, True, True, False])
    s = warm_start_scores(prev, 4, valid, 1000.0)
    assert s.shape == (4,)
    assert s[3] == 0.0
    assert np.isclose(s.sum(), 3 * 1000.0)
    # relative order of carried-over scores is preserved
    assert s[0] / s[1] == pytest.approx(3.0)
    # degenerate all-zero carry-over falls back to cold uniform
    s2 = warm_start_scores(np.zeros(2), 3, np.ones(3, dtype=bool), 10.0)
    np.testing.assert_allclose(s2, [10.0, 10.0, 10.0])


def test_stages_route(tmp_path, devnet):
    """Device-layer observability on the live service: ``GET /stages``
    serves the per-stage p50/p95 summary, ``/status`` carries the
    reference's compile stats block (zero compiles on torch) with the
    steady-state recompile latch unfired, and
    the declared stage/converge instrument families render on
    ``/metrics`` (converge series with real samples from the
    refreshes)."""
    _, node_url = devnet
    svc, client = _make_service(tmp_path, node_url)
    url = svc.start()
    try:
        kps = ecdsa_keypairs_from_mnemonic(MNEMONIC, 2)
        addrs = [address_from_public_key(kp.public_key) for kp in kps]
        _attest_round(client, kps, addrs, {(0, 1): 4, (1, 0): 9})
        _wait(lambda: svc.refresher.table.revision == svc.graph.revision
              and svc.refresher.refreshes >= 1,
              what="first refresh published")

        code, stages = _get(f"{url}/stages")
        assert code == 200
        ref = stages["stages"].get("service.refresh")
        assert ref is not None and ref["count"] >= 1
        assert 0.0 <= ref["p50_s"] <= ref["p95_s"] <= ref["max_s"]
        assert stages["xla"]["steady_recompiles"] == 0

        # the service runs in-process, so /status must mirror the
        # process-global tracker; bracket the GET so a compile racing
        # the request cannot flake the equality
        from protocol_tpu_torch.utils import trace
        before = trace.TRACER.compile_tracker.stats()["compiles"]
        code, status = _get(f"{url}/status")
        after = trace.TRACER.compile_tracker.stats()["compiles"]
        assert code == 200
        xla = status["xla"]
        assert xla["recompile_warning"] is False
        assert xla["steady_recompiles"] == 0
        assert before <= xla["compiles"] <= after

        metrics = _get_text(f"{url}/metrics")
        for needle in ("# TYPE ptpu_prover_stage_seconds histogram",
                       "# TYPE ptpu_converge_sweep_seconds histogram",
                       "# TYPE ptpu_xla_compiles_total counter",
                       "ptpu_converge_iterations"):
            assert needle in metrics, f"/metrics missing {needle!r}"
        # steady recompiles: sum EVERY series of the family (real
        # latches land on {site=...}-labeled series; the unlabeled
        # declare_instruments zero alone would prove nothing)
        steady = [float(line.split()[-1])
                  for line in metrics.splitlines()
                  if line.startswith("ptpu_xla_steady_recompiles_total")]
        assert steady and sum(steady) == 0.0, steady
        assert "ptpu_converge_sweep_seconds_bucket" in metrics
    finally:
        assert svc.shutdown() is True


def test_profile_job_capture_window(tmp_path, devnet):
    """The ``profile`` job kind (the live-daemon capture window the
    ``profile --workload daemon`` verb submits): runs on the proof
    worker, holds a device_trace open for the clamped window, and
    returns the ``torch.profiler`` log dir with the job id as the
    directory tag —
    the trace-id join key against the JSONL stream."""
    from protocol_tpu_torch.service.provers import make_profile_prover

    _, node_url = devnet
    out_root = tmp_path / "assets"
    out_root.mkdir()
    svc, _ = _make_service(
        tmp_path, node_url,
        provers={"profile": make_profile_prover(out_root)})
    url = svc.start()
    try:
        code, job = _post(f"{url}/proofs",
                          {"kind": "profile",
                           "params": {"seconds": 0.2}})
        assert code == 202
        job_id = job["job_id"]
        _wait(lambda: (svc.jobs.get(job_id) or job).status == "done",
              what="profile capture window")
        result = svc.jobs.get(job_id).result
        assert result["seconds"] == pytest.approx(0.2)
        assert result["log_dir"].endswith(f"profiles/{job_id}")
        assert "steady_recompiles" in result["xla"]
    finally:
        assert svc.shutdown() is True


def test_recover_signers_auto_rule_follows_the_device(monkeypatch):
    """The sink's auto rule: 32 lanes or more and a CUDA device present
    take the batched recovery, on the client's device; a client on the
    CPU keeps the scalar path even where a card is present."""
    from protocol_tpu_torch.client import ingest
    from protocol_tpu_torch.service import state

    calls = []

    def batched(atts, device=None):
        calls.append((len(atts), device))
        return [None] * len(atts), [b"\x01" * 20] * len(atts), \
            np.ones(len(atts), dtype=bool)

    monkeypatch.setattr(ingest, "recover_signers_batch", batched)
    monkeypatch.setattr(state, "_device_present", lambda: True)
    atts = [object()] * 32
    assert state.recover_signers(atts) == [b"\x01" * 20] * 32
    assert state.recover_signers(atts, device="cuda:0")[0] == b"\x01" * 20
    assert calls == [(32, None), (32, "cuda:0")]
    scalar = []
    monkeypatch.setattr(state, "address_from_public_key",
                        lambda pk: scalar.append(pk) or b"\x02" * 20)

    class Signed:
        def recover_public_key(self):
            return "pk"

    few, cpu = [Signed()] * 31, [Signed()] * 32
    assert state.recover_signers(few) == [b"\x02" * 20] * 31
    assert state.recover_signers(cpu, device="cpu") == [b"\x02" * 20] * 32
    monkeypatch.setattr(state, "_device_present", lambda: False)
    assert state.recover_signers(cpu) == [b"\x02" * 20] * 32
    assert len(calls) == 2 and len(scalar) == 95


def test_routed_plan_cost_is_the_sweeps_analytic_row(tmp_path):
    """The refresher records the routed plan it adopts as one
    ``PLAN_COSTS`` row: the flops and bytes of one sweep counted from
    the operator's shapes at the backend's value width."""
    from types import SimpleNamespace

    from protocol_tpu_torch.backend import TorchSparseBackend
    from protocol_tpu_torch.service.recorder import (
        PLAN_COSTS,
        routed_sweep_cost,
    )
    from protocol_tpu_torch.service.refresh import ScoreRefresher
    from protocol_tpu_torch.service.state import OpinionGraph

    g = OpinionGraph()
    batch = [SimpleNamespace(attestation=SimpleNamespace(
        about=bytes([j + 1]) * 20, value=1 + (i + j) % 5))
        for i in range(6) for j in range(6) if i != j]
    g.apply(batch, [bytes([i + 1]) * 20 for i in range(6) for _ in range(5)])
    r = ScoreRefresher(g, ServiceConfig(routed_edge_threshold=1),
                       backend=TorchSparseBackend(dtype=torch.float64,
                                                  device="cpu"))
    r.refresh()
    op = r._op
    row = PLAN_COSTS.get("spmv_routed")
    flops, nbytes, operand = routed_sweep_cost(op, 8)
    assert (row["flops"], row["bytes_accessed"], row["operand_bytes"]) \
        == (flops, nbytes, operand)
    assert row["n_state"] == op.n_state
    e, st = 1 << op.edge_e, 1 << op.state_e
    weights = sum(w.size for w in op.out_weight)
    assert flops == weights + e + 5 * st
    assert operand == 8 * weights + sum(x.size for x in op.edge_stages) \
        + sum(x.size for x in op.state_stages) + 3 * 8 * st
    # float32 halves the value bytes, the uint8 indices stay
    f32 = routed_sweep_cost(op, 4)
    idx = sum(x.size for x in op.edge_stages + op.state_stages)
    assert f32[1] - idx == (nbytes - idx) / 2


def test_prover_backed_surfaces_name_the_missing_prover(tmp_path,
                                                       monkeypatch):
    """``shard_proves`` makes every kind but the capture window
    shardable; ``fabric`` with a state dir builds the fabric under
    ``<state-dir>/fabric`` (no state dir, no fabric), as the
    reference's daemon does. The
    default registry's ``eigentrust`` kind resolves to the port's
    ``zk.api.generate_et_proof`` (stubbed here: no prove) with the
    cached artifact bytes, the served shape and the job's device."""
    from types import SimpleNamespace

    from protocol_tpu_torch.cli.fs import EigenFile
    from protocol_tpu_torch.service.provers import make_provers
    from protocol_tpu_torch.zk import api as port_api
    from protocol_tpu_torch.zk.fabric import FabricStore

    client = Client(ClientConfig(), MNEMONIC, device="cpu")
    registry = {"echo": lambda p: p, "profile": lambda p: p}
    for knobs, state, kinds, fabric in (
            ({"shard_proves": 1}, "s1", {"echo"}, False),
            ({"shard_proves": 1, "fabric": 1}, "s2", {"echo"}, True),
            ({"fabric": 1}, None, set(), False)):
        svc = TrustService(client, ServiceConfig(port=0, **knobs),
                           str(tmp_path / "cursor"), provers=registry,
                           state_dir=(str(tmp_path / state)
                                      if state else None))
        assert svc.jobs.shard_kinds == kinds
        assert isinstance(svc.fabric, FabricStore) == fabric
        status = svc.jobs.pool_status()
        assert status["shard_kinds"] == sorted(kinds)
        if fabric:
            assert svc.fabric.root == str(tmp_path / state / "fabric")
            assert status["fabric"]["workers_live"] == 0
            assert (tmp_path / state / "fabric" / "units").is_dir()
        else:
            assert status["fabric"] is None
        svc.watchdog.stop()

    files = EigenFile(tmp_path)
    files.kzg_params(20).write_bytes(b"srs")
    files.et_proving_key().write_bytes(b"pk")
    setup = SimpleNamespace(
        address_set=[b"\x01" * 20, b"\x02" * 20],
        pub_inputs=SimpleNamespace(to_bytes=lambda: b"pubs"))
    service = SimpleNamespace(
        attestation_snapshot=lambda: ["att"],
        client=SimpleNamespace(device=torch.device("cpu"),
                               et_circuit_setup=lambda atts: setup))
    calls = []

    def fake_proof(params, pk, setup_, shape, transcript, device):
        calls.append((params, pk, setup_, shape, transcript, device))
        return b"proof"

    monkeypatch.setattr(port_api, "generate_et_proof", fake_proof)
    provers = make_provers(service, files, shape_name="tiny")
    assert sorted(provers) == ["eigentrust", "profile", "threshold"]
    out = provers["eigentrust"]({"transcript": "poseidon"})
    assert out == {"proof": b"proof".hex(), "public_inputs": b"pubs".hex(),
                   "transcript": "poseidon", "participants": 2}
    (params, pk, setup_, shape, transcript, device), = calls
    assert (params, pk, setup_, transcript) == (b"srs", b"pk", setup,
                                                "poseidon")
    assert shape == port_api.TINY_SHAPE and device == torch.device("cpu")
    provers["eigentrust"]({})
    assert calls[1][0] is params and calls[1][4] == "keccak"  # cached

def test_threshold_jobs_prove_through_the_port_api(tmp_path, monkeypatch):
    """The ``threshold`` kind (the reference's): ``peer`` and
    ``threshold`` are validated, then the port's
    ``zk.api.generate_th_proof`` gets the setup of the live attestation
    snapshot, the cached k = 21 SRS and Threshold key bytes and the
    job's device (stubbed here: the k = 21 prove runs on the card in
    ``chip_smoke.py``)."""
    from types import SimpleNamespace

    from protocol_tpu_torch.cli.fs import EigenFile
    from protocol_tpu_torch.service.provers import make_provers
    from protocol_tpu_torch.zk import api as port_api

    files = EigenFile(tmp_path)
    files.kzg_params(21).write_bytes(b"srs21")
    files.th_proving_key().write_bytes(b"thpk")
    peer = b"\x07" * 20
    setups = []

    def th_circuit_setup(atts, participant, threshold):
        setup = SimpleNamespace(pub_inputs=SimpleNamespace(
            to_bytes=lambda: b"thpubs", threshold_check=threshold <= 900))
        setups.append((atts, participant, threshold, setup))
        return setup

    service = SimpleNamespace(
        attestation_snapshot=lambda: ["att"],
        client=SimpleNamespace(device=torch.device("cpu"),
                               th_circuit_setup=th_circuit_setup))
    calls = []

    def fake_th_proof(params, pk, setup, device):
        calls.append((params, pk, setup, device))
        return b"thproof"

    monkeypatch.setattr(port_api, "generate_th_proof", fake_th_proof)
    provers = make_provers(service, files, shape_name="tiny")
    for bad in ({}, {"peer": "0x07"}, {"peer": "0x" + "07" * 20},
                {"peer": "zz", "threshold": 5},
                {"peer": "0x" + "07" * 20, "threshold": "x"},
                {"peer": "0x" + "07" * 19, "threshold": 5}):
        with pytest.raises(EigenError) as e:
            provers["threshold"](bad)
        assert e.value.kind == "validation_error", bad
    assert calls == [] and setups == []
    out = provers["threshold"]({"peer": "0x" + "07" * 20,
                                "threshold": 500})
    assert out == {"proof": b"thproof".hex(),
                   "public_inputs": b"thpubs".hex(),
                   "threshold_check": True}
    (atts, participant, threshold, setup), = setups
    assert (atts, participant, threshold) == (["att"], peer, 500)
    (params, pk, setup_, device), = calls
    assert (params, pk, setup_) == (b"srs21", b"thpk", setup)
    assert device == torch.device("cpu")
    out = provers["threshold"]({"peer": peer.hex(), "threshold": 1000})
    assert out["threshold_check"] is False
    assert calls[1][0] is params and calls[1][1] is pk  # cached bytes
