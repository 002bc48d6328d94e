"""The port's service held to the reference's durability tests
(``tests/test_service.py``, one twin each): SIGKILL and restart on the
same state dir, WAL compaction at startup and at the snapshot cadence,
and the refetch floor compaction must respect. The daemon helpers are
``test_torch_service``'s."""

import time
import urllib.request

import pytest

from protocol_tpu_torch.client.eth import (
    address_from_public_key,
    ecdsa_keypairs_from_mnemonic,
)
from test_torch_service import (  # noqa: F401 - devnet is a fixture
    MNEMONIC,
    _attest_round,
    _get,
    _get_text,
    _make_service,
    _oracle,
    _post,
    _wait,
    devnet,
)


def _hard_kill(svc):
    """Simulate SIGKILL: stop every thread with NO drain, NO farewell
    snapshot, NO final cursor persist — only what the sink already wrote
    to disk survives, exactly the crash contract the store claims."""
    svc._stop.set()
    svc._dirty.set()
    for t in svc._threads:
        t.join(timeout=10)
    # a SIGKILL takes the stall watchdog with it; left running, its
    # thread would keep writing gauges into the process's tracer
    svc.watchdog.stop()
    svc.jobs.hard_kill()
    svc._server.shutdown()
    svc._server.server_close()
    if svc.store is not None:
        svc.store.close()


def _digest_prover(holder):
    """Deterministic stand-in for the batch prover: proof bytes are the
    sha256 of the latest-wins-folded attestation payload set, so the
    service artifact can be compared byte-for-byte against the same
    fold computed from the chain (the batch side)."""

    def prove(params):
        atts = holder["svc"].attestation_snapshot()
        return {"proof": _fold_digest(atts).hex(), "participants": 0}

    return {"digest": prove}


def _fold_digest(atts):
    import hashlib

    folded = {}
    for signed in atts:
        folded[(signed.attestation.about,
                signed.signature.to_bytes())] = signed.to_payload()
    payloads = sorted(folded.values())
    h = hashlib.sha256()
    for p in payloads:
        h.update(p)
    return h.digest()


def test_kill_restart_durability(tmp_path, devnet):
    """The acceptance flow: ingest under active disk-fault injection →
    prove → SIGKILL mid-tail → restart on the same state dir → served
    scores equal the batch oracle WITHOUT re-fetching pre-cursor blocks,
    the first refresh warm-starts from the restored vector, and the
    pre-restart proof artifact is still served byte-identically."""
    _, node_url = devnet
    state_dir = str(tmp_path / "state")
    holder = {}
    # cold_edit_fraction=10: the staleness bound can never trip in this
    # test, so any cold refresh on the restarted service would be the
    # forced-resync-on-restart bug this test pins down
    # snapshot_every=2: the edits that follow the first score publish
    # are guaranteed to trigger a snapshot, so the NEWEST snapshot
    # always carries a published table (the warm-restart assertions
    # below would otherwise race the snapshot cadence)
    svc, client = _make_service(
        tmp_path, node_url, provers=_digest_prover(holder),
        state_dir=state_dir, snapshot_every=2, cold_edit_fraction=10.0)
    holder["svc"] = svc
    url = svc.start()
    kps = ecdsa_keypairs_from_mnemonic(MNEMONIC, 3)
    addrs = [address_from_public_key(kp.public_key) for kp in kps]

    # --- ingest with PTPU_FAULT_DISK-style faults active ------------------
    # 100% disk faults first: every WAL append fails (torn or fsync),
    # the tailer backs off WITHOUT advancing the cursor, and once the
    # fault clears the refetched batch lands intact
    svc.faults.rates["disk"] = 1.0
    _attest_round(client, kps, addrs,
                  {(i, j): 3 + (2 * i + j) % 6
                   for i in range(3) for j in range(3) if i != j})
    expected = _oracle(client, kps[0])
    _wait(lambda: svc.faults.injected["disk"] >= 2,
          what="disk faults to fire on WAL appends")
    assert svc.graph.n_edges == 0, \
        "an attestation reached the graph past a failed WAL append"
    svc.faults.rates["disk"] = 0.0
    _wait(lambda: svc.graph.n == 3
          and svc.refresher.table.revision == svc.graph.revision,
          what="scores after the disk fault cleared")

    # one more edit so part of the log sits past the last snapshot
    client.keypairs[0] = kps[0]
    client.attest(addrs[1], 9)
    # ... then REVERT it to the round-1 value: deterministic (RFC 6979)
    # signing makes this attestation byte-identical in payload to the
    # round-1 one, so only its block number distinguishes it from a
    # refetch — the content-dedup must not swallow the revert
    client.attest(addrs[1], 3 + (2 * 0 + 1) % 6)
    expected = _oracle(client, kps[0])
    _wait(lambda: svc.refresher.table.revision == svc.graph.revision
          and _get(f"{url}/score/0x{addrs[1].hex()}")[1]["score"]
          == pytest.approx(expected[addrs[1]], rel=1e-3),
          what="post-fault edit + revert scored")
    assert svc.store.snapshots.count() >= 1, "no snapshot was taken"

    # --- a proof completes and is persisted -------------------------------
    code, job = _post(f"{url}/proofs", {"kind": "digest"})
    assert code == 202
    _wait(lambda: _get(f"{url}/proofs/{job['job_id']}")[1]["status"]
          == "done", what="proof completion")
    with urllib.request.urlopen(
            f"{url}/proofs/{job['job_id']}/proof.bin", timeout=10) as r:
        proof_before = r.read()
    assert proof_before == _fold_digest(svc.attestation_snapshot())

    served_before = _get(f"{url}/scores")[1]["scores"]
    cursor_before = svc.tailer.cursor
    peers_before, edges_before = svc.graph.n, svc.graph.n_edges
    _hard_kill(svc)

    # --- restart on the same state dir (same contract, no re-deploy) -----
    svc2, client2 = _make_service(
        tmp_path, node_url, provers=_digest_prover(holder),
        state_dir=state_dir, snapshot_every=2, cold_edit_fraction=10.0,
        chain=client.chain)
    holder["svc"] = svc2
    # the constructor alone restored everything: graph, scores, proofs
    assert svc2.tailer.cursor == cursor_before, "cursor did not persist"
    assert (svc2.graph.n, svc2.graph.n_edges) == \
        (peers_before, edges_before), "graph did not restore"
    assert svc2.refresher.table.revision >= 0, "score table not restored"
    url2 = svc2.start()
    try:
        # the published table catches up to the replayed graph (a WARM
        # refresh from the restored vector when the last snapshot
        # trails the WAL), then serves the same scores as before
        _wait(lambda: svc2.refresher.table.revision
              == svc2.graph.revision, what="restored table republished")
        for row in served_before:
            code, one = _get(f"{url2}/score/{row['address']}")
            assert code == 200
            assert one["score"] == pytest.approx(row["score"], rel=1e-6)
        # ... without re-fetching a single pre-cursor block
        time.sleep(0.3)  # several poll intervals
        assert svc2.tailer.attestations == 0, \
            "restart re-fetched pre-cursor blocks"
        # pre-restart proof history survives, byte-identical
        _, done = _get(f"{url2}/proofs/{job['job_id']}")
        assert done["status"] == "done"
        with urllib.request.urlopen(
                f"{url2}/proofs/{job['job_id']}/proof.bin",
                timeout=10) as r:
            assert r.read() == proof_before
        # new data still flows, and the first refresh WARM-starts from
        # the restored vector (no forced cold resync)
        client2.keypairs[0] = kps[1]
        client2.attest(addrs[2], 11)
        expected2 = _oracle(client2, kps[0])
        _wait(lambda: svc2.refresher.table.revision
              == svc2.graph.revision and svc2.refresher.refreshes >= 1,
              what="post-restart refresh")
        assert svc2.refresher.cold_refreshes == 0, \
            "restart forced a cold resync despite the restored vector"
        for addr, ref in expected2.items():
            assert _get(f"{url2}/score/0x{addr.hex()}")[1]["score"] \
                == pytest.approx(ref, rel=1e-3)
        # job ids never collide with rehydrated history
        code, job2 = _post(f"{url2}/proofs", {"kind": "digest"})
        assert code == 202 and job2["job_id"] != job["job_id"]
        _wait(lambda: _get(f"{url2}/proofs/{job2['job_id']}")[1]["status"]
              == "done", what="post-restart proof")
        # store gauges are on /metrics
        metrics = _get_text(f"{url2}/metrics")
        for needle in ("ptpu_store_snapshot_age_seconds",
                       "ptpu_store_wal_segments",
                       "ptpu_store_wal_bytes",
                       "ptpu_store_proof_artifacts"):
            assert needle in metrics, f"/metrics missing {needle}"
    finally:
        assert svc2.shutdown() is True


def test_wal_auto_compaction(tmp_path, devnet):
    """Format-2 snapshots never prune the WAL (it IS the attestation
    history) — the daemon bounds its growth itself, in both places:
    (a) startup over a log of >= wal_compact_segments segments folds
    latest-wins duplicates per recovered (signer, about) into one
    fresh segment before restoring (oracle-exact scores + a
    deduplicated attestation buffer come from the compacted log), and
    (b) a LIVE daemon folds from the periodic snapshot cadence, so a
    long-running process under churn never grows the log without
    bound."""
    # four revisions per edge and phase where the reference runs eight:
    # the same rotation, folds and floors at half the signing time
    import os

    from protocol_tpu_torch.store.wal import AttestationWAL

    _, node_url = devnet
    state_dir = str(tmp_path / "state")
    wal_dir = os.path.join(state_dir, "wal")

    def wal_state():
        ro = AttestationWAL(wal_dir, readonly=True)
        segs, n = ro.segments(), sum(1 for _ in ro.replay())
        ro.close()
        return segs, n

    # --- phase 1: compaction disabled — the log grows ---------------------
    svc, client = _make_service(
        tmp_path, node_url, state_dir=state_dir, snapshot_every=2,
        wal_segment_bytes=256, wal_compact_segments=0)
    svc.start()
    kps = ecdsa_keypairs_from_mnemonic(MNEMONIC, 2)
    addrs = [address_from_public_key(kp.public_key) for kp in kps]
    try:
        # the same two (signer, about) edges revised many times over:
        # the log grows linearly while the live state stays 2 edges
        for v in range(3, 7):
            client.keypairs[0] = kps[0]
            client.attest(addrs[1], v)
            client.keypairs[0] = kps[1]
            client.attest(addrs[0], 13 - v)
        expected = _oracle(client, kps[0])
        _wait(lambda: svc.graph.n == 2
              and svc.refresher.table.revision == svc.graph.revision,
              what="revisions scored")
    finally:
        assert svc.shutdown() is True
    segs_before, n_before = wal_state()
    assert len(segs_before) >= 2, "workload never rotated the WAL"
    assert n_before > 2

    # --- phase 2: restart compacts before restore -------------------------
    svc2, client2 = _make_service(
        tmp_path, node_url, state_dir=state_dir, snapshot_every=2,
        wal_segment_bytes=256, wal_compact_segments=2,
        chain=client.chain)
    segs_after, records_after = wal_state()
    assert len(segs_after) == 1 and segs_after[0] > segs_before[-1]
    assert records_after == 2  # one folded record per live edge
    # the compacting process itself restored the buffer from the
    # PRE-compaction log (compaction runs after restore, so _seen
    # covers every refetchable digest); the deduplicated buffer
    # materializes on the NEXT restart — asserted in phase 4
    assert len(svc2.attestation_snapshot()) == 8
    url2 = svc2.start()
    try:
        _wait(lambda: svc2.refresher.table.revision
              == svc2.graph.revision, what="restored table republished")
        for addr, ref in expected.items():
            assert _get(f"{url2}/score/0x{addr.hex()}")[1]["score"] \
                == pytest.approx(ref, rel=1e-3)

        # --- phase 3: the LIVE daemon folds at snapshot cadence -----------
        for v in range(3, 7):
            client2.keypairs[0] = kps[0]
            client2.attest(addrs[1], v + 10)
            client2.keypairs[0] = kps[1]
            client2.attest(addrs[0], 23 - v)
        _wait(lambda: svc2.refresher.table.revision
              == svc2.graph.revision
              and svc2.graph.revision > 2, what="live churn scored")
        _wait(lambda: len(svc2.store.wal.segments()) <= 2,
              what="live compaction to fold the churned log")
        expected3 = _oracle(client2, kps[0])
    finally:
        assert svc2.shutdown() is True

    # --- phase 4: the next restart's buffer comes from the compacted
    # log — deduplicated (one record per live (signer, about) plus the
    # tail the live floor kept: records from batches whose cursor
    # wasn't yet persisted at fold time), NOT the 16-revision history
    _, records_final = wal_state()
    svc3, _ = _make_service(
        tmp_path, node_url, state_dir=state_dir, snapshot_every=2,
        wal_segment_bytes=256, wal_compact_segments=2,
        chain=client.chain)
    assert len(svc3.attestation_snapshot()) == records_final < 8
    url3 = svc3.start()
    try:
        _wait(lambda: svc3.refresher.table.revision
              == svc3.graph.revision, what="phase-4 restart rescored")
        for addr, ref in expected3.items():
            assert _get(f"{url3}/score/0x{addr.hex()}")[1]["score"] \
                == pytest.approx(ref, rel=1e-3)
    finally:
        assert svc3.shutdown() is True


def test_wal_compaction_preserves_refetchable_records(tmp_path, devnet):
    """Compaction must never fold a record the tailer could refetch
    (block > persisted cursor): folding deletes exactly the digest
    that dedups the refetch, so the superseded value would re-apply
    while the surviving newer record is skipped — a silent edge
    revert. Simulated at the maximum: the cursor checkpoint is wiped
    (everything refetches), so the startup compaction must keep every
    record verbatim and the refetched history must fold to the same
    served scores."""
    import os
    import shutil

    from protocol_tpu_torch.store.wal import AttestationWAL

    _, node_url = devnet
    state_dir = str(tmp_path / "state")
    svc, client = _make_service(
        tmp_path, node_url, state_dir=state_dir, snapshot_every=1000,
        wal_segment_bytes=256, wal_compact_segments=0)
    svc.start()
    kps = ecdsa_keypairs_from_mnemonic(MNEMONIC, 2)
    addrs = [address_from_public_key(kp.public_key) for kp in kps]
    try:
        client.keypairs[0] = kps[1]
        client.attest(addrs[0], 5)
        for v in (3, 9):  # same (signer, about) edge: superseded 3,
            client.keypairs[0] = kps[0]   # surviving 9
            client.attest(addrs[1], v)
        expected = _oracle(client, kps[0])
        _wait(lambda: svc.graph.n == 2 and svc.graph.n_edges == 2
              and svc.refresher.table.revision == svc.graph.revision,
              what="revisions scored")
    finally:
        assert svc.shutdown() is True
    shutil.rmtree(tmp_path / "cursor")  # maximal cursor lag

    svc2, _ = _make_service(
        tmp_path, node_url, state_dir=state_dir, snapshot_every=1000,
        wal_segment_bytes=256, wal_compact_segments=1,
        chain=client.chain)
    # startup compaction ran (wal_compact_segments=1) but the floor
    # (cursor 0) kept every record — nothing was refetch-foldable
    ro = AttestationWAL(os.path.join(state_dir, "wal"), readonly=True)
    records = sum(1 for _ in ro.replay())
    ro.close()
    assert records == 3, \
        f"compaction folded refetchable records ({records} left)"
    url2 = svc2.start()
    try:
        _wait(lambda: svc2.tailer.cursor > 0, timeout=60.0,
              what="refetch to land")
        _wait(lambda: svc2.refresher.table.revision
              == svc2.graph.revision, timeout=60.0,
              what="restart rescored")
        time.sleep(0.5)  # a revert would arrive as a late refresh
        for addr, ref in expected.items():
            assert _get(f"{url2}/score/0x{addr.hex()}")[1]["score"] \
                == pytest.approx(ref, rel=1e-3), \
                "refetched superseded attestation reverted the edge"
    finally:
        assert svc2.shutdown() is True
