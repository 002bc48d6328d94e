"""The port's follower replica (``protocol_tpu_torch.service.follower``)
held to the reference's follower tests (``tests/test_replication.py``,
one twin each) against the port's mock devnet, on the CPU: bootstrap
and tail, kill and restart from the cursor, the leader's compaction
ship floor, and the local WAL bounded under churn; then the port's
follower on the reference's leader over HTTP.

Leader and follower force every refresh cold (``cold_edit_fraction=0``),
as the reference's tests do: a cold converge from uniform on the same
graph is bit-deterministic on one box, so the follower's ``/scores``
equal the leader's at the same WAL position. Every test stops each
daemon and follower it starts (their watchdogs write into the process
tracer)."""

import json
import time
import urllib.error
import urllib.request

import pytest

from protocol_tpu_torch.client import Client, ClientConfig
from protocol_tpu_torch.client.chain import RpcChain
from protocol_tpu_torch.client.eth import (
    address_from_public_key,
    ecdsa_keypairs_from_mnemonic,
)
from protocol_tpu_torch.client.mocknode import MockNode
from protocol_tpu_torch.service import (
    FaultInjector,
    FollowerService,
    ServiceConfig,
    TrustService,
)

MNEMONIC = "test test test test test test test test test test test junk"
DOMAIN = b"\x00" * 20
NO_FAULTS = {"rpc": 0.0, "device": 0.0, "disk": 0.0}


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.status, dict(resp.headers), resp.read()


def _get_json(url):
    return json.loads(_get(url)[2])


def _wait(pred, timeout=60.0, interval=0.05, what="condition"):
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
    yield url
    node.stop()


@pytest.fixture()
def stop_all():
    """Every daemon and follower a test starts, shut down at teardown
    (a hard-killed follower's ``_stop`` is already set: shutdown just
    stops its watchdog)."""
    started = []
    yield started.append
    for svc in reversed(started):
        svc.watchdog.stop()
        if not svc.draining and svc._server is not None \
                and not svc._stop.is_set():
            svc.shutdown()


def _cfg(**over):
    base = dict(port=0, poll_interval=0.05, refresh_interval=0.05,
                tol=1e-10, backoff_base=0.05, backoff_max=0.2,
                drain_timeout=10.0, snapshot_every=4,
                cold_edit_fraction=0.0)
    base.update(over)
    return ServiceConfig(**base)


def _leader(tmp_path, node_url, **over):
    deployer = ecdsa_keypairs_from_mnemonic(MNEMONIC, 1)[0]
    chain = RpcChain.deploy_signed(node_url, deployer)
    config = ClientConfig(
        as_address="0x" + chain.contract_address.hex(),
        node_url=node_url, domain="0x" + DOMAIN.hex())
    client = Client(config, MNEMONIC, device="cpu")
    svc = TrustService(
        client, _cfg(**over), str(tmp_path / "cursor"),
        provers={"echo": lambda params: {"echo": params}},
        faults=FaultInjector(NO_FAULTS),
        state_dir=str(tmp_path / "leader-state"))
    return svc, client


def _follower(tmp_path, leader_url, name="fstate", **over):
    return FollowerService(
        leader_url, DOMAIN, _cfg(**over), str(tmp_path / name),
        faults=FaultInjector(NO_FAULTS), device="cpu")


def _hard_kill_follower(fol):
    """SIGKILL in process: threads stopped with no drain, no farewell
    snapshot and no final cursor persist — only the per-poll persists
    survive, the crash contract the follower claims."""
    fol._stop.set()
    fol._dirty.set()
    fol.watchdog.stop()
    for t in fol._threads:
        t.join(timeout=10)
    fol._server.shutdown()
    fol._server.server_close()
    fol.store.close()


def _attest_pairs(client, kps, pairs):
    for i, about, value in pairs:
        client.keypairs[0] = kps[i]
        client.attest(about, value)


def _settled(url, min_edges=0):
    st = _get_json(url + "/status")
    return (st["graph"]["edges"] >= min_edges
            and st["last_refresh"]["revision"] == st["graph"]["revision"])


def _caught_up(furl, lurl):
    """Same WAL coverage and both published their own latest revision
    (graph revisions are node-local, so equality is on WAL position)."""
    fs = _get_json(furl + "/status")
    ls = _get_json(lurl + "/status")
    return (fs["repl"]["cursor"] == ls["store"]["wal_position"]
            and fs["last_refresh"]["revision"] == fs["graph"]["revision"]
            and ls["last_refresh"]["revision"] == ls["graph"]["revision"])


def _by_address(url):
    return {s["address"]: s["score"]
            for s in json.loads(_get(url + "/scores")[2])["scores"]}


def test_follower_bootstrap_tail_equal_scores(tmp_path, devnet, stop_all):
    """Bootstrap from the leader's snapshot, tail the shipped WAL and,
    at the same WAL position, serve the leader's scores (every pair, the
    table digests equal) with its own ETag; the leader sees it at eof;
    the lag gauges are on /metrics; /bundle is the leader's, verbatim,
    with a 304 on If-None-Match; the write surface is closed."""
    from protocol_tpu_torch.service.bundle import verify_bundle

    svc, client = _leader(tmp_path, devnet)
    url = svc.start()
    stop_all(svc)
    kps = ecdsa_keypairs_from_mnemonic(MNEMONIC, 3)
    addrs = [address_from_public_key(k.public_key) for k in kps]
    _attest_pairs(client, kps, [(0, addrs[1], 7), (1, addrs[0], 9)])
    _wait(lambda: _settled(url, min_edges=2), what="leader settle")
    fol = _follower(tmp_path, url)
    furl = fol.start()
    stop_all(fol)
    # records past the bootstrap snapshot exercise the tail path
    _attest_pairs(client, kps, [(0, addrs[2], 5), (2, addrs[0], 3),
                                (1, addrs[2], 4)])
    _wait(lambda: _settled(url, min_edges=5), what="leader settle 2")
    _wait(lambda: _caught_up(furl, url), what="follower catch-up")
    lj = json.loads(_get(url + "/scores")[2])
    _, fh, fbody = _get(furl + "/scores")
    assert json.loads(fbody)["scores"] == lj["scores"] and lj["scores"]
    assert svc.refresher.table.digest == fol.refresher.table.digest
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(furl + "/scores", headers={"If-None-Match": fh["ETag"]})
    assert ei.value.code == 304
    repl = _get_json(url + "/status")["repl"]
    assert repl["followers"][0]["eof"]
    assert repl["followers"][0]["follower"] == fol.follower_id
    fstat = _get_json(furl + "/status")
    assert fstat["role"] == "follower" and fstat["repl"]["lag_records"] == 0
    assert 0.0 <= fstat["repl"]["lag_seconds"] < 30.0
    metrics = _get(furl + "/metrics")[2].decode()
    for name in ("ptpu_repl_lag_records", "ptpu_repl_lag_seconds",
                 "ptpu_repl_poll_seconds"):
        assert name in metrics, name
    # the cache fills on an eof poll and revalidates at most once a
    # second: until then the follower answers an error status
    def same_bundle():
        try:
            return _get(furl + "/bundle")[2] == _get(url + "/bundle")[2]
        except urllib.error.HTTPError:
            return False

    _wait(same_bundle, what="the leader's bundle on the follower")
    _, bh, fbundle = _get(furl + "/bundle")
    bd = json.loads(fbundle)
    verify_bundle(bytes.fromhex(bd["payload"]), bytes.fromhex(bd["signature"]))
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(furl + "/bundle", headers={"If-None-Match": bh["ETag"]})
    assert ei.value.code == 304
    req = urllib.request.Request(
        furl + "/proofs", data=b'{"kind": "echo"}',
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 503
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(furl + "/proofs/job-1")
    assert ei.value.code == 404
    assert fol.shutdown() is True and fol.drain_clean


def test_follower_kill_restart_resumes_from_cursor(tmp_path, devnet,
                                                   stop_all):
    """SIGKILL mid-tail, churn while down, restart on the same state
    dir: the constructor restores the follower's own snapshot and WAL
    (same records, same cursor, same id) before any network I/O, the
    tail resumes from the persisted cursor (no re-bootstrap, no re-ship
    of the history) and the scores come back equal to the leader's."""
    svc, client = _leader(tmp_path, devnet)
    url = svc.start()
    stop_all(svc)
    kps = ecdsa_keypairs_from_mnemonic(MNEMONIC, 3)
    addrs = [address_from_public_key(k.public_key) for k in kps]
    _attest_pairs(client, kps, [(0, addrs[1], 7), (1, addrs[0], 9),
                                (0, addrs[2], 2)])
    _wait(lambda: _settled(url, min_edges=3), what="leader settle")
    fol = _follower(tmp_path, url)
    furl = fol.start()
    stop_all(fol)
    _wait(lambda: _caught_up(furl, url), what="follower catch-up")
    applied, cursor = fol.records_applied, fol._cursor
    shipped0 = _get_json(url + "/status")["repl"]["followers"][0][
        "records_shipped"]
    _hard_kill_follower(fol)
    _attest_pairs(client, kps, [(2, addrs[0], 6), (1, addrs[2], 8)])
    _wait(lambda: _settled(url, min_edges=5), what="leader settle 2")
    fol2 = _follower(tmp_path, url)
    assert fol2.records_applied == applied and fol2._cursor == cursor
    assert fol2.follower_id == fol.follower_id
    furl2 = fol2.start()
    stop_all(fol2)
    _wait(lambda: _caught_up(furl2, url), what="catch-up after restart")
    assert _by_address(furl2) == _by_address(url)
    shipped1 = _get_json(url + "/status")["repl"]["followers"][0][
        "records_shipped"]
    assert shipped1 - shipped0 <= 4, (shipped0, shipped1)
    assert fol2.gaps == 0


def test_leader_compaction_ship_floor(tmp_path, devnet, stop_all):
    """Compaction defers while an active follower catches up (the ship
    floor) and proceeds once it reaches eof; a follower whose cursor
    predates the compaction re-tails the folded log from the earliest
    position (a gap) and ends with the leader's scores."""
    svc, client = _leader(tmp_path, devnet, wal_segment_bytes=256,
                          wal_compact_segments=2, snapshot_every=10_000)
    url = svc.start()
    stop_all(svc)
    kps = ecdsa_keypairs_from_mnemonic(MNEMONIC, 3)
    addrs = [address_from_public_key(k.public_key) for k in kps]
    _attest_pairs(client, kps, [(i % 3, addrs[(i + 1) % 3], 2 + i % 9)
                                for i in range(9)])
    # all nine in the WAL (three edges already settle after three): a
    # late append would rotate a segment under the floor check
    _wait(lambda: svc.tailer.attestations >= 9 and _settled(url),
          what="leader settle")
    _wait(lambda: len(svc.store.wal.segments()) >= 2,
          what="segment rotation")
    segs0 = len(svc.store.wal.segments())
    out = svc.repl_source.wal_chunk((0, 0), max_bytes=4096,
                                    follower="slow")
    assert not out["eof"] and out["backlog"] > 0
    assert svc.repl_source.catching_up()
    svc._compact_wal(svc.tailer.persisted_cursor)
    assert len(svc.store.wal.segments()) == segs0, \
        "compaction ignored the ship floor"
    pos = out["next"]
    while not out["eof"]:
        out = svc.repl_source.wal_chunk(pos, follower="slow")
        pos = out["next"]
    assert not svc.repl_source.catching_up()
    svc._compact_wal(svc.tailer.persisted_cursor)
    assert len(svc.store.wal.segments()) < segs0
    stale = svc.store.wal.read_chunk((1, 8))
    assert stale["gap"] and stale["next"] == svc.store.wal.earliest_position()
    fol = _follower(tmp_path, url, name="fstate2")
    fol._cursor = (1, 8)  # a cursor into a compacted-away segment
    furl = fol.start()
    stop_all(fol)
    _wait(lambda: _caught_up(furl, url), what="gap-recovery catch-up")
    assert fol.gaps >= 1
    # the folded log's order is not the ingest order: compare by address
    assert _by_address(furl) == _by_address(url)


def test_follower_local_wal_bounded_under_churn(tmp_path, devnet,
                                                stop_all):
    """Latest-wins churn over a fixed key set: the follower folds its
    own local WAL (startup and snapshot cadence, floor = the local
    position at the last persisted cursor), so its segment count stays
    bounded while the leader ships the whole unfolded history; a
    restart on the folded log restores the leader's scores."""
    svc, client = _leader(tmp_path, devnet, wal_segment_bytes=1_000_000,
                          wal_compact_segments=0, snapshot_every=10_000)
    url = svc.start()
    stop_all(svc)
    kps = ecdsa_keypairs_from_mnemonic(MNEMONIC, 3)
    addrs = [address_from_public_key(k.public_key) for k in kps]
    fol = _follower(tmp_path, url, wal_segment_bytes=256,
                    wal_compact_segments=2, snapshot_every=3)
    furl = fol.start()
    stop_all(fol)
    seg_counts, shipped = [], 0
    for r in range(5):
        _attest_pairs(client, kps, [(0, addrs[1], 10 + r),
                                    (1, addrs[2], 40 + r),
                                    (2, addrs[0], 70 + r)])
        shipped += 3
        _wait(lambda: svc.tailer.attestations >= shipped
              and _settled(url), what=f"leader settle round {r}")
        _wait(lambda: _caught_up(furl, url),
              what=f"follower catch-up round {r}")
        seg_counts.append(len(fol.store.wal.segments()))
    # 15 records of ~130 bytes in 256-byte segments: 8 or more unfolded
    assert fol.records_applied == shipped
    assert max(seg_counts[-3:]) <= 5, seg_counts
    assert sum(1 for _ in fol.store.wal.replay()) < shipped
    _hard_kill_follower(fol)
    fol2 = _follower(tmp_path, url)
    assert fol2.follower_id == fol.follower_id
    furl2 = fol2.start()
    stop_all(fol2)
    _wait(lambda: _caught_up(furl2, url), what="catch-up on folded log")
    assert fol2.gaps == 0
    assert _by_address(furl2) == _by_address(url)


def test_port_follower_follows_the_reference_leader(tmp_path, devnet,
                                                    stop_all):
    """The cross-package pair: the REFERENCE's ``TrustService`` leads
    (its client tails the port's devnet), the port's ``FollowerService``
    (``device="cpu"``) bootstraps from its snapshot and tails its
    shipped WAL over HTTP. The follower's scores are within rtol 1e-3
    of the leader's (the port service's tolerance against the
    reference, ``test_torch_service_parity``) and its local WAL holds
    the records the leader shipped, byte for byte and in order."""
    pytest.importorskip("jax")
    from protocol_tpu.client import Client as RefClient
    from protocol_tpu.client import ClientConfig as RefClientConfig
    from protocol_tpu.service import FaultInjector as RefFaults
    from protocol_tpu.service import ServiceConfig as RefServiceConfig
    from protocol_tpu.service import TrustService as RefTrustService

    deployer = ecdsa_keypairs_from_mnemonic(MNEMONIC, 1)[0]
    chain = RpcChain.deploy_signed(devnet, deployer)
    as_address = "0x" + chain.contract_address.hex()
    client = Client(ClientConfig(as_address=as_address, node_url=devnet,
                                 domain="0x" + DOMAIN.hex()),
                    MNEMONIC, device="cpu")
    knobs = dict(port=0, poll_interval=0.05, refresh_interval=0.05,
                 tol=1e-10, backoff_base=0.05, backoff_max=0.2,
                 drain_timeout=10.0, snapshot_every=3,
                 cold_edit_fraction=0.0)
    ref = RefTrustService(
        RefClient(RefClientConfig(as_address=as_address, node_url=devnet,
                                  domain="0x" + DOMAIN.hex()), MNEMONIC),
        RefServiceConfig(**knobs), str(tmp_path / "ref-cursor"),
        provers={"echo": lambda params: params},
        faults=RefFaults(NO_FAULTS), state_dir=str(tmp_path / "ref-state"))
    url = ref.start()
    stop_all(ref)
    kps = ecdsa_keypairs_from_mnemonic(MNEMONIC, 3)
    addrs = [address_from_public_key(k.public_key) for k in kps]
    _attest_pairs(client, kps, [(0, addrs[1], 7), (1, addrs[0], 9),
                                (2, addrs[1], 4)])
    _wait(lambda: _settled(url, min_edges=3)
          and ref.store.snapshots.count() >= 1, what="reference snapshot")
    fol = _follower(tmp_path, url)
    furl = fol.start()
    stop_all(fol)
    # past the bootstrap snapshot: the shipped-WAL tail
    _attest_pairs(client, kps, [(1, addrs[2], 6), (2, addrs[0], 3)])
    _wait(lambda: _settled(url, min_edges=5), what="reference settle 2")
    _wait(lambda: _caught_up(furl, url), what="follower catch-up")
    lead, got = _by_address(url), _by_address(furl)
    assert set(got) == set(lead) and len(lead) == 3
    for a, v in lead.items():
        assert got[a] == pytest.approx(v, rel=1e-3), a
    from protocol_tpu_torch.store.wal import decode_body, iter_frames

    records, pos, eof = [], (0, 0), False
    while not eof:  # the leader's whole log, as it ships it
        out = ref.repl_source.wal_chunk(pos, follower="probe")
        records += [decode_body(body) for _, body in iter_frames(out["data"])]
        pos, eof = out["next"], out["eof"]
    local = [rec for _, rec in fol.store.wal.replay_frames()]
    # the snapshot covered the first three; the tail shipped the rest
    assert local == records[-len(local):] and len(local) == 2
    assert fol.shutdown() is True


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_a_cold_refresh_keeps_the_edits_applied_while_it_ran(pkg):
    """With ``cold_edit_fraction=0`` every refresh after an edit is
    cold. An edit applied while a cold refresh converges must still
    count toward the next refresh: the port subtracts the edits the
    refresh's cut saw, so the next refresh is cold. The reference resets
    the count to 0 and its next refresh warm-starts — why its
    leader/follower byte-equality tests fail now and then."""
    from types import SimpleNamespace

    if pkg == "reference":
        pytest.importorskip("jax")
        from protocol_tpu.backend import JaxSparseBackend as Backend
        from protocol_tpu.service import ServiceConfig as Config
        from protocol_tpu.service.refresh import ScoreRefresher
        from protocol_tpu.service.state import OpinionGraph
        kwargs = {}
    else:
        from protocol_tpu_torch.backend import TorchSparseBackend as Backend
        from protocol_tpu_torch.service.refresh import ScoreRefresher
        from protocol_tpu_torch.service.state import OpinionGraph
        Config = ServiceConfig
        kwargs = {"device": "cpu"}

    def edge(i, j, value):
        return SimpleNamespace(attestation=SimpleNamespace(
            about=bytes([j + 1]) * 20, value=value))

    g = OpinionGraph()
    g.apply([edge(i, j, 1 + (i + j) % 5) for i in range(4)
             for j in range(4) if i != j],
            [bytes([i + 1]) * 20 for i in range(4) for _ in range(3)])
    late = []

    class EditMidway(Backend):
        def converge_edges(self, *args, **kw):
            while late:  # an ingest lands while the refresh converges
                g.apply([late.pop()], [b"\x01" * 20])
            return super().converge_edges(*args, **kw)

    r = ScoreRefresher(g, Config(cold_edit_fraction=0.0),
                       backend=EditMidway(**kwargs))
    late.append(edge(0, 2, 9))
    r.refresh()
    assert r.table.cold and g.revision == r.table.revision + 1
    assert g.edits_since_cold == (0 if pkg == "reference" else 1)
    r.refresh()
    assert r.table.revision == g.revision
    assert r.table.cold == (pkg == "port")
