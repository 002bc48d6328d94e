"""The port's durable state store (``protocol_tpu_torch.store``) held
to the reference's store tests (``tests/test_store.py``, one twin each:
WAL framing/rotation/CRC/heal/compaction, snapshot atomicity +
corruption fallback, proof artifact round-trips, the
``PTPU_FAULT_DISK`` injection shapes), and the two packages' on-disk
formats held to each other in both directions: a WAL and a snapshot
written by either package are read by the other, with equal bytes and
equal decoded state."""

import os

import numpy as np
import pytest

from protocol_tpu_torch.service.faults import FaultInjector
from protocol_tpu_torch.service.jobs import ProofJob
from protocol_tpu_torch.store import (
    AttestationWAL,
    ProofArtifactStore,
    SnapshotStore,
    StateStore,
    decode_body,
    encode_record,
    encode_service_state,
    decode_service_state,
    iter_frames,
)
from protocol_tpu_torch.utils.errors import EigenError


def _rec(i: int, about_byte: int | None = None):
    about = bytes([about_byte if about_byte is not None else i % 7]) * 20
    return (i, about, bytes([i % 251]) * 66)


# --- record framing ---------------------------------------------------------


def test_record_codec_round_trip():
    block, about, payload = 1234567, b"\xaa" * 20, b"\x01\x02" * 49
    frame = encode_record(block, about, payload)
    frames = list(iter_frames(frame))
    assert len(frames) == 1
    assert decode_body(frames[0][1]) == (block, about, payload)


def test_iter_frames_stops_at_corruption():
    good = encode_record(1, b"a" * 20, b"p" * 66)
    bad = bytearray(encode_record(2, b"b" * 20, b"q" * 66))
    bad[20] ^= 0xFF  # flip a body byte -> CRC mismatch
    tail = encode_record(3, b"c" * 20, b"r" * 66)
    frames = list(iter_frames(good + bytes(bad) + tail))
    # the scan must stop AT the corrupt frame, not resync past it
    assert len(frames) == 1
    assert decode_body(frames[0][1])[0] == 1


# --- WAL --------------------------------------------------------------------


def test_wal_segment_rotation_and_replay_order(tmp_path):
    wal = AttestationWAL(str(tmp_path), segment_bytes=256)
    for i in range(20):
        wal.append([_rec(i)])
    assert len(wal.segments()) > 1, "no rotation happened"
    blocks = [b for b, _, _ in wal.replay()]
    assert blocks == list(range(20)), "replay must preserve append order"
    wal.close()


def test_wal_torn_tail_healed_on_reopen(tmp_path):
    wal = AttestationWAL(str(tmp_path))
    for i in range(5):
        wal.append([_rec(i)])
    seg = wal.segments()[-1]
    wal.close()
    path = tmp_path / f"wal-{seg:012d}.seg"
    with open(path, "ab") as f:
        f.write(b"\x99" * 13)  # the crash shape: half a frame
    wal2 = AttestationWAL(str(tmp_path))
    assert wal2.torn_skipped == 1
    assert [b for b, _, _ in wal2.replay()] == list(range(5))
    # appends after the heal land on a valid boundary
    wal2.append([_rec(5)])
    assert [b for b, _, _ in wal2.replay()] == list(range(6))
    wal2.close()
    # and the file parses cleanly from scratch (no embedded garbage)
    wal3 = AttestationWAL(str(tmp_path), readonly=True)
    assert [b for b, _, _ in wal3.replay()] == list(range(6))
    assert wal3.torn_skipped == 0


def test_wal_mid_segment_corruption_skips_to_next_segment(tmp_path):
    wal = AttestationWAL(str(tmp_path), segment_bytes=200)
    for i in range(10):
        wal.append([_rec(i)])
    segs = wal.segments()
    wal.close()
    # corrupt the FIRST segment's first record body
    path = tmp_path / f"wal-{segs[0]:012d}.seg"
    data = bytearray(path.read_bytes())
    data[8 + 8 + 2] ^= 0xFF
    path.write_bytes(bytes(data))
    ro = AttestationWAL(str(tmp_path), readonly=True)
    blocks = [b for b, _, _ in ro.replay()]
    # the corrupt segment's scan stops, later segments still replay
    assert blocks and blocks[0] > 0 and blocks[-1] == 9
    assert ro.torn_skipped == 1


def test_wal_replay_from_position(tmp_path):
    wal = AttestationWAL(str(tmp_path), segment_bytes=160)
    pos = None
    for i in range(12):
        p = wal.append([_rec(i)])
        if i == 5:
            pos = p
    got = [b for b, _, _ in wal.replay(pos)]
    assert got == list(range(6, 12))
    wal.close()


def test_wal_compaction_folds_latest_wins(tmp_path):
    wal = AttestationWAL(str(tmp_path), segment_bytes=300)
    # 18 records over 3 distinct keys -> last write per key survives
    for i in range(18):
        wal.append([_rec(i, about_byte=i % 3)])
    before = {a: b for b, a, _ in wal.replay()}  # latest-wins fold
    out = wal.compact(lambda b, a, p: a)
    assert out["records_in"] == 18
    assert out["records_out"] == 3
    assert out["segments_removed"] >= 2
    after = list(wal.replay())
    assert {a: b for b, a, _ in after} == before
    assert len(after) == 3
    assert len(wal.segments()) == 1
    # appends continue normally on the compacted log
    wal.append([_rec(99, about_byte=9)])
    assert len(list(wal.replay())) == 4
    wal.close()


def test_wal_compaction_drops_unkeyed_records(tmp_path):
    wal = AttestationWAL(str(tmp_path))
    for i in range(6):
        wal.append([_rec(i)])
    out = wal.compact(
        lambda b, a, p: None if b % 2 else (a, b))  # drop odd blocks
    assert out["dropped"] == 3
    assert [b for b, _, _ in wal.replay()] == [0, 2, 4]
    wal.close()


def test_wal_prune_below(tmp_path):
    wal = AttestationWAL(str(tmp_path), segment_bytes=160)
    for i in range(12):
        wal.append([_rec(i)])
    segs = wal.segments()
    assert len(segs) >= 3
    removed = wal.prune_below(segs[-1])
    assert removed == len(segs) - 1
    assert wal.segments() == [segs[-1]]
    wal.close()


def test_wal_disk_fault_injection(tmp_path):
    faults = FaultInjector({"disk": 1.0}, seed=5)
    wal = AttestationWAL(str(tmp_path), faults=faults)
    failures = 0
    for i in range(6):
        with pytest.raises(EigenError, match="injected"):
            wal.append([_rec(i)])
        failures += 1
    assert faults.injected["disk"] == failures
    # clearing the fault heals the tail; only the clean append survives
    faults.rates["disk"] = 0.0
    wal.append([_rec(42)])
    assert [b for b, _, _ in wal.replay()] == [42]
    wal.close()
    wal2 = AttestationWAL(str(tmp_path), readonly=True)
    assert [b for b, _, _ in wal2.replay()] == [42]


# --- snapshots --------------------------------------------------------------


class _FakeTable:
    """Just the fields encode_service_state reads."""

    def __init__(self, scores, revision):
        self.scores = np.asarray(scores, dtype=np.float64)
        self.revision = revision
        self.iterations = 7
        self.delta = 1e-12
        self.cold = False
        self.computed_at = 123.5


def test_snapshot_service_state_round_trip(tmp_path):
    addrs = [bytes([i + 1]) * 20 for i in range(4)]
    edges = {(0, 1): 5.0, (1, 0): 7.0, (2, 3): 0.0}
    src, dst = [0, 1, 2], [1, 0, 3]
    val = [5.0, 7.0, 0.0]
    store = SnapshotStore(str(tmp_path))
    arrays, meta = encode_service_state(
        addrs, src, dst, val, revision=9, edits_since_cold=3, invalid=1,
        table=_FakeTable([10.0, 20.0, 30.0], 8), wal_pos=(2, 456),
        n_attestations=17)
    # format 2: O(graph) encode — the raw attestation buffer is NOT in
    # the snapshot, only the WAL coverage position
    assert "att_blob" not in arrays
    assert meta["fmt"] == 2 and meta["n_attestations"] == 17
    store.save(9, arrays, meta)
    step, arrays2, meta2 = store.load_latest()
    st = decode_service_state(arrays2, meta2)
    assert step == 9
    assert st["addrs"] == addrs
    assert st["edges"] == edges
    assert st["revision"] == 9 and st["edits_since_cold"] == 3
    assert st["invalid"] == 1
    assert st["score_revision"] == 8
    np.testing.assert_allclose(st["scores"], [10.0, 20.0, 30.0])
    assert st["wal_pos"] == (2, 456)
    assert st["buffer_in_snapshot"] is False
    assert st["att_records"] == []


def test_snapshot_v1_with_att_blob_still_decodes():
    """Format-1 snapshots carried the raw attestation buffer as an
    ``att_blob`` array; decode must keep restoring it so an upgraded
    daemon can read the snapshot a previous version wrote."""
    from protocol_tpu_torch.client.attestation import (
        AttestationData,
        SignatureData,
        SignedAttestationData,
    )
    from protocol_tpu_torch.store.wal import encode_record

    addrs = [bytes([i + 1]) * 20 for i in range(2)]
    att = SignedAttestationData(
        AttestationData(about=addrs[1], domain=b"\x00" * 20, value=5),
        SignatureData(b"\x11" * 32, b"\x22" * 32, 1))
    arrays, meta = encode_service_state(
        addrs, [0], [1], [5.0], revision=1, edits_since_cold=0,
        invalid=0, table=_FakeTable([1.0, 2.0], 1), wal_pos=(1, 8))
    blob = encode_record(7, att.attestation.about, att.to_payload())
    arrays["att_blob"] = np.frombuffer(blob, dtype=np.uint8)
    meta = dict(meta)
    meta.pop("fmt")
    st = decode_service_state(arrays, meta)
    assert st["buffer_in_snapshot"] is True
    [(blk, about, payload)] = st["att_records"]
    assert blk == 7, "attestation block numbers must round-trip"
    assert about == addrs[1]
    assert payload == att.to_payload()


def test_snapshot_corrupt_latest_falls_back(tmp_path):
    store = SnapshotStore(str(tmp_path), keep=3)
    t = _FakeTable([], -1)
    for step in (1, 2):
        arrays, meta = encode_service_state(
            [], [], [], [], step, 0, 0, t, (1, 8))
        store.save(step, arrays, meta)
    # corrupt the newest payload; its sidecar stays valid
    (tmp_path / "step-000000000002.npz").write_bytes(b"not a zipfile")
    step, _, meta = store.load_latest()
    assert step == 1
    assert store.unreadable_skipped == 1


def test_snapshot_half_written_is_invisible(tmp_path):
    store = SnapshotStore(str(tmp_path))
    t = _FakeTable([], -1)
    arrays, meta = encode_service_state([], [], [], [], 5, 0, 0, t, (1, 8))
    store.save(5, arrays, meta)
    # a payload rename without its sidecar (crash window) is not a step
    (tmp_path / "step-000000000009.npz").write_bytes(b"PK\x03\x04junk")
    assert store.steps() == [5]
    assert store.load_latest()[0] == 5


def test_snapshot_disk_fault_injection(tmp_path):
    faults = FaultInjector({"disk": 1.0}, seed=2)
    store = SnapshotStore(str(tmp_path), faults=faults)
    t = _FakeTable([], -1)
    arrays, meta = encode_service_state([], [], [], [], 1, 0, 0, t, (1, 8))
    for _ in range(3):
        with pytest.raises(EigenError, match="injected"):
            store.save(1, arrays, meta)
    assert store.load_latest() is None  # nothing half-visible
    faults.rates["disk"] = 0.0
    store.save(1, arrays, meta)
    assert store.load_latest()[0] == 1
    # the torn .tmp litter was swept by the successful save's gc path
    assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]


# --- proof artifacts --------------------------------------------------------


def test_artifact_store_round_trip(tmp_path):
    store = ProofArtifactStore(str(tmp_path))
    job = ProofJob(job_id="job-3", kind="eigentrust",
                   params={"transcript": "keccak"}, status="done",
                   result={"proof": "deadbeef", "public_inputs": "0102"})
    assert store.persist(job) is True
    data = store.load("job-3")
    assert data["status"] == "done"
    assert data["params"] == {"transcript": "keccak"}
    assert store.proof_bytes("job-3") == bytes.fromhex("deadbeef")
    assert (tmp_path / "job-3" / "public-inputs.bin").read_bytes() \
        == bytes.fromhex("0102")
    rehydrated = ProofJob.from_json(data)
    assert rehydrated.job_id == "job-3"
    assert rehydrated.result == job.result
    assert store.job_ids() == ["job-3"]
    assert store.count() == 1


def test_artifact_store_rejects_path_traversal(tmp_path):
    store = ProofArtifactStore(str(tmp_path))
    for bad in ("../evil", "a/b", "", ".hidden", "x" * 200):
        assert store.load(bad) is None
        assert store.proof_bytes(bad) is None
        assert store.persist(ProofJob(job_id=bad, kind="k",
                                      params={})) is False


def test_artifact_store_orders_numerically(tmp_path):
    store = ProofArtifactStore(str(tmp_path))
    for n in (10, 2, 1):
        store.persist(ProofJob(job_id=f"job-{n}", kind="k", params={},
                               status="done", result={}))
    assert store.job_ids() == ["job-1", "job-2", "job-10"]


def test_artifact_store_disk_fault_injection(tmp_path):
    faults = FaultInjector({"disk": 1.0}, seed=9)
    store = ProofArtifactStore(str(tmp_path), faults=faults)
    job = ProofJob(job_id="job-1", kind="k", params={}, status="done",
                   result={"proof": "aa"})
    assert store.persist(job) is False
    assert store.persist_failures == 1
    assert store.load("job-1") is None  # nothing half-visible
    faults.rates["disk"] = 0.0
    assert store.persist(job) is True
    assert store.proof_bytes("job-1") == b"\xaa"


# --- facade -----------------------------------------------------------------


def test_state_store_metrics_shape(tmp_path):
    store = StateStore(str(tmp_path / "state"))
    store.wal.append([_rec(1)])
    m = store.metrics()
    for key in ("store.wal_segments", "store.wal_bytes",
                "store.snapshot_age_seconds", "store.proof_artifacts",
                "store.replayed_records"):
        assert key in m, f"missing gauge {key}"
    assert m["store.wal_segments"] == 1.0
    assert m["store.wal_bytes"] > 0
    assert m["store.snapshot_age_seconds"] == -1.0  # none taken yet
    store.close()


def test_wal_sync_flushes_tail(tmp_path):
    """``sync()`` makes every committed byte durable under
    ``fsync="never"`` — the live tail AND segments rotated away since
    the last sync (they closed with page-cache-only bytes). The
    format-2 snapshot path calls this before recording its covered
    position — the restored buffer comes from these bytes, not the
    snapshot."""
    wal = AttestationWAL(str(tmp_path), segment_bytes=160,
                         fsync="never")
    for i in range(8):
        wal.append([_rec(i)])
    assert len(wal.segments()) >= 2, "workload never rotated"
    # every rotated-away segment is tracked until a sync covers it
    assert wal._unsynced == set(wal.segments()[:-1])
    wal.sync()
    assert wal._unsynced == set()
    ro = AttestationWAL(str(tmp_path), readonly=True)
    assert [b for b, _, _ in ro.replay()] == list(range(8))
    ro.sync()  # no-op on a readonly handle, not an error
    ro.close()
    # compaction folds the rotated segments away: nothing stale left
    # for the next sync to trip over
    wal.compact(lambda b, a, p: (a,))
    assert wal._unsynced == set()
    wal.sync()
    wal.close()


# --- the two packages' formats, both ways -----------------------------------

import protocol_tpu.store as ref_store  # noqa: E402
import protocol_tpu_torch.store as port_store  # noqa: E402

DIRECTIONS = [pytest.param(ref_store, port_store, id="reference-to-port"),
              pytest.param(port_store, ref_store, id="port-to-reference")]


def _signed_records(n: int):
    """Real signed attestations as WAL records (block, about, payload)."""
    from protocol_tpu_torch.client.attestation import (
        AttestationData,
        SignatureData,
        SignedAttestationData,
    )
    from protocol_tpu_torch.client.eth import ecdsa_keypairs_from_mnemonic

    kps = ecdsa_keypairs_from_mnemonic(
        "test test test test test test test test test test test junk", 3)
    out = []
    for i in range(n):
        att = AttestationData(about=bytes([i + 1]) * 20,
                              domain=b"\x00" * 20, value=i % 9 + 1)
        sig = kps[i % 3].sign(int(att.to_scalar().hash()))
        signed = SignedAttestationData(att, SignatureData.from_signature(sig))
        out.append((10 + i, att.about, signed.to_payload()))
    return out


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_wal_written_by_one_package_reads_in_the_other(tmp_path, writer,
                                                       reader):
    records = _signed_records(6)
    wal = writer.AttestationWAL(str(tmp_path / "w"), segment_bytes=400)
    positions = [wal.append([r]) for r in records]
    wal.close()
    ro = reader.AttestationWAL(str(tmp_path / "w"), readonly=True)
    assert list(ro.replay()) == records
    assert list(ro.replay(positions[2])) == records[3:]
    assert ro.torn_skipped == 0
    # the other package writes the same records to the same bytes
    other = reader.AttestationWAL(str(tmp_path / "r"), segment_bytes=400)
    for r in records:
        other.append([r])
    other.close()
    names = sorted(os.listdir(tmp_path / "w"))
    assert names == sorted(os.listdir(tmp_path / "r"))
    for name in names:
        assert (tmp_path / "w" / name).read_bytes() == \
            (tmp_path / "r" / name).read_bytes()


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_snapshot_written_by_one_package_reads_in_the_other(
        tmp_path, writer, reader):
    addrs = [bytes([i + 1]) * 20 for i in range(5)]
    src, dst = [0, 1, 2, 3], [1, 0, 3, 4]
    val = [5.0, 7.0, 0.0, 2.5]
    table = _FakeTable([10.0, 20.0, 30.0, 40.0], 8)
    args = (addrs, src, dst, val, 9, 3, 1, table, (2, 456))
    arrays_w, meta_w = writer.encode_service_state(*args, n_attestations=17)
    arrays_r, meta_r = reader.encode_service_state(*args, n_attestations=17)
    # the encoded snapshot is the same bytes from either package
    assert meta_w == meta_r
    assert sorted(arrays_w) == sorted(arrays_r)
    for k in arrays_w:
        a, b = np.asarray(arrays_w[k]), np.asarray(arrays_r[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    writer.SnapshotStore(str(tmp_path)).save(9, arrays_w, meta_w)
    step, arrays, meta = reader.SnapshotStore(str(tmp_path)).load_latest()
    assert step == 9
    got = reader.decode_service_state(arrays, meta)
    want = writer.decode_service_state(arrays, meta)
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(got[k], np.ndarray):
            assert got[k].tobytes() == want[k].tobytes(), k
        else:
            assert got[k] == want[k], k
    assert got["addrs"] == addrs and got["wal_pos"] == (2, 456)
    assert got["edges"] == {(0, 1): 5.0, (1, 0): 7.0, (2, 3): 0.0,
                            (3, 4): 2.5}


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_format1_snapshot_reads_in_both_packages(writer, reader):
    """A format-1 snapshot (the attestation buffer inside it) written by
    either package decodes to the same records in the other."""
    records = _signed_records(2)
    arrays, meta = writer.encode_service_state(
        [bytes([1]) * 20, bytes([2]) * 20], [0], [1], [5.0], 1, 0, 0,
        _FakeTable([1.0, 2.0], 1), (1, 8))
    blob = b"".join(writer.encode_record(*r) for r in records)
    arrays["att_blob"] = np.frombuffer(blob, dtype=np.uint8)
    meta = dict(meta)
    meta.pop("fmt")
    st = reader.decode_service_state(arrays, meta)
    assert st["buffer_in_snapshot"] is True
    assert st["att_records"] == records
