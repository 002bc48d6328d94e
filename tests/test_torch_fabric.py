"""The port's proving fabric (``protocol_tpu_torch/zk/fabric.py``) and
the pool's worker lending held to the reference's
(``tests/test_fabric.py``) on the CPU: frames byte-equal to the
reference's, envelopes and payloads written by one package read by the
other, each executor kind (``quotient``, ``open_fold``, ``commit``)
giving byte-equal framed results in both packages on payloads a real
prove published, the lease protocol, and a prove sharded through the
port's pool onto an external worker byte-identical to the reference's
``prove_fast``.

No test races a worker against the rendezvous: the sharded prove's
fabric store returns from ``publish`` only once the external worker
holds the unit's lease, so every published unit is executed remotely;
the lease-expiry test parks the submitting thread on a gate while it
plants a lease that lapses."""

import random
import threading
import time

import numpy as np
import pytest

from protocol_tpu_torch.service import FaultInjector
from protocol_tpu_torch.service.pool import ProofWorkerPool
from protocol_tpu_torch.utils import trace
from protocol_tpu_torch.utils.fields import BN254_FR_MODULUS
from protocol_tpu_torch.zk import fabric as port_fab
from protocol_tpu_torch.zk.shards import ShardUnit, shard_map, shard_scope

ref_fab = pytest.importorskip("protocol_tpu.zk.fabric")

FABS = pytest.mark.parametrize("fab", [ref_fab, port_fab],
                               ids=["reference", "port"])
NO_FAULTS = {"rpc": 0.0, "device": 0.0, "disk": 0.0}
RANDINT = 424242


def _wait(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting: {what}"
        time.sleep(0.01)


@pytest.fixture(autouse=True)
def _echo_executor():
    for fab in (ref_fab, port_fab):
        fab.EXECUTORS["echo"] = lambda p: {"value": p.get("arr")}
    yield
    for fab in (ref_fab, port_fab):
        fab.EXECUTORS.pop("echo", None)


@pytest.fixture()
def tracer():
    was = trace.TRACER.enabled
    trace.TRACER.reset()
    trace.TRACER.reset_instruments()
    trace.enable()
    yield trace.TRACER
    trace.TRACER.reset()
    trace.TRACER.reset_instruments()
    if not was:
        trace.TRACER.disable()


def _echo_unit(fab, seq=0):
    payload = {"arr": np.arange(16, dtype="<u8").reshape(4, 4),
               "shared": fab.Shared(np.full((3, 4), 7, dtype="<u8")),
               "tag": "t"}
    return ShardUnit("quotient", lambda: "local", seq,
                     portable=port_fab.PortableUnit("echo", lambda: payload))


# --- wire format ---------------------------------------------------------


def test_frames_equal_the_reference():
    """One object, one meta: the same frame bytes from both packages,
    and each package decodes the other's frame to the same arrays."""
    obj = {"arrays": {"a": np.arange(24, dtype="<u8").reshape(2, 3, 4),
                      "b": np.linspace(0, 1, 5)},
           "scalars": {"big": str(2**254 - 3), "n": 7},
           "list": [1, "x", np.zeros((2, 4), dtype="<u8")]}
    meta = {"worker": "fw9", "wall_s": 0.125}
    data = port_fab.frame(obj, meta=meta)
    assert data == ref_fab.frame(obj, meta=meta)
    for unframe in (port_fab.unframe, ref_fab.unframe):
        out, got_meta = unframe(data)
        assert got_meta == meta
        assert out["arrays"]["a"].dtype == np.dtype("<u8")
        assert (out["arrays"]["a"] == obj["arrays"]["a"]).all()
        assert (out["list"][2] == 0).all() and out["list"][1] == "x"
        out["arrays"]["a"][0, 0, 0] = 99  # decoded arrays own their memory


@FABS
def test_frame_detects_torn_and_corrupt(fab):
    data = fab.frame({"x": np.arange(8, dtype="<u8")})
    flipped = bytearray(data)
    flipped[len(data) // 2] ^= 0xFF
    for bad in (data[:-3], data[: len(data) // 2], b"NOPE" + data[4:],
                data[:-4] + b"\x00" * 4, b"", data[:10], bytes(flipped)):
        with pytest.raises(fab.FabricError):
            fab.unframe(bad)


@pytest.mark.parametrize("writer,reader", [(port_fab, ref_fab),
                                           (ref_fab, port_fab)],
                         ids=["port-to-reference", "reference-to-port"])
def test_envelope_written_by_one_package_read_by_the_other(
        tmp_path, writer, reader):
    """Publish with one package's store, claim, load and answer with the
    other's on the same directory: envelope fields, the shared blob
    resolved by digest, the lease, and the result with its worker name
    and wall."""
    pub = writer.FabricStore(str(tmp_path / "fabric"), lease_ttl=5.0)
    unit = _echo_unit(writer)
    fid = pub.publish("j1", unit)
    assert unit.fabric_id == fid
    wrk = reader.FabricStore(str(tmp_path / "fabric"), lease_ttl=5.0)
    (env,) = wrk.list_units()
    assert (env["unit"], env["job_id"], env["stage"], env["seq"],
            env["kind"]) == (fid, "j1", "quotient", 0, "echo")
    payload = wrk.load_payload(env)
    assert (payload["arr"] == np.arange(16).reshape(4, 4)).all()
    assert (payload["shared"] == 7).all() and payload["tag"] == "t"
    assert wrk.claim(fid, "fw0") and not pub.claim(fid, "fw1")
    assert pub.lease_state(fid) == "live"
    wrk.put_result(fid, reader.execute_unit(env, payload), "fw0",
                   wall=0.125)
    obj, worker, wall = pub.try_result(fid)
    assert worker == "fw0" and wall == pytest.approx(0.125)
    assert (obj["value"] == payload["arr"]).all()
    assert wrk.list_units() == []
    pub.retire(fid, list(env["shared"]) + [env["payload"]])
    assert pub.try_result(fid) is None


@FABS
def test_torn_result_reads_as_missing(tmp_path, fab):
    store = fab.FabricStore(str(tmp_path / "fabric"))
    fid = store.publish("j1", _echo_unit(fab))
    good = fab.frame({"value": 1}, meta={"unit": fid, "worker": "fw0"})
    path = store._path("results", fid + ".bin")
    for data, readable in ((good[: len(good) // 2], False),
                           (b"not a frame at all", False), (good, True)):
        with open(path, "wb") as f:
            f.write(data)
        assert (store.try_result(fid) is not None) == readable


@FABS
def test_duplicate_result_after_lease_takeover(tmp_path, fab):
    store = fab.FabricStore(str(tmp_path / "fabric"), lease_ttl=0.05)
    fid = store.publish("j1", _echo_unit(fab))
    assert store.claim(fid, "fw0", ttl=0.05)
    time.sleep(0.1)  # fw0 dies: its lease lapses
    assert store.lease_state(fid) == "expired"
    assert store.claim(fid, "fw1", ttl=5.0)  # takeover
    store.put_result(fid, {"value": 42}, "fw0")
    store.put_result(fid, {"value": 42}, "fw1")
    obj, worker, wall = store.try_result(fid)
    assert obj["value"] == 42 and worker in ("fw0", "fw1") and wall is None


@FABS
def test_worker_registry_and_lease_age(tmp_path, fab):
    store = fab.FabricStore(str(tmp_path / "fabric"))
    assert store.workers_live() == 0
    store.register_worker("fw0", ttl=5.0)
    store.register_worker("fw1", ttl=0.01)
    time.sleep(0.05)
    store._workers_cache = (0.0, 0)
    assert store.workers_live() == 1
    assert store.oldest_lease_age() == 0.0
    fid = store.publish("j1", _echo_unit(fab))
    store.claim(fid, "fw0", ttl=5.0)
    time.sleep(0.05)
    assert store.oldest_lease_age() > 0.0
    store.unregister_worker("fw0")
    store._workers_cache = (0.0, 0)
    assert store.workers_live() == 0
    with pytest.raises(fab.FabricError):
        fab.execute_unit({"kind": "no-such-kind"}, {})


@FABS
def test_run_worker_keeps_its_beat_across_units(tmp_path, fab):
    """``run_worker`` with a watchdog ``beat`` over three units. The
    reference's loop rebinds ``beat`` to each unit's lease-heartbeat
    thread, so its next pass calls a ``Thread`` and raises TypeError;
    the port's keeps the callback and runs all three."""
    store = fab.FabricStore(str(tmp_path / "fabric"))
    for seq in range(3):
        store.publish("j1", _echo_unit(fab, seq))
    beats = []
    run = lambda: fab.run_worker(  # noqa: E731
        store, "fw0", poll=0.01, max_units=3, idle_exit=5.0,
        beat=lambda: beats.append(1))
    if fab is ref_fab:
        with pytest.raises(TypeError, match="not callable"):
            run()
        return
    assert run() == 3 and len(beats) >= 2
    assert store.list_units() == []


# --- executors on a real prove's units --------------------------------------


def _circuit(zk):
    rng = random.Random(7)
    cs = zk.plonk.ConstraintSystem(lookup_bits=6)
    r = BN254_FR_MODULUS
    for _ in range(24):
        a, b = rng.randrange(50), rng.randrange(50)
        cs.add_row([a, b, (a * b + a) % r], q_a=1, q_mul_ab=1, q_c=r - 1)
    cs.public_input(12345)
    cs.check_satisfied()
    params = zk.prover_fast.setup_params_fast(7, seed=b"fabric")
    return params, zk.prover_fast.keygen_fast(params, cs), cs


@pytest.fixture(scope="module")
def proves():
    """(reference prove_fast bytes, port (params, pk, cs)), one k = 7
    circuit built by each package."""
    import protocol_tpu.zk.plonk  # noqa: F401
    import protocol_tpu.zk.prover_fast  # noqa: F401
    from protocol_tpu import native as ref_native
    from protocol_tpu import zk as ref_zk

    import protocol_tpu_torch.zk.plonk  # noqa: F401
    import protocol_tpu_torch.zk.prover_fast  # noqa: F401
    from protocol_tpu_torch import zk as port_zk

    if not ref_native.available():
        pytest.skip("the reference's native toolchain is unavailable")
    ref_params, ref_pk, ref_cs = _circuit(ref_zk)
    reference = ref_zk.prover_fast.prove_fast(ref_params, ref_pk, ref_cs,
                                              randint=lambda: RANDINT)
    return reference, _circuit(port_zk)


class _PublishingRunner:
    """A shard runner that publishes every portable unit to a fabric
    store and then runs all units on the submitting thread."""

    fanout = 2

    def __init__(self, store):
        self.store = store

    def dispatch(self, units):
        for u in units:
            if u.portable is not None:
                self.store.publish("job-x", u)

    def rendezvous(self, units):
        for u in units:
            if not u.done.is_set():
                u.run()
        err = next((u.error for u in units if u.error is not None), None)
        if err is not None:
            raise err


def test_executors_give_the_reference_bytes(tmp_path, proves):
    """A port prove run under a runner that publishes its units: the
    proof is the reference's, and for every unit (commit groups, host
    quotient row chunks, the two opening folds) both packages' stores
    load the same payload and both packages' ``execute_unit`` give
    byte-equal framed results."""
    from protocol_tpu_torch.zk.prover_fast import prove_fast

    reference, (params, pk, cs) = proves
    store = port_fab.FabricStore(str(tmp_path / "fabric"))
    with shard_scope(_PublishingRunner(store)):
        proof = prove_fast(params, pk, cs, randint=lambda: RANDINT)
    assert proof == reference
    envelopes = store.list_units()
    kinds = {env["kind"] for env in envelopes}
    assert kinds == {"commit", "quotient", "open_fold"}, kinds
    ref_store = ref_fab.FabricStore(str(tmp_path / "fabric"))
    for env in envelopes:
        ours = port_fab.execute_unit(env, store.load_payload(env))
        theirs = ref_fab.execute_unit(env, ref_store.load_payload(env))
        assert port_fab.frame(ours) == ref_fab.frame(theirs), env["kind"]


class _LeasedFirst(port_fab.FabricStore):
    """``publish`` returns only once an external worker holds the
    unit's lease: the rendezvous then always finds it live and waits for
    the remote result, so no unit races to local execution."""

    def publish(self, job_id, unit):
        fid = super().publish(job_id, unit)
        _wait(lambda: self.lease_state(fid) != "none",
              what=f"the external worker's lease on {fid}")
        return fid


def test_sharded_prove_on_an_external_worker_is_the_reference_proof(
        tmp_path, proves, tracer):
    """A prove submitted to the port's pool (``shard_kinds``, one pool
    worker, the fabric) while ``run_worker`` polls the same fabric
    directory as an external worker: fan-out counts the external worker,
    every published unit is executed by it (``prove.shard`` spans with
    ``remote=1`` under its name, ``fabric_units`` counted), and the
    proof is byte-identical to the reference's ``prove_fast``."""
    from protocol_tpu_torch.zk import prover_fast as pf

    reference, (params, pk, cs) = proves
    root = str(tmp_path / "fabric")
    store = _LeasedFirst(root, lease_ttl=5.0)
    pool = ProofWorkerPool(
        {"eigentrust": lambda p: {"proof": pf.prove_fast(
            params, pk, cs, randint=lambda: RANDINT).hex()}},
        capacity=8, workers=1, faults=FaultInjector(NO_FAULTS),
        shard_kinds={"eigentrust"}, shard_cap=4,
        worker_env=lambda w: pf.worker_isolation(w.name, w.device),
        fabric=store)
    pool.start()
    stop = threading.Event()
    worker = threading.Thread(
        target=port_fab.run_worker,
        args=(port_fab.FabricStore(root, lease_ttl=5.0), "fw-inproc"),
        kwargs={"poll": 0.01, "stop": stop}, daemon=True,
        name="fabric-test-worker")
    worker.start()
    try:
        _wait(lambda: store.workers_live() >= 1, what="registration")
        job = pool.submit("eigentrust", {})
        _wait(lambda: pool.get(job.job_id).status in ("done", "failed"),
              timeout=120, what="the sharded prove")
        got = pool.get(job.job_id)
        assert got.status == "done", got.error
        assert bytes.fromhex(got.result["proof"]) == reference
        published = store.published
        remote = [s for s in tracer.spans if s.name == "prove.shard"
                  and s.fields.get("remote") == 1]
        assert published > 0 and len(remote) == published
        assert {s.fields.get("worker") for s in remote} == {"fw-inproc"}
        assert trace.counter_total("fabric_units") == published
        status = pool.pool_status()
        assert status["shard_kinds"] == ["eigentrust"]
        assert status["fabric"]["units_published"] == published
        stop.set()
        worker.join(timeout=10)
        assert not worker.is_alive()
    finally:
        stop.set()
        worker.join(timeout=10)
        pool.drain(5.0)


def test_fanout_counts_live_fabric_workers(tmp_path, tracer):
    """A one-worker pool shards only when an external worker is
    registered: its registration counts toward the fan-out."""
    store = port_fab.FabricStore(str(tmp_path / "fabric"))

    def prove(params):
        return {"vals": shard_map("quotient", [lambda: 1, lambda: 2])}

    pool = ProofWorkerPool({"eigentrust": prove}, capacity=8, workers=1,
                           faults=FaultInjector(NO_FAULTS),
                           shard_kinds={"eigentrust"}, shard_cap=4,
                           fabric=store)
    pool.start()
    try:
        for registered, shards in ((False, 0), (True, 2)):
            if registered:
                store.register_worker("fw-ext", ttl=30.0)
                store._workers_cache = (0.0, 0)
            s0 = trace.counter_total("prove_shards")
            job = pool.submit("eigentrust", {})
            _wait(lambda: pool.get(job.job_id).status
                  in ("done", "failed"))
            got = pool.get(job.job_id)
            assert got.status == "done" and got.result == {"vals": [1, 2]}
            assert trace.counter_total("prove_shards") - s0 == shards
    finally:
        pool.drain(5.0)


def test_lapsed_lease_is_reclaimed(tmp_path, tracer):
    """A worker that takes a unit's lease and dies: the rendezvous waits
    out the lease, counts ``fabric_leases_expired``, runs the unit
    locally and returns the in-process result. Unit 0 is local-only and
    parks the submitting thread on a gate while the test plants the
    lease on unit 2."""
    store = port_fab.FabricStore(str(tmp_path / "fabric"), lease_ttl=0.3)
    store.register_worker("fw-doomed", ttl=30.0)
    gate = threading.Event()

    def prove(params):
        def gated():
            gate.wait(timeout=30)
            return 0

        return {"vals": shard_map(
            "quotient", [gated, lambda: 1, lambda: 2],
            portables=[None,
                       port_fab.PortableUnit("echo", lambda: {"arr": 1}),
                       port_fab.PortableUnit("echo", lambda: {"arr": 2})])}

    pool = ProofWorkerPool({"eigentrust": prove}, capacity=8, workers=1,
                           faults=FaultInjector(NO_FAULTS),
                           shard_kinds={"eigentrust"}, shard_cap=4,
                           fabric=store)
    pool.start()
    try:
        job = pool.submit("eigentrust", {})
        _wait(lambda: len(store.list_units()) == 2, what="publish")
        last = store.list_units()[-1]["unit"]
        assert store.claim(last, "fw-doomed", ttl=0.3)
        gate.set()
        _wait(lambda: pool.get(job.job_id).status in ("done", "failed"))
        got = pool.get(job.job_id)
        assert got.status == "done" and got.result == {"vals": [0, 1, 2]}
        assert trace.counter_total("fabric_leases_expired") >= 1
    finally:
        gate.set()
        pool.drain(5.0)


def test_msm_device_seam_still_names_a6b(monkeypatch):
    """``PTPU_MSM_DEVICE=1`` commits through the port's device MSM (ROADMAP
    A6b, ported): with a CPU ``msm_device`` (the kernels' plain
    versions), an eval column with blinds, zero scalars and an identity
    base dropped, and a coefficient column give the host engine's
    points byte for byte, and such a commit has no portable form. A
    full 264-bit sweep costs ~30 s an MSM on the CPU, so the scalars stay
    below 2^8 and the sweep is bounded to those 8 bits by the module's
    ``SCALAR_BITS``; the card runs the full width in ``chip_smoke.py``."""
    from protocol_tpu_torch.ops import msm_device as md
    from protocol_tpu_torch.zk import prover_fast as pf
    from protocol_tpu_torch.zk.bn254 import g1_msm
    from protocol_tpu_torch.zk.commit_engine import CommitEngine, _device_msm

    params = pf.setup_params_fast(3, seed=b"msm-device-seam")
    rng = np.random.default_rng(3)
    cols = np.zeros((2, 8, 4), dtype="<u8")
    cols[:, :, 0] = rng.integers(0, 256, size=(2, 8))
    cols[0, 2, 0] = 0

    def commits():
        eng = CommitEngine(params, msm_device="cpu")
        eng.submit_evals("evals", cols[0], blinds=[5, 7])
        eng.submit_coeffs("coeffs", cols[1])
        return eng, eng.flush()

    monkeypatch.delenv("PTPU_MSM_DEVICE", raising=False)
    _, host = commits()
    monkeypatch.setenv("PTPU_MSM_DEVICE", "1")
    monkeypatch.setattr(md, "SCALAR_BITS", 8)
    eng, dev = commits()
    assert dev == host and None not in host
    assert eng._commit_portable(("srs", 8), []) is None
    # an identity base is dropped, as the host oracle drops it
    pts = eng._device_base_points("srs", 8, pf.srs_limbs(params)[:8])
    pts = [None] + pts[1:]
    want = g1_msm(pts[1:], [int(v) for v in cols[1, 1:, 0]])
    assert _device_msm(pts, cols[1], "cpu") == want