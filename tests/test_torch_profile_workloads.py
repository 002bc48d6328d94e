"""The port's profile library workloads and the proof pool's affinity keys
held to the reference's on the CPU.

- ``run_commits_workload``, ``run_proofs_workload``,
  ``run_sharded_workload`` and ``run_fabric_workload`` of both packages
  at k = 7 on the same arguments: each passes its own parity assertions
  and returns the same metadata but for the split of jobs, shard units
  and fabric units between workers, which thread timing decides. Job
  counts are cut to one or two (a k = 7 host prove takes ~0.6 s here).
- ``make_cache_key_fn`` and ``identity_digest_of`` give the reference's
  keys, ``TrustService.identity_digest`` is cached per graph revision,
  the daemon's own registry keys its pool with them and an injected one
  keeps kind-keyed affinity; twins of ``tests/test_pool.py``'s affinity
  and stealing cases run on the port's pool.

The reference's ``run_worker`` names its heartbeat thread ``beat``, the
name of its watchdog callback, and so raises on the pass after its first
unit (ROADMAP C). Its fabric workload runs here with that worker
restarted after each unit; the port's runs its own repaired loop."""

import threading
import time
from types import SimpleNamespace

import pytest
import torch

from protocol_tpu.cli import profilecmd as ref_prof
from protocol_tpu.service import provers as ref_provers
from protocol_tpu.utils import trace as ref_trace
from protocol_tpu.zk import fabric as ref_fabric
from protocol_tpu_torch.cli import profilecmd as port_prof
from protocol_tpu_torch.service import FaultInjector
from protocol_tpu_torch.service import provers as port_provers
from protocol_tpu_torch.service.pool import ProofWorkerPool
from protocol_tpu_torch.utils import trace as port_trace

MNEMONIC = "test test test test test test test test test test test junk"
NO_FAULTS = FaultInjector({"rpc": 0.0, "device": 0.0, "disk": 0.0})


@pytest.fixture()
def tracers():
    """Both tracers on (the shard and fabric counters count only while
    enabled), reset before and after."""
    was = (ref_trace.TRACER.enabled, port_trace.TRACER.enabled)
    for t in (ref_trace, port_trace):
        t.TRACER.reset()
        t.TRACER.reset_instruments()
        t.enable()
    yield
    for t, on in zip((ref_trace, port_trace), was):
        t.TRACER.reset()
        t.TRACER.reset_instruments()
        t.TRACER.enabled = on


@pytest.fixture()
def ref_worker_restarted(monkeypatch):
    orig = ref_fabric.run_worker

    def run_worker(fabric, name, stop=None, **kw):
        while not stop.is_set():
            try:
                orig(fabric, name, stop=stop, **kw)
            except TypeError:  # the reference's ``beat`` fault
                continue

    monkeypatch.setattr(ref_fabric, "run_worker", run_worker)


WORKLOADS = [
    ("commits", {"k": 7, "columns": 2}, ()),
    ("proofs", {"k": 7, "jobs": 2, "workers": 2}, ("per_worker",)),
    ("sharded", {"k": 7, "jobs": 1, "workers": 2}, ("shards", "lent")),
    ("fabric", {"k": 7, "jobs": 1}, ("units",)),
]


@pytest.mark.parametrize("name,kw,split", WORKLOADS,
                         ids=[w[0] for w in WORKLOADS])
def test_workload_matches_the_reference(name, kw, split, tracers,
                                        ref_worker_restarted):
    ref = getattr(ref_prof, f"run_{name}_workload")(**kw)
    port = getattr(port_prof, f"run_{name}_workload")(**kw)
    assert ({k: v for k, v in port.items() if k not in split}
            == {k: v for k, v in ref.items() if k not in split})
    assert sorted(port) == sorted(ref)
    if name == "proofs":
        assert sum(port["per_worker"].values()) == kw["jobs"]
    for key in ("shards", "units"):
        if key in split:
            assert port[key] > 0 and ref[key] > 0


# --- affinity keys ------------------------------------------------------------

def test_cache_keys_are_the_reference_keys():
    addrs = [bytes([i]) * 20 for i in range(1, 5)]
    digest = port_provers.identity_digest_of(addrs)
    assert digest == ref_provers.identity_digest_of(addrs)
    svc = SimpleNamespace(identity_digest=lambda: digest)
    for shape in ("tiny", "default"):
        port_fn = port_provers.make_cache_key_fn(svc, shape_name=shape)
        ref_fn = ref_provers.make_cache_key_fn(svc, shape_name=shape)
        for kind in ("eigentrust", "threshold", "profile", "echo"):
            assert port_fn(kind, {}) == ref_fn(kind, {})
    tiny = port_provers.make_cache_key_fn(svc, shape_name="tiny")
    assert tiny("eigentrust", {}) == f"eigentrust-k20-{digest}"
    assert tiny("profile", {}) is None


def _att(about: bytes, value: int):
    return SimpleNamespace(attestation=SimpleNamespace(about=about,
                                                       value=value))


def test_daemon_keys_its_own_provers_by_identity(tmp_path):
    """The daemon's default registry keys the pool by kind, k and the
    participant digest, recomputed once per graph revision; an injected
    registry keeps the pool's kind keys."""
    from protocol_tpu_torch.cli.fs import EigenFile
    from protocol_tpu_torch.client import Client, ClientConfig
    from protocol_tpu_torch.service import ServiceConfig, TrustService

    client = Client(ClientConfig(), MNEMONIC, device="cpu")
    svc = TrustService(client, ServiceConfig(port=0, proof_shape="tiny"),
                       str(tmp_path / "cursor"), files=EigenFile(tmp_path))
    try:
        key = svc.jobs.cache_key_fn
        empty = port_provers.identity_digest_of([])
        assert svc.identity_digest() == empty
        assert key("eigentrust", {}) == f"eigentrust-k20-{empty}"
        a, b = b"\x01" * 20, b"\x02" * 20
        svc.graph.apply([_att(b, 5)], [a])
        digest = port_provers.identity_digest_of([a, b])
        assert svc.identity_digest() == digest != empty
        assert svc._ident_digest == (svc.graph.revision, digest)
        assert key("threshold", {}).endswith(f"-{digest}")
        assert key("profile", {}) is None
    finally:
        svc.watchdog.stop()
    svc = TrustService(client, ServiceConfig(port=0),
                       str(tmp_path / "cursor2"),
                       provers={"eigentrust": lambda p: p})
    try:
        assert svc.jobs.cache_key_fn("eigentrust", {}) == "eigentrust"
    finally:
        svc.watchdog.stop()


def _wait(cond, timeout=15.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting: {what}"
        time.sleep(0.01)


def _drain_all(pool, n, timeout=30.0):
    _wait(lambda: pool.completed + pool.failed >= n, timeout,
          f"{n} terminal jobs")


def test_cache_affinity_routes_to_resident_worker():
    """Twin of the reference's case: jobs route to the worker whose
    prover cache holds their key (inspected at the queues), residency is
    recorded after a run, and hits are counted."""
    gate = threading.Event()

    def prove(params):
        gate.wait(10)
        return {}

    pool = ProofWorkerPool(
        {"et": prove, "th": prove, "block": prove}, capacity=64,
        workers=2, faults=NO_FAULTS,
        cache_key_fn=lambda kind, params:
        None if kind == "block" else f"{kind}-k20-abc")
    pool.start()
    pool.submit("block", {})
    pool.submit("block", {})
    _wait(lambda: all(w.running is not None for w in pool.workers),
          what="both workers parked")
    with pool._lock:
        pool.workers[0].resident["et-k20-abc"] = True
        pool.workers[1].resident["th-k20-abc"] = True
    for _ in range(3):
        pool.submit("et", {})
    for _ in range(3):
        pool.submit("th", {})
    with pool._lock:
        w0_queued = {k: len(q) for k, q in pool.workers[0].kinds.items()}
        w1_queued = {k: len(q) for k, q in pool.workers[1].kinds.items()}
    assert w0_queued == {"et": 3}, (w0_queued, w1_queued)
    assert w1_queued == {"th": 3}, (w0_queued, w1_queued)
    gate.set()
    _drain_all(pool, 8)
    rows = {r["worker"]: r for r in pool.pool_status()["workers"]}
    hits = rows["w0"]["affinity_hits"] + rows["w1"]["affinity_hits"]
    assert hits >= 4, rows
    assert "et-k20-abc" in rows["w0"]["resident"] or \
        "et-k20-abc" in rows["w1"]["resident"]
    assert pool.drain(5.0) is True


def test_idle_worker_steals_backlog():
    """Twin of the reference's case: one hot key queues on one worker,
    and the idle worker steals from its backlog."""
    gate = threading.Event()

    def prove(params):
        gate.wait(10)
        return {}

    pool = ProofWorkerPool(
        {"et": prove}, capacity=64, workers=2, faults=NO_FAULTS,
        cache_key_fn=lambda kind, params: "hot-key")
    pool.start()
    jobs = [pool.submit("et", {"i": i}) for i in range(6)]
    _wait(lambda: sum(1 for w in pool.workers
                      if w.running is not None) == 2,
          what="steal put both workers to work")
    gate.set()
    _drain_all(pool, 6)
    used = {pool.get(j.job_id).worker for j in jobs}
    assert used == {"w0", "w1"}
    assert sum(r["stolen"] for r in pool.pool_status()["workers"]) >= 1
    assert pool.drain(5.0) is True


def test_port_workloads_need_no_gpu_but_commit_on_it_when_asked(
        monkeypatch):
    """Under ``PTPU_MSM_DEVICE=1`` the commits workload goes to the
    device MSM on its ``device``: the card by default, which raises
    here, where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    monkeypatch.setenv("PTPU_MSM_DEVICE", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_prof.run_commits_workload(k=3, columns=1)
