"""The port's instrument seam against the reference's.

The same calls go to both packages, each with its own enabled process
tracer (reset before and after). They must leave the same series: the
same instrument names and kinds with the same label keys (the converge
instruments labelled ``{backend, semiring}``), and the same values where
the inputs are the same; the backend label reads ``torch-*`` where the
reference's reads ``jax-*``. A JSONL record the port streams must pass
the reference's ``validate_record``.

Only the series the test's own calls record are compared: a service
thread another test left alive (a stall watchdog writing ``thread_*``
gauges) shares the process tracer, so each tracer notes the instrument
names fetched on the test's thread, and ``_series`` keeps those.
"""

import json
import random
import threading

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from protocol_tpu import backend as ref_backend
from protocol_tpu import incremental as ref_inc
from protocol_tpu.graph import barabasi_albert_edges
from protocol_tpu.ops import converge as ref_conv
from protocol_tpu.ops import routed as ref_routed
from protocol_tpu.utils import trace as ref_trace
from protocol_tpu_torch import backend as port_backend
from protocol_tpu_torch import incremental as port_inc
from protocol_tpu_torch.ops import converge as port_conv
from protocol_tpu_torch.ops import routed as port_routed
from protocol_tpu_torch.utils import trace as port_trace

N = 120


_OWN = {}  # id(tracer) -> instrument names fetched on the test's thread


def _note_own(tracer, ident):
    """Wrap ``tracer._instrument`` (what ``counter``/``gauge``/
    ``histogram`` fetch through) to note the names asked for on the
    thread ``ident``; returns the set."""
    own = _OWN[id(tracer)] = set()
    fetch = tracer._instrument

    def noting(name, *args, **kwargs):
        if threading.get_ident() == ident:
            own.add(name)
        return fetch(name, *args, **kwargs)

    tracer._instrument = noting
    return own


@pytest.fixture()
def tracers():
    was = [ref_trace.TRACER.enabled, port_trace.TRACER.enabled]
    for t in (ref_trace.TRACER, port_trace.TRACER):
        t.reset()
        t.reset_instruments()
        t.enable()
        _note_own(t, threading.get_ident())
    yield ref_trace.TRACER, port_trace.TRACER
    for t, on in zip((ref_trace.TRACER, port_trace.TRACER), was):
        del t._instrument  # the class's method again
        _OWN.pop(id(t), None)
        t.reset()
        t.reset_instruments()
        t.compile_tracker.reset()
        if not on:
            t.disable()


def _series(tracer, rename=None):
    """``{(name, kind): {labels: value}}`` of the instruments the test's
    own calls fetched: gauges and counters by value, histograms by
    observation count; ``rename`` maps label values. The ``xla_*``
    compile instruments are left out: only the reference compiles (the
    port's ``compile_stats()`` reads zero)."""
    rename = rename or {}
    own = _OWN[id(tracer)]
    out = {}
    for inst in tracer.instruments():
        if inst.name.startswith("xla_") or inst.name not in own:
            continue
        rows = (inst.series() if inst.kind == "histogram"
                else inst.samples())
        out[(inst.name, inst.kind)] = {
            tuple((k, rename.get(v, v)) for k, v in labels):
            (v["count"] if inst.kind == "histogram" else v)
            for labels, v in rows}
    return out


def _label_keys(series):
    return {key: sorted({tuple(k for k, _ in labels) for labels in rows})
            for key, rows in series.items()}


def _events(tracer):
    return [(name, fields) for _, name, fields in tracer.events]


def test_record_converge_stats_gives_the_reference_series(tracers):
    ref, port = tracers
    calls = [(("test-backend", 10, 1e-7, 2.0), {"n": 100}),
             (("fixed-backend", 5, None, 1.0), {}),
             (("test-backend", 7, 3e-9, 0.7), {"semiring": "maxplus"})]
    for args, kw in calls:
        ref_conv.record_converge_stats(*args, **kw)
        port_conv.record_converge_stats(*args, **kw)
    for mode in ("partial", "sampled", "full"):
        ref_conv.record_refresh_scope(mode)
        port_conv.record_refresh_scope(mode)
    assert _series(port) == _series(ref)
    assert _events(port) == _events(ref)
    assert port.gauge("converge_iterations").value(
        backend="test-backend", semiring="plusmul") == 10
    assert port.histogram("converge_sweep_seconds").series()[0][1]["sum"] \
        == pytest.approx(0.2)


def test_backends_and_build_report_the_reference_instruments(tracers):
    ref, port = tracers
    src, dst, val = barabasi_albert_edges(N, 3, seed=3)
    valid = np.ones(N, dtype=bool)
    pairs = ((ref_backend.JaxSparseBackend(),
              port_backend.TorchSparseBackend(device="cpu")),
             (ref_backend.JaxRoutedBackend(),
              port_backend.TorchRoutedBackend(device="cpu")))
    for rb, pb in pairs:
        r = rb.converge_edges(N, src, dst, val, valid, 1000.0, 200, tol=1e-6)
        p = pb.converge_edges(N, src, dst, val, valid, 1000.0, 200, tol=1e-6)
        assert p[1] == r[1]
        rb.converge_edges(N, src, dst, val, valid, 1000.0, 5,
                          semiring="maxplus")
        pb.converge_edges(N, src, dst, val, valid, 1000.0, 5,
                          semiring="maxplus")
    rename = {"jax-sparse": "torch-sparse", "jax-routed": "torch-routed"}
    rs, ps = _series(ref, rename), _series(port)
    assert _label_keys(ps) == _label_keys(rs)
    assert ps.keys() == rs.keys()
    for key in (("converge_iterations", "gauge"),
                ("operator_full_builds", "counter"),
                ("routed_plan_build_seconds", "histogram"),
                ("converge_sweep_seconds", "histogram")):
        assert ps[key] == rs[key], key
    # one full build per routed converge given no operator
    assert ps[("operator_full_builds", "counter")] == {(): 2.0}
    for name in ("converge.edges", "routed.plan_build"):
        assert port.summary()[name]["count"] == ref.summary()[name]["count"]
    assert port_trace.compile_stats()["compiles"] == 0


def test_delta_engine_reports_the_reference_instruments(tracers, tmp_path):
    """The engine's ``operator_delta_seconds{kind}``, ``dirty_rows`` and
    ``delta.applied`` on the same churn, its converge under
    ``torch-routed-delta``; every record of the port's JSONL stream
    passes the reference's schema check."""
    ref, port = tracers
    port.enable(str(tmp_path / "trace.jsonl"))
    src, dst, val = barabasi_albert_edges(N, 3, seed=4)
    valid = np.ones(N, dtype=bool)
    re_ = ref_inc.DeltaEngine.anchor(
        N, src, dst, val, valid,
        ref_routed.build_routed_operator(N, src, dst, val, valid),
        dtype=jnp.float64)
    pe = port_inc.DeltaEngine.anchor(
        N, src, dst, val, valid,
        port_routed.build_routed_operator(N, src, dst, val, valid),
        dtype=torch.float64, device="cpu")
    window = [(int(re_.fsrc[k]), int(re_.fdst[k]), None, 4.0 + k)
              for k in range(0, 40, 4)] + [(0, N - 1, None, 2.0)]
    assert re_.apply_deltas(window) and pe.apply_deltas(window)
    re_.converge(re_.initial_node_scores(1000.0), 100, 1e-6)
    pe.converge(pe.initial_node_scores(1000.0), 100, 1e-6)
    rs = _series(ref, {"jax-routed-delta": "torch-routed-delta"})
    ps = _series(port)
    assert _label_keys(ps) == _label_keys(rs)
    for key in (("operator_delta_seconds", "histogram"),
                ("dirty_rows", "gauge"), ("converge_iterations", "gauge")):
        assert ps[key] == rs[key], key
    assert [e for e in _events(port) if e[0] == "delta.applied"] == \
        [e for e in _events(ref) if e[0] == "delta.applied"]
    port.disable()
    lines = (tmp_path / "trace.jsonl").read_text().splitlines()
    records = [json.loads(line) for line in lines]
    assert {r["type"] for r in records} >= {"span", "event"}
    assert {"delta.classify", "routed.plan_build", "converge.edges"} <= {
        r["name"] for r in records if r["type"] == "span"}
    for r in records:
        assert ref_trace.validate_record(r) is None, r


def test_ingest_runs_under_the_reference_spans(tracers):
    from protocol_tpu_torch.client import ingest
    from protocol_tpu_torch.client.attestation import (
        AttestationData,
        SignatureData,
        SignedAttestationData,
    )
    from protocol_tpu_torch.crypto.secp256k1 import N as ORDER
    from protocol_tpu_torch.crypto.secp256k1 import EcdsaKeypair

    _, port = tracers
    rng = random.Random(3)
    kp = EcdsaKeypair(rng.randrange(1, ORDER))
    data = AttestationData(about=rng.randbytes(20), domain=rng.randbytes(20),
                           value=7, message=rng.randbytes(32))
    sig = kp.sign(int(data.to_scalar().hash()))
    att = SignedAttestationData(data, SignatureData(
        sig.r.to_bytes(32, "big"), sig.s.to_bytes(32, "big"), sig.rec_id))
    _, _, ok = ingest.recover_signers_batch([att], device="cpu")
    assert ok.tolist() == [True]
    spans = port.summary()
    assert spans["ingest.hash_batch"]["count"] == 1
    assert spans["ingest.recover_batch"]["count"] == 1
