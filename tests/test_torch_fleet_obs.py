"""The port's fleet and incident planes (``service/{slo,telemetry,
recorder,watchdog}.py``) held to the reference's
(``tests/test_fleet_obs.py``, ``tests/test_incident.py``) on the CPU,
and the operator verbs ``fleet``, ``slo`` and ``incident`` against a
live port leader with a follower and a ``prove-worker`` reporting into
it.

A computation both packages share (the SLO engine's burn rates, the
telemetry registry's rows and views, the flight recorder's ring) runs
in both on the same inputs and must give the same answer; a report or
an exposition page made by the port is read by the reference's
registry and lint."""

import json
import os
import re
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

import protocol_tpu_torch.service.metrics as port_metrics
import protocol_tpu_torch.service.recorder as port_recorder
import protocol_tpu_torch.service.slo as port_slo
import protocol_tpu_torch.service.telemetry as port_telemetry
import protocol_tpu_torch.service.watchdog as port_watchdog
from protocol_tpu_torch.cli.main import main as port_main
from protocol_tpu_torch.utils import trace as port_trace

pytest.importorskip("jax")
import protocol_tpu.service.metrics as ref_metrics  # noqa: E402
import protocol_tpu.service.recorder as ref_recorder  # noqa: E402
import protocol_tpu.service.slo as ref_slo  # noqa: E402
import protocol_tpu.service.telemetry as ref_telemetry  # noqa: E402
from protocol_tpu.utils import trace as ref_trace  # noqa: E402

PKGS = {
    "reference": SimpleNamespace(slo=ref_slo, telemetry=ref_telemetry,
                                 recorder=ref_recorder, trace=ref_trace,
                                 metrics=ref_metrics),
    "port": SimpleNamespace(slo=port_slo, telemetry=port_telemetry,
                            recorder=port_recorder, trace=port_trace,
                            metrics=port_metrics),
}
BOTH = tuple(PKGS.values())


@pytest.fixture(autouse=True)
def clean_tracers():
    was = [t.TRACER.enabled for t in (ref_trace, port_trace)]
    for t in (ref_trace, port_trace):
        t.TRACER.disable()
        t.TRACER.reset()
        t.TRACER.reset_instruments()
        t.enable()  # in memory: instruments record only when enabled
    yield
    for t, on in zip((ref_trace, port_trace), was):
        t.TRACER.disable()
        t.TRACER.reset()
        t.TRACER.reset_instruments()
        if on:
            t.TRACER.enable()


def _report(instance, role="follower", gauges=None, spans=None):
    return {"v": 1, "instance": instance, "role": role, "instruments": [],
            "gauges": dict(gauges or {}), "summary": {},
            "spans": list(spans or [])}


def _gauge_engine(slo, objective=0.9):
    return slo.SloEngine(
        specs=[slo.SloSpec("g", "gauge", objective, source="x",
                           threshold=1.0)],
        fast_window=60.0, slow_window=300.0)


# --- the SLO burn-rate engine ------------------------------------------------


def _burn_trajectory(pkg):
    """The reference test's trajectory: good history, a fast-only
    burst, a burn of both windows, a fast recovery, a full one."""
    eng = _gauge_engine(pkg.slo)
    out = []
    t = 1000.0
    for value, until in ((0.0, 1280.0), (5.0, 1300.0), (5.0, 1340.0),
                         (0.0, 1410.0), (0.0, 1700.0)):
        while t <= until:
            eng.sample(gauges={"x": value}, now=t)
            t += 10.0
        (r,) = eng.evaluate(now=until)
        out.append((r["burn"], r["alerting"], r["in_budget"],
                    r["alert_since"] is not None, eng.new_alerts()))
    return out


def test_burn_rate_gate_latch_and_release_equal_the_reference():
    got = _burn_trajectory(PKGS["port"])
    assert got == _burn_trajectory(PKGS["reference"])
    (b0, a0, _, _, _), (b1, a1, in1, _, _), (b2, a2, _, s2, new2), \
        (b3, a3, _, _, _), (b4, a4, in4, s4, _) = got
    assert b1["fast"] > 1.0 >= b1["slow"] and not a1 and not in1
    assert b2["fast"] > 1.0 and b2["slow"] > 1.0 and a2 and s2
    assert new2 == ["g"]  # newly latched: the capture trigger
    assert b3["fast"] <= 1.0 < b3["slow"] and a3  # latch holds
    assert not a4 and in4 and not s4


@pytest.mark.parametrize("pkg", BOTH, ids=list(PKGS))
def test_budget_edges(pkg):
    """Burn exactly 1.0 is in budget (the gate is strictly >); empty
    windows read burn 0 for every default SLO."""
    eng = _gauge_engine(pkg.slo, objective=0.75)
    eng.sample(gauges={"x": 0.0}, now=1000.0)
    eng.sample(gauges={"x": 5.0}, now=1010.0)
    for t in (1020.0, 1030.0, 1040.0):
        eng.sample(gauges={"x": 0.0}, now=t)
    (r,) = eng.evaluate(now=1040.0)
    assert r["burn"]["fast"] == pytest.approx(1.0)
    assert r["in_budget"] and not r["alerting"]
    eng = pkg.slo.SloEngine()
    eng.sample(gauges={}, now=1000.0)
    results = eng.evaluate(now=1000.0)
    assert [r["slo"] for r in results] == \
        [s.name for s in pkg.slo.default_slos()]
    assert all(r["burn"] == {"fast": 0.0, "slow": 0.0} and r["in_budget"]
               for r in results)
    (stall,) = [s for s in pkg.slo.default_slos()
                if s.name == "thread_stall"]
    assert (stall.kind, stall.source, stall.threshold) == \
        ("gauge", "thread_heartbeat_age_max_seconds", 30.0)


def _histogram_burns(pkg):
    hist = pkg.trace.histogram("lat_seconds")
    bounds = hist.buckets
    lat = pkg.slo.SloEngine(
        specs=[pkg.slo.SloSpec("lat", "latency", 0.9, source="lat_seconds",
                               threshold=bounds[len(bounds) // 2])],
        fast_window=60.0, slow_window=300.0)
    rq = pkg.trace.histogram("rq_seconds")
    err = pkg.slo.SloEngine(
        specs=[pkg.slo.SloSpec("err", "ratio", 0.9, source="rq_seconds",
                               bad_label=("status", "5"))],
        fast_window=60.0, slow_window=300.0)
    hist.observe(bounds[0] / 2)
    rq.observe(0.01, status="200")
    lat.sample(now=1000.0)
    err.sample(now=1000.0)
    for _ in range(8):
        hist.observe(bounds[0] / 2)
    for v in (bounds[-1] * 2, bounds[-1] * 2):
        hist.observe(v)
    for status in ["200"] * 7 + ["500", "503"]:
        rq.observe(0.01, status=status)
    lat.sample(now=1010.0)
    err.sample(now=1010.0)
    (rl,) = lat.evaluate(now=1010.0)
    (re_,) = err.evaluate(now=1010.0)
    alert = {tuple(sorted(i)): v
             for i, v in pkg.trace.gauge("slo_alert").samples()}
    return rl["burn"], rl["alerting"], re_["burn"], re_["alerting"], alert


def test_latency_and_ratio_slos_equal_the_reference():
    got = _histogram_burns(PKGS["port"])
    assert got == _histogram_burns(PKGS["reference"])
    lat, lat_alert, err, err_alert, alert = got
    assert lat == {"fast": pytest.approx(2.0), "slow": pytest.approx(2.0)}
    assert err["fast"] == pytest.approx(2.0 / 0.9, rel=1e-6)
    assert lat_alert and err_alert
    assert alert[(("slo", "lat"),)] == 1.0


# --- the telemetry registry --------------------------------------------------


def _registry_views(pkg):
    tel = pkg.telemetry
    reg = tel.TelemetryRegistry(ttl=30.0)
    reg.report(_report("f-cold", gauges={"score_freshness_seconds": -1.0,
                                         "repl_lag_seconds": -1.0}))
    reg.report(_report("f-warm", gauges={"score_freshness_seconds": 5.0,
                                         "repl_lag_seconds": 0.5}))
    reg.report(_report("f-dead"))
    reg._instances["f-dead"]["seen"] -= 45.0
    view = tel.fleet_gauge_view(reg, local={"score_freshness_seconds": -1.0})
    rows = tel.fleet_rows(reg, {"instance": "ldr", "role": "leader"})
    strip = [{k: v for k, v in r.items() if k != "report_age_seconds"}
             for r in rows["instances"]]
    bad = 0
    for obj in ([], {"role": "follower"}, {"instance": ""},
                {"instance": "x"},
                {"instance": "x", "role": "f", "gauges": []}):
        try:
            reg.report(obj)
        except Exception as e:  # each package raises its own EigenError
            bad += getattr(e, "kind", None) == "validation_error"
    big = tel.TelemetryRegistry(ttl=1e9)
    for i in range(tel.MAX_INSTANCES):
        big.report(_report(f"i{i}"))
    big._instances["i0"]["seen"] -= 100.0
    big.report(_report("overflow"))
    return (view, strip, rows["counts"], bad,
            sorted(big._instances) == sorted(
                [f"i{i}" for i in range(1, tel.MAX_INSTANCES)]
                + ["overflow"]),
            "f-dead" in tel.render_fleet_metrics(reg, "ldr", "leader"))


def test_registry_views_equal_the_reference():
    """The -1 sentinel is no data (never a sample), a dead row stays
    listed but inactive, malformed reports are refused, capacity evicts
    the oldest report first: the same views in both packages."""
    got = _registry_views(PKGS["port"])
    assert got == _registry_views(PKGS["reference"])
    view, rows, counts, bad, evicted_oldest, dead_listed = got
    assert view["score_freshness_seconds"] == 5.0
    assert view["repl_lag_seconds"] == 0.5
    by = {r["instance"]: r for r in rows}
    assert by["f-cold"]["score_freshness_seconds"] is None
    assert not by["f-dead"]["active"] and by["f-warm"]["active"]
    assert counts == {"total": 4, "active": 3,
                      "by_role": {"leader": 1, "follower": 3}}
    assert bad == 5 and evicted_oldest and dead_listed


def test_pusher_file_drop_read_by_both_registries(tmp_path):
    """The port's pusher drops a report the port's and the reference's
    registries both ingest (the wire format); spans carry instance and
    role; a failed push keeps the span window (at-least-once)."""
    port_telemetry.set_build_info("w1", "prove-worker")
    with port_trace.context(trace_id="job-1"):
        with port_trace.span("fabric.unit", unit="u0", remote=1):
            pass
    drop = tmp_path / "telemetry"
    pusher = port_telemetry.TelemetryPusher(str(drop), "w1", "prove-worker",
                                            interval=0.1)
    assert pusher.push_once()
    raw = (drop / "w1.json").read_bytes()
    report = json.loads(raw)
    (unit,) = [s for s in report["spans"] if s.get("name") == "fabric.unit"]
    assert (unit["instance"], unit["role"], unit["remote"]) == \
        ("w1", "prove-worker", 1)
    assert "job-1" in [unit.get("trace_id"), *(unit.get("trace_ids") or ())]
    assert pusher.push_once()
    assert json.loads((drop / "w1.json").read_bytes())["spans"] == []
    for tel in (ref_telemetry, port_telemetry):
        inbox = tmp_path / tel.__name__
        inbox.mkdir()
        (inbox / "w1.json").write_bytes(raw)
        reg = tel.TelemetryRegistry(ttl=30.0)
        assert reg.sweep_dir(str(inbox)) == 1
        assert list(inbox.iterdir()) == []
        (row,) = reg.rows()
        assert row["instance"] == "w1" and row["role"] == "prove-worker"
    with port_trace.span("fabric.unit", unit="u1", remote=1):
        pass
    broken = port_telemetry.TelemetryPusher(
        "http://127.0.0.1:9/", "w1", "prove-worker", timeout=0.2)
    broken._span_cursor = pusher._span_cursor
    assert not broken.push_once() and broken.failures == 1
    assert port_trace.counter_total("telemetry_push_failures") >= 1.0
    assert any(s.get("unit") == "u1" for s in broken.build()["spans"])


def test_fleet_exposition_lints_in_both_packages(tmp_path):
    """The port's federated page passes both packages' exposition lint,
    every series instance-labelled, one TYPE a family, the fleet and SLO
    meta-series present; a port report with ``build_info`` labels
    stamps every JSONL record of its instance."""
    port_telemetry.set_build_info("ldr1", "leader")
    port_trace.counter("service.refresh").inc()
    port_trace.histogram("refresh_seconds").observe(0.05, mode="warm")
    snap, _ = port_telemetry.snapshot("f1", "follower",
                                      extra={"repl_lag_seconds": 0.4})
    snap["instruments"] = [i for i in snap["instruments"]
                           if i["name"] != "build_info"]
    reg = port_telemetry.TelemetryRegistry(ttl=30.0)
    reg.report(snap)
    port_telemetry.update_fleet_gauges(reg)
    eng = port_slo.SloEngine()
    eng.sample(gauges=port_telemetry.fleet_gauge_view(reg), now=1000.0)
    eng.evaluate(now=1000.0)
    text = port_telemetry.render_fleet_metrics(
        reg, "ldr1", "leader", extra={"score_freshness_seconds": 2.0})
    assert port_metrics.lint_exposition(text) == []
    assert ref_metrics.lint_exposition(text) == []
    assert {"ldr1", "f1"} <= set(re.findall(r'instance="([^"]+)"', text))
    for family in ("ptpu_fleet_instances", "ptpu_fleet_instance_up",
                   "ptpu_fleet_report_age_seconds", "ptpu_slo_burn_rate",
                   "ptpu_slo_in_budget", "ptpu_slo_alert"):
        assert f"# TYPE {family} gauge" in text, family
    types = re.findall(r"# TYPE (\S+)", text)
    assert len(types) == len(set(types))
    stream = tmp_path / "t.jsonl"
    port_trace.enable(str(stream))
    port_telemetry.set_build_info("inst-7", "follower")
    with port_trace.span("poll.once"):
        pass
    port_trace.TRACER.disable()
    rec = json.loads(stream.read_text().splitlines()[-1])
    assert (rec["instance"], rec["role"]) == ("inst-7", "follower")
    assert ref_trace.validate_record(rec) is None


def test_obs_merges_streams_across_instances(tmp_path, capsys):
    leader, worker = tmp_path / "leader.jsonl", tmp_path / "worker.jsonl"
    leader.write_text(json.dumps({
        "type": "span", "name": "prove.shard", "ts": 1000.0,
        "duration_s": 0.5, "depth": 0, "span_id": "00000001",
        "trace_ids": ["jobx"], "instance": "ldr1", "role": "leader",
        "worker": "fw1", "remote": 1}) + "\n")
    worker.write_text(json.dumps({
        "type": "span", "name": "fabric.unit", "ts": 1000.1,
        "duration_s": 0.4, "depth": 0, "span_id": "00000002",
        "trace_ids": ["jobx"], "instance": "fw1",
        "role": "prove-worker"}) + "\n")
    assert port_main(["obs", str(leader), "--jsonl", str(worker),
                      "--trace-id", "jobx"]) == 0
    out = capsys.readouterr().out
    assert "2 span(s)" in out and "0 invalid" in out
    insts = set(re.findall(r"instance=(\S+)", out))
    assert {"ldr1", "fw1"} <= insts and "remote=1" in out


# --- the incident plane --------------------------------------------------------


def _ring(pkg):
    rec = pkg.recorder.FlightRecorder(cap=8)
    for i in range(20):
        rec.note("tick", i=i)
    frozen = rec.freeze()
    rec.note("tick", i=99)
    return len(rec), [(e["kind"], e["i"], e["seq"]) for e in frozen]


def test_flight_recorder_ring_equals_the_reference():
    got = _ring(PKGS["port"])
    assert got == _ring(PKGS["reference"])
    assert got[0] == 8 and [i for _, i, _ in got[1]] == list(range(12, 20))


def test_incident_store_capture_limits_and_autopsy(tmp_path):
    """Capture → bundle → autopsy text; rate limit (counted, ring-noted)
    unless forced; retention evicts the oldest; traversal ids refused.
    The port's bundle renders through the reference's autopsy to the
    same text."""
    rec = port_recorder.FlightRecorder(cap=32)
    rec.note("slo_latched", slo="error_rate")
    store = port_recorder.IncidentStore(str(tmp_path / "a"), rec,
                                        retention=2, min_interval=3600.0)
    context = {"slo": {"alerts": ["error_rate"], "slos": [
        {"slo": "error_rate", "objective": 0.999,
         "burn": {"fast": 9.0, "slow": 2.0}, "alerting": True}]},
        "metrics.txt": "ptpu_service_up 1.0\n", "config": {"port": 0}}
    first = store.capture("slo", "SLO error_rate latched", context=context)
    assert first.startswith("inc-") and store.list_ids() == [first]
    assert store.capture("slo", "two") is None
    assert port_trace.counter_total("incidents_rate_limited",
                                    trigger="slo") == 1.0
    assert any(e["kind"] == "capture_rate_limited" for e in rec.freeze())
    bundle = store.load(first)
    assert bundle["meta"]["reason"] == "SLO error_rate latched"
    assert "slo_latched" in [e["kind"] for e in bundle["ring"]]
    assert threading.current_thread().name in bundle["threads"]
    text = port_recorder.render_autopsy(bundle)
    assert text == ref_recorder.render_autopsy(bundle)
    assert first in text and "burn fast=9.00" in text and "threads" in text
    ids = [store.capture("operator", f"r{i}", force=True) for i in range(2)]
    assert store.list_ids() == ids  # retention 2: the first evicted
    assert port_trace.counter_total("incidents_evicted") >= 1.0
    for bad in ("../outside", "a/b", "inc-missing"):
        assert store.load(bad) is None


def test_watchdog_fires_recovers_and_exports(tmp_path):
    rec = port_recorder.FlightRecorder()
    store = port_recorder.IncidentStore(str(tmp_path), rec,
                                        min_interval=0.0)
    beats = port_watchdog.Heartbeats()
    dog = port_watchdog.StallWatchdog(beats, recorder=rec, store=store,
                                      stall_after=30.0)
    beats.register("ptpu-loop")
    now = time.monotonic()
    assert dog.check(now=now) == [] and dog.stalled() == []
    assert dog.check(now=now + 100.0) == ["ptpu-loop"]
    assert dog.check(now=now + 101.0) == []  # latched, no re-fire
    assert port_trace.counter_total("thread_stalls",
                                    thread="ptpu-loop") == 1.0
    (note,) = [e for e in rec.freeze() if e["kind"] == "thread_stalled"]
    assert "test_watchdog_fires_recovers_and_exports" in note["stack"]
    (inc,) = store.index()
    assert inc["trigger"] == "watchdog"
    text = port_metrics.render_prometheus()
    assert 'ptpu_thread_stalled{thread="ptpu-loop"} 1' in text
    assert 'ptpu_thread_heartbeat_age_seconds{thread="ptpu-loop"}' in text
    beats.beat("ptpu-loop")
    assert dog.check(now=time.monotonic()) == [] and dog.stalled() == []
    assert any(e["kind"] == "thread_recovered" for e in rec.freeze())
    beats.unregister("ptpu-loop")  # retired, never an eternal stall
    assert dog.check(now=time.monotonic() + 1000.0) == []
    assert beats.max_age() is None


def test_trace_stream_rotation_and_obs_reads_sibling(tmp_path,
                                                     monkeypatch, capsys):
    stream = tmp_path / "trace.jsonl"
    monkeypatch.setenv("PTPU_TRACE_MAX_BYTES", "4096")
    port_trace.TRACER.disable()
    port_trace.enable(str(stream))
    sib = tmp_path / "trace.jsonl.1"
    total = 0
    while not sib.exists():  # one rotation, then five records more
        port_trace.event("rotation.fill", i=total, pad="x" * 40)
        total += 1
        assert total < 500, "stream never rotated"
    for _ in range(5):
        port_trace.event("rotation.fill", i=total, pad="x" * 40)
        total += 1
    port_trace.TRACER.disable()
    n_live = sum(1 for ln in open(stream) if ln.strip())
    n_rot = sum(1 for ln in open(sib) if ln.strip())
    assert n_live + n_rot == total and n_live > 0 and n_rot > 0
    assert port_main(["obs", str(stream)]) == 0
    out = capsys.readouterr().out
    assert f"{total} event(s)" in out and "0 invalid" in out


def test_every_port_service_thread_is_named():
    """Every ``threading.Thread(`` of the port passes ``name=``: the
    watchdog, the autopsy's stacks and py-spy key on it."""
    root = os.path.join(os.path.dirname(__file__), os.pardir,
                        "protocol_tpu_torch")
    offenders = []
    for dirpath, _, files in os.walk(root):
        for fname in files:
            if fname.endswith(".py"):
                path = os.path.join(dirpath, fname)
                src = open(path).read()
                for m in re.finditer(r"threading\.Thread\(", src):
                    if "name=" not in src[m.start():m.start() + 400]:
                        offenders.append(
                            f"{path}:{src[:m.start()].count(chr(10)) + 1}")
    assert not offenders, offenders


# --- the operator verbs against a live fleet ----------------------------------


def _http(url, data=None):
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.status, json.loads(resp.read())


def _wait(pred, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.05)


def test_operator_verbs_against_a_live_port_fleet(tmp_path, monkeypatch,
                                                  capsys):
    """A port leader (state dir, ``shard_proves``, ``fabric``), a port
    follower and a ``prove-worker`` (the CLI verb, in a thread, file-drop
    telemetry): ``fleet`` lists all three roles up, ``slo --json``
    parses on the follower, ``incident`` lists the leader's index and
    renders the operator capture's autopsy; ``/status`` shows the
    fabric and ``/metrics`` its gauges; the ``debug_faults`` gate opens
    ``POST /debug/fail``."""
    from protocol_tpu_torch.client import Client, ClientConfig
    from protocol_tpu_torch.service import (
        FaultInjector,
        FollowerService,
        ServiceConfig,
        TrustService,
    )

    monkeypatch.setenv("PTPU_SERVE_TELEMETRY_INTERVAL", "0.1")
    knobs = dict(port=0, poll_interval=0.05, refresh_interval=0.05,
                 telemetry_interval=0.1, slo_interval=0.1,
                 incident_min_interval=0.0, drain_timeout=10.0)
    faults = {"rpc": 0.0, "device": 0.0, "disk": 0.0}
    state = tmp_path / "leader-state"
    leader = TrustService(
        Client(ClientConfig(), "test " * 11 + "junk", device="cpu"),
        ServiceConfig(shard_proves=1, fabric=1, debug_faults=1, **knobs),
        str(tmp_path / "cursor"), provers={"echo": lambda p: {"echo": p}},
        faults=FaultInjector(faults), state_dir=str(state))
    assert leader.fabric is not None
    assert leader.jobs.shard_kinds == frozenset({"echo"})
    url = leader.start()
    follower = None
    try:
        follower = FollowerService(url, b"\x00" * 20, ServiceConfig(**knobs),
                                   str(tmp_path / "fstate"),
                                   faults=FaultInjector(faults),
                                   device="cpu")
        furl = follower.start()
        rcs = []
        worker = threading.Thread(target=lambda: rcs.append(port_main([
            "--assets", str(tmp_path / "assets"), "prove-worker",
            "--state-dir", str(state), "--name", "fw-t", "--poll", "0.02",
            "--idle-exit", "1.0"])), name="prove-worker-test")
        worker.start()
        _wait(lambda: _http(url + "/status")[1]["pool"]["fabric"]
              ["workers_live"] >= 1, what="the worker's registration")
        metrics = urllib.request.urlopen(url + "/metrics",
                                         timeout=10).read().decode()
        assert "ptpu_fabric_workers 1" in metrics
        worker.join(timeout=30)
        assert rcs == [0]
        _wait(lambda: {r["role"] for r in _http(url + "/fleet")[1][
            "instances"]} >= {"leader", "follower", "prove-worker"},
            what="all three roles on /fleet")
        capsys.readouterr()
        assert port_main(["fleet", "--url", url]) == 0
        table = capsys.readouterr().out
        rows = {ln.split()[1]: ln.split()[2] for ln in
                table.splitlines()[2:]}
        assert rows["leader"] == rows["follower"] == "up"
        assert rows["prove-worker"] in ("up", "DEAD")
        assert "fw-t" in table and follower.instance in table
        assert port_main(["slo", "--url", furl, "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["slos"]
        with pytest.raises(urllib.error.HTTPError) as err:
            _http(url + "/debug/fail", data=b"{}")
        assert err.value.code == 500
        status, body = _http(url + "/incidents/capture", data=b"{}")
        assert status == 201
        assert port_main(["incident", "--url", url]) == 0
        assert body["id"] in capsys.readouterr().out
        assert port_main(["incident", "--url", url, "--id", body["id"]]) == 0
        assert capsys.readouterr().out.startswith(f"incident {body['id']}\n")
        # "latest" is the newest capture: the operator's, or one the
        # error-rate SLO latched by /debug/fail made the watchdog take
        # after it
        assert port_main(["incident", "--url", url, "--id", "latest"]) == 0
        latest = capsys.readouterr().out.split("\n", 1)[0].split()[1]
        ids = [i["id"] for i in _http(url + "/incidents")[1]["incidents"]]
        assert latest in ids and latest >= body["id"]
        assert port_main(["fleet", "--url", "http://127.0.0.1:9"]) == 1
        assert "cannot fetch /fleet" in capsys.readouterr().err
    finally:
        if follower is not None:
            assert follower.shutdown() is True
        assert leader.shutdown() is True
