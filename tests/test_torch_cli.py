"""The port's CLI verbs against the reference CLI, on the CPU.

Both CLIs run the same verbs in assets directories of their own, with
the same mnemonics: the chain file, ``attestations.csv`` and
``scores.csv`` must come out byte-identical, and the port's copy of the
demo assets must reproduce the committed ``scores.csv`` through the
batched ingest (``--device cpu``: the plain versions of the field
kernels). Twins of ``tests/test_cli.py``.
"""

import csv
import json
import os
import shutil
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from protocol_tpu.cli.main import main as ref_main
from protocol_tpu_torch.cli import build_parser
from protocol_tpu_torch.cli.main import main as port_main

ROOT = Path(__file__).resolve().parents[1]
PORT_ASSETS = ROOT / "protocol_tpu_torch" / "cli" / "assets"
REF_ASSETS = ROOT / "protocol_tpu" / "cli" / "assets"
M2 = "legal winner thank year wave sausage worth useful legal winner thank yellow"
# the reference's float backends and their port twins
PORT_NAMES = {"jax": "torch", "jax-sparse": "torch-sparse"}


def both(tmp_path, *argv, device=None):
    """Run one verb in each CLI, each in its own assets directory;
    returns the two exit codes (reference, port)."""
    rc_ref = ref_main(["--assets", str(tmp_path / "ref"), *argv])
    port_argv = [PORT_NAMES.get(a, a) for a in argv]
    if device:
        port_argv += ["--device", device]
    rc_port = port_main(["--assets", str(tmp_path / "port"), *port_argv])
    return rc_ref, rc_port


def same_file(tmp_path, name):
    got = (tmp_path / "port" / name).read_bytes()
    assert got == (tmp_path / "ref" / name).read_bytes(), name
    return got


def test_parser_accepts_the_ported_verbs_and_no_other():
    parser = build_parser()
    for verb, extra in [
        ("attest", ["--to", "0x" + "11" * 20, "--score", "5"]),
        ("attestations", []),
        ("bandada", ["--action", "add", "--identity-commitment", "1",
                     "--address", "0xaa"]),
        ("deploy", []),
        ("local-scores", ["--backend", "torch", "--batched-ingest",
                          "--device", "cpu"]),
        ("scores", ["--backend", "torch-sparse"]),
        ("scenario", ["run", "--topology", "slander", "--peers", "100",
                      "--semiring", "maxplus", "--engine", "routed",
                      "--device", "cpu", "--timing", "--out", "s.json"]),
        ("scenario", ["report", "--json", "s.json"]),
        ("show", []),
        ("sparse-scores", ["--edges", "e.csv", "--n", "10"]),
        ("profile", ["--workload", "refresh"]),
        ("update", ["--chain-id", "1", "--node-url", "memory"]),
        ("serve", ["--port", "0", "--state-dir", "st", "--device", "cpu"]),
        ("serve", ["--follow", "http://127.0.0.1:1", "--device", "cpu"]),
        ("serve", ["--shard-proves", "1", "--fabric", "1",
                   "--fabric-lease-ttl", "2", "--device", "cpu"]),
        ("prove-worker", ["--state-dir", "st", "--name", "fw0", "--poll",
                          "0.02", "--lease-ttl", "5", "--max-units", "3",
                          "--idle-exit", "1"]),
        ("prove-worker", ["--url", "http://127.0.0.1:1"]),
        ("fleet", ["--url", "http://127.0.0.1:1", "--json"]),
        ("slo", ["--url", "http://127.0.0.1:1"]),
        ("incident", ["--url", "http://127.0.0.1:1", "--id", "latest"]),
        ("store", ["inspect", "--state-dir", "st"]),
        ("store", ["compact"]),
        ("obs", ["trace.jsonl", "--trace-id", "abc"]),
        ("kzg-params", ["--k", "10"]),
        ("et-proving-key", ["--shape", "tiny"]),
        ("et-proof", ["--shape", "tiny", "--transcript", "keccak",
                      "--device", "cpu"]),
        ("et-verify", ["--shape", "tiny", "--transcript", "auto"]),
        ("et-verifier", ["--shape", "tiny", "--transcript", "keccak",
                         "--check"]),
        ("et-verifier", ["--rpc", "http://127.0.0.1:1"]),
        ("th-proving-key", ["--device", "cpu"]),
        ("th-proof", ["--peer", "0x" + "11" * 20, "--threshold", "500",
                      "--device", "cpu"]),
        ("th-verify", []),
    ]:
        assert parser.parse_args([verb, *extra]).command == verb
    for verb in ("fleet", "slo", "incident"):  # --url is required
        with pytest.raises(SystemExit):
            parser.parse_args([verb])
    with pytest.raises(SystemExit):  # the reference's backend names
        parser.parse_args(["scores", "--backend", "jax"])


def test_show_and_update_roundtrip(tmp_path, capsys):
    outs = []
    for main, d in ((ref_main, "ref"), (port_main, "port")):
        a = ["--assets", str(tmp_path / d)]
        assert main([*a, "show"]) == 0
        before = capsys.readouterr().out
        assert main([*a, "update", "--domain", "0x" + "ab" * 20,
                     "--chain-id", "5"]) == 0
        updated = capsys.readouterr().out
        assert main([*a, "show"]) == 0
        after = capsys.readouterr().out
        assert main([*a, "update"]) == 1
        err = capsys.readouterr().err
        outs.append((before, updated, after, err))
    assert outs[0] == outs[1]
    assert json.loads(outs[1][0])["node_url"] == "memory"
    config = json.loads(outs[1][2])
    assert config["domain"] == "0x" + "ab" * 20 and config["chain_id"] == 5
    assert "no config fields" in outs[1][3]
    same_file(tmp_path, "config.json")


def test_deploy_sets_local_address(tmp_path, capsys):
    assert both(tmp_path, "deploy") == (0, 0)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] and "0x" in out[0]
    config = json.loads(same_file(tmp_path, "config.json"))
    assert config["as_address"] != "0x" + "00" * 20


def test_attest_scores_flow(tmp_path, capsys, monkeypatch):
    """attest (2 peers) → attestations → local-scores / scores with every
    backend, in both CLIs: the same chain, attestations and scores
    files, byte for byte."""
    from protocol_tpu_torch.cli.fs import INSECURE_MNEMONIC
    from protocol_tpu_torch.client.eth import ecdsa_keypairs_from_mnemonic

    addr1 = ecdsa_keypairs_from_mnemonic(INSECURE_MNEMONIC, 1)[0] \
        .public_key.to_address_bytes()
    addr2 = ecdsa_keypairs_from_mnemonic(M2, 1)[0] \
        .public_key.to_address_bytes()

    monkeypatch.delenv("MNEMONIC", raising=False)
    assert both(tmp_path, "attest", "--to", "0x" + addr2.hex(),
                "--score", "10") == (0, 0)
    monkeypatch.setenv("MNEMONIC", M2)
    assert both(tmp_path, "attest", "--to", "0x" + addr1.hex(),
                "--score", "10") == (0, 0)
    monkeypatch.delenv("MNEMONIC")
    same_file(tmp_path, "chain.json")
    assert both(tmp_path, "attestations") == (0, 0)
    same_file(tmp_path, "attestations.csv")

    capsys.readouterr()
    assert both(tmp_path, "local-scores") == (0, 0)
    out = capsys.readouterr().out
    assert "1000.000000" in out
    first = same_file(tmp_path, "scores.csv")
    # the float backends agree with the exact path inside the verb, and
    # the exact scores are the file's, whatever the backend
    assert both(tmp_path, "local-scores", "--backend", "jax",
                device="cpu") == (0, 0)
    assert same_file(tmp_path, "scores.csv") == first
    (tmp_path / "port" / "attestations.csv").unlink()
    assert both(tmp_path, "scores", "--backend", "jax-sparse",
                device="cpu") == (0, 0)
    assert same_file(tmp_path, "scores.csv") == first
    same_file(tmp_path, "attestations.csv")
    out = capsys.readouterr().out.splitlines()
    half = len(out) // 2
    assert out[:half] == out[half:]


def test_local_scores_without_attestations_fails(tmp_path, capsys):
    assert both(tmp_path, "local-scores") == (1, 1)
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2 and "error" in err[1]
    assert err[0].replace(str(tmp_path / "ref"), "") == \
        err[1].replace(str(tmp_path / "port"), "")


def test_batched_ingest_flag_parses(tmp_path, capsys, monkeypatch):
    """--batched-ingest on local-scores parses; with no attestations the
    verb still fails cleanly like the plain path, in both CLIs. With
    attestations the flag hands them, and ``--device``, to the batched
    recovery (whose results ``test_torch_client.py`` holds against the
    scalar path's)."""
    assert both(tmp_path, "local-scores", "--batched-ingest",
                device="cpu") == (1, 1)
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2 and all("No such file" in e for e in err)

    from protocol_tpu_torch.client import ingest

    calls = []

    class Called(Exception):
        pass

    def spy(attestations, full_verify=False, device=None):
        calls.append((len(attestations), full_verify, device))
        raise Called

    monkeypatch.setattr(ingest, "recover_signers_batch", spy)
    shutil.copytree(PORT_ASSETS, tmp_path / "demo")
    with pytest.raises(Called):
        port_main(["--assets", str(tmp_path / "demo"), "local-scores",
                   "--batched-ingest", "--device", "cpu"])
    assert calls == [(6, False, torch.device("cpu"))]
    assert port_main(["--assets", str(tmp_path / "demo"),
                      "local-scores"]) == 0  # the flag's default: scalar
    assert len(calls) == 1


def test_bundled_demo_assets_score_out_of_box(tmp_path):
    """The port's copy of the demo assets (byte-identical to the
    reference's) runs through ``local-scores``, exact and with a torch
    backend, and reproduces the committed scores.csv byte for byte."""
    for f in ("attestations.csv", "config.json", "scores.csv"):
        assert (PORT_ASSETS / f).read_bytes() == (REF_ASSETS / f).read_bytes()
    assets = tmp_path / "assets"
    shutil.copytree(PORT_ASSETS, assets)
    for extra in ([], ["--backend", "torch-sparse", "--device", "cpu"]):
        (assets / "scores.csv").unlink()
        assert port_main(["--assets", str(assets), "local-scores",
                          *extra]) == 0
        assert (assets / "scores.csv").read_bytes() == \
            (PORT_ASSETS / "scores.csv").read_bytes()
    with open(assets / "scores.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 3 and sum(int(r["score"]) for r in rows) == 2999


def test_bandada_threshold_gate(tmp_path, capsys, monkeypatch):
    for d in ("ref", "port"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "scores.csv").write_text(
            "peer_address,score_fr,numerator,denominator,score\n"
            "0xaabbccddeeff00112233445566778899aabbccdd,0x01,300,1,300\n")
    monkeypatch.setenv("BANDADA_API_KEY", "dummy")
    args = ("bandada", "--action", "add", "--identity-commitment", "123",
            "--address", "0xaabbccddeeff00112233445566778899aabbccdd")
    assert both(tmp_path, *args) == (1, 1)
    err = capsys.readouterr().err.splitlines()
    assert err[0] == err[1] and "below band threshold" in err[0]
    assert both(tmp_path, "bandada", "--action", "add",
                "--identity-commitment", "1", "--address",
                "0x" + "11" * 20) == (1, 1)
    err = capsys.readouterr().err.splitlines()
    assert err[0] == err[1] and "no score for" in err[0]


def test_verbs_that_need_the_card_fail_without_one(tmp_path, capsys):
    """No fallback: with no GPU and no ``--device`` a torch backend, the
    batched ingest and a scenario run exit 1 with an error that names
    the device, and write nothing."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    assets = tmp_path / "assets"
    shutil.copytree(PORT_ASSETS, assets)
    (assets / "scores.csv").unlink()
    for argv in (["scores", "--backend", "torch-sparse"],
                 ["local-scores", "--backend", "torch"],
                 ["local-scores", "--batched-ingest"],
                 ["scenario", "run", "--peers", "100"]):
        assert port_main(["--assets", str(assets), *argv]) == 1
        err = capsys.readouterr().err
        assert "no CUDA device" in err and "--device cpu" in err, argv
    assert not (assets / "scores.csv").exists()
    assert (assets / "attestations.csv").read_bytes() == \
        (PORT_ASSETS / "attestations.csv").read_bytes()


def _two_peer_chain(assets, monkeypatch):
    """Two peers attest each other in the port's file-persisted local
    chain; returns their addresses."""
    from protocol_tpu_torch.cli.fs import INSECURE_MNEMONIC
    from protocol_tpu_torch.client.eth import ecdsa_keypairs_from_mnemonic

    addrs = [ecdsa_keypairs_from_mnemonic(m, 1)[0]
             .public_key.to_address_bytes() for m in (INSECURE_MNEMONIC, M2)]
    monkeypatch.delenv("MNEMONIC", raising=False)
    a = ["--assets", str(assets)]
    assert port_main([*a, "attest", "--to", "0x" + addrs[1].hex(),
                      "--score", "10"]) == 0
    monkeypatch.setenv("MNEMONIC", M2)
    assert port_main([*a, "attest", "--to", "0x" + addrs[0].hex(),
                      "--score", "4"]) == 0
    monkeypatch.delenv("MNEMONIC")
    return addrs


def test_serve_on_the_cpu_scores_and_drains_on_sigterm(tmp_path,
                                                       monkeypatch):
    """``serve --device cpu`` as its own process: it tails the local
    chain the ``attest`` verb wrote, serves each peer's score within the
    reference's smoke bound of the exact ``scores`` oracle, and a
    SIGTERM drains it to exit code 0."""
    assets = tmp_path / "assets"
    addrs = _two_peer_chain(assets, monkeypatch)
    assert port_main(["--assets", str(assets), "scores"]) == 0
    with open(assets / "scores.csv") as f:
        oracle = {bytes.fromhex(r["peer_address"].removeprefix("0x")):
                  int(r["numerator"]) / int(r["denominator"])
                  for r in csv.DictReader(f)}
    env = dict(os.environ, PTPU_SERVE_REFRESH_INTERVAL="0.05",
               PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "protocol_tpu_torch.cli", "--assets",
         str(assets), "serve", "--port", "0", "--device", "cpu",
         "--poll-interval", "0.05"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=tmp_path)
    try:
        line = proc.stdout.readline()
        assert "listening on http://" in line, proc.stderr.read()
        url = line.split("listening on ")[1].split()[0]
        deadline = time.monotonic() + 30
        got = {}
        while time.monotonic() < deadline and len(got) < 2:
            try:
                for a in addrs:
                    with urllib.request.urlopen(
                            f"{url}/score/0x{a.hex()}", timeout=5) as r:
                        got[a] = json.loads(r.read())["score"]
            except OSError:
                time.sleep(0.05)
        assert set(got) == set(oracle) == set(addrs)
        for a, ref in oracle.items():
            assert abs(got[a] - ref) <= 1e-3 * max(abs(ref), 1.0)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
        assert proc.returncode == 0, err
        assert "service drained" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert (assets / "service-state" / "wal").is_dir()


def _signed_wal_records(n):
    """Signed attestations under the zero domain as WAL records: three
    signers, each revising the same two edges, so compaction folds."""
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
        att = AttestationData(about=bytes([i % 2 + 1]) * 20,
                              domain=b"\x00" * 20, value=i + 1)
        sig = kps[i % 3].sign(int(att.to_scalar().hash()))
        signed = SignedAttestationData(att, SignatureData.from_signature(sig))
        out.append((i + 1, att.about, signed.to_payload()))
    return out


def test_store_inspect_and_compact_match_the_reference(tmp_path, capsys):
    """``store inspect`` prints the reference verb's report on the same
    state dir, and ``store compact`` folds a copy of it to the same
    report and the same WAL bytes."""
    from protocol_tpu_torch.store import StateStore, encode_service_state

    for d in ("ref", "port"):
        shutil.copytree(PORT_ASSETS, tmp_path / d)
    state = tmp_path / "ref" / "service-state"
    store = StateStore(str(state), segment_bytes=300)
    for rec in _signed_wal_records(9):
        store.wal.append([rec])

    class Table:
        scores, revision, iterations = [1.0, 2.0], 3, 4
        delta, cold, computed_at = 0.0, True, 5.0

    arrays, meta = encode_service_state(
        [b"\x01" * 20, b"\x02" * 20], [0], [1], [5.0], 3, 0, 0, Table(),
        store.wal.position(), n_attestations=9)
    store.snapshots.save(3, arrays, meta)
    store.close()
    shutil.copytree(state, tmp_path / "port" / "service-state")

    capsys.readouterr()
    outs = {}
    for action in ("inspect", "compact", "inspect"):
        assert both(tmp_path, "store", action) == (0, 0)
        out = capsys.readouterr().out.replace(str(tmp_path / "ref"), "A") \
            .replace(str(tmp_path / "port"), "A").splitlines()
        half = len(out) // 2
        assert out[:half] == out[half:], action
        outs.setdefault(action, out[:half])
    assert "9 intact record(s)" in outs["inspect"][1]
    # six (signer, about) keys among nine records
    assert outs["compact"][0].startswith("compacted: 9 record(s) -> 6")
    wal = {d: {f.name: f.read_bytes() for f in
               sorted((tmp_path / d / "service-state" / "wal").iterdir())}
           for d in ("ref", "port")}
    assert wal["ref"] == wal["port"] and len(wal["ref"]) == 1


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_obs_reads_a_trace_written_by_either_package(tmp_path, capsys,
                                                      writer):
    """``obs`` validates and summarises a JSONL trace stream written by
    either package's tracer, with the reference verb's counts and
    trace-id chain."""
    if writer == "reference":
        from protocol_tpu.utils import trace
    else:
        from protocol_tpu_torch.utils import trace
    path = tmp_path / "trace.jsonl"
    trace.enable(str(path))
    try:
        with trace.context(trace_id="t-1"):
            with trace.span("service.refresh", n=3):
                trace.event("service.restored", replayed=2)
        trace.metric("service.refresh_total", 1)
    finally:
        trace.disable()
        trace.TRACER.reset()
    outs = []
    for main in (ref_main, port_main):
        assert main(["--assets", str(tmp_path), "obs", str(path),
                     "--trace-id", "t-1"]) == 0
        out = capsys.readouterr().out.splitlines()
        # the counts line, then the table and chain without their times
        outs.append((out[0], [ln.split()[:2] for ln in out[1:] if ln]))
    assert outs[0] == outs[1]
    assert "1 span(s), 1 event(s), 1 metric(s), 0 invalid" in outs[1][0]


def test_serve_without_a_card_exits_before_it_binds(tmp_path, capsys,
                                                     monkeypatch):
    """With no GPU and no ``--device``, ``serve`` exits 1 naming
    ``--device cpu`` before it binds a port or writes to the state
    dir."""
    import socket

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assets = tmp_path / "assets"
    shutil.copytree(PORT_ASSETS, assets)
    before = sorted(p.name for p in assets.iterdir())
    bound = []
    monkeypatch.setattr(socket.socket, "bind",
                        lambda self, addr: bound.append(addr))
    assert port_main(["--assets", str(assets), "serve", "--port", "0"]) == 1
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--device cpu" in err
    assert bound == []
    assert sorted(p.name for p in assets.iterdir()) == before


def test_profile_daemon_workload_captures_on_a_live_daemon(tmp_path,
                                                           capsys):
    """``profile --workload daemon --url`` submits a ``profile`` job to
    a live daemon and reports the job's result (the capture window
    itself is ``test_torch_service``'s; a stand-in answers here)."""
    from protocol_tpu_torch.client import Client, ClientConfig
    from protocol_tpu_torch.service import ServiceConfig, TrustService

    def capture(params):
        return {"log_dir": str(tmp_path / "profiles" / "x"),
                "seconds": params["seconds"]}

    svc = TrustService(
        Client(ClientConfig(), M2, device="cpu"), ServiceConfig(port=0),
        str(tmp_path / "cursor"), provers={"profile": capture})
    url = svc.start()
    try:
        out = tmp_path / "report.json"
        assert port_main(["profile", "--workload", "daemon", "--url", url,
                          "--seconds", "0.2", "--json", str(out)]) == 0
        meta = json.loads(out.read_text())["meta"]
        assert meta["workload"] == "daemon" and meta["seconds"] == 0.2
        assert meta["job_id"].startswith("job-") and "log_dir" in meta
    finally:
        assert svc.shutdown() is True


def test_serve_refuses_follow_until_the_follower_is_ported(tmp_path,
                                                           capsys,
                                                           monkeypatch):
    """``serve --follow`` runs the read replica: without a card and
    without ``--device cpu`` it exits 1 naming the flag before it
    touches the state dir; with ``--device cpu`` it runs as its own
    process, bootstraps from a live port leader, serves the leader's
    scores read-only and drains to exit 0 on SIGTERM."""
    from protocol_tpu_torch.client import Client, ClientConfig
    from protocol_tpu_torch.service import ServiceConfig, TrustService

    assets = tmp_path / "assets"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_main(["--assets", str(assets), "serve",
                      "--follow", "http://127.0.0.1:1"]) == 1
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--device cpu" in err
    assert not (assets / "service-state").exists()
    leader = TrustService(
        Client(ClientConfig(), M2, device="cpu"), ServiceConfig(port=0),
        str(tmp_path / "cursor"), provers={"echo": lambda p: p},
        state_dir=str(tmp_path / "leader-state"))
    url = leader.start()
    proc = subprocess.Popen(
        [sys.executable, "-m", "protocol_tpu_torch.cli", "--assets",
         str(assets), "serve", "--follow", url, "--port", "0",
         "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT),
                 PTPU_SERVE_POLL_INTERVAL="0.05"), cwd=tmp_path)
    try:
        line = proc.stdout.readline()
        assert "FOLLOWER listening on http://" in line, proc.stderr.read()
        assert "device: cpu" in line
        furl = line.split("listening on ")[1].split()[0]
        deadline = time.monotonic() + 30
        while True:
            with urllib.request.urlopen(furl + "/status", timeout=5) as r:
                status = json.loads(r.read())
            if status["repl"]["cursor"] is not None:
                break
            assert time.monotonic() < deadline, status
            time.sleep(0.05)
        assert status["role"] == "follower" and status["repl"]["leader"] == url
        assert (assets / "service-state").is_dir()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
        assert proc.returncode == 0 and "follower drained" in out, err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        assert leader.shutdown() is True


def test_threshold_proof_verbs_need_the_card_or_device_cpu(tmp_path,
                                                           capsys):
    """``th-proving-key`` and ``th-proof`` prove: with no card and no
    ``--device cpu`` each exits 1 naming the flag, before it reads an
    artifact or writes a key. ``th-verify`` is host work: without
    artifacts it fails on the missing file, not on the device."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    assets = ["--assets", str(tmp_path)]
    for argv in (["th-proving-key"],
                 ["th-proof", "--peer", "0x" + "11" * 20, "--threshold",
                  "500"]):
        assert port_main([*assets, *argv]) == 1
        err = capsys.readouterr().err
        assert "no CUDA device" in err and "--device cpu" in err, argv
    assert port_main([*assets, "th-verify"]) == 1
    err = capsys.readouterr().err
    assert "missing artifact" in err and "CUDA" not in err
    # with --device cpu th-proving-key gets past the device and stops on
    # the missing k = 21 SRS
    assert port_main([*assets, "th-proving-key", "--device", "cpu"]) == 1
    assert "CUDA" not in capsys.readouterr().err
    assert list(tmp_path.glob("th-*")) == []


@pytest.fixture(scope="module")
def et_evm_artifacts():
    """{transcript: {file name: bytes}}: k = 8 artifacts of a small
    circuit whose publics follow the two-peer EigenTrust layout (the
    reference's ``TestEvmVerifierVerb._et_shaped_fixture``; the files
    do not encode k, so the verbs run their real load, codegen and
    replay path), proved by the port under each transcript."""
    from protocol_tpu_torch.client.circuit_io import ETPublicInputs
    from protocol_tpu_torch.utils.fields import Fr
    from protocol_tpu_torch.zk.api import generate_kzg_params
    from protocol_tpu_torch.zk.gadgets import Chips
    from protocol_tpu_torch.zk.kzg import KZGParams
    from protocol_tpu_torch.zk.plonk import ConstraintSystem, keygen, prove

    addrs, scores = [11, 22], [700, 1300]
    c = Chips(ConstraintSystem(lookup_bits=4))
    x, y = c.witness(3), c.witness(4)
    s = c.add(x, y)
    c.lincomb([(2, x), (3, y), (1, s), (1, c.mul(x, y))], const=1)
    c.mul_add(x, y, s)
    c.range_check(c.witness(9), 4)
    c.cs.add_row([0, 0, 2, 3, 0, 0], q_mul_cd=1, q_const=-6)
    for v in addrs + scores + [42, 12345]:
        c.cs.public_input(v)
    c.cs.check_satisfied()
    params_b = generate_kzg_params(8, seed=b"cli-evm")
    params = KZGParams.from_bytes(params_b)
    pk = keygen(params, c.cs)
    pubs = ETPublicInputs(participants=[Fr(a) for a in addrs],
                          scores=[Fr(v) for v in scores], domain=Fr(42),
                          opinion_hash=Fr(12345)).to_bytes()
    return {tr: {"kzg-params-20.bin": params_b,
                 "et-proving-key.bin": pk.to_bytes(),
                 "et-proof.bin": prove(params, pk, c.cs, transcript=tr),
                 "et-public-inputs.bin": pubs}
            for tr in ("keccak", "poseidon")}


def _write_artifacts(tmp_path, arts, flip: int | None = None):
    for d in ("ref", "port"):
        (tmp_path / d).mkdir(exist_ok=True)
        for name, blob in arts.items():
            if name == "et-proof.bin" and flip is not None:
                blob = bytearray(blob)
                blob[flip] ^= 1
                blob = bytes(blob)
            (tmp_path / d / name).write_bytes(blob)


def _replay_line(out: str) -> str:
    return next(line for line in out.splitlines()
                if line.startswith("EVM replay"))


@pytest.mark.parametrize("proved,flip,rc", [("keccak", None, 0),
                                            ("keccak", 40, 1),
                                            ("poseidon", None, 1)])
def test_et_verifier_check_matches_the_reference(tmp_path, capsys,
                                                 et_evm_artifacts, proved,
                                                 flip, rc):
    """``et-verifier --check`` in both CLIs on the same artifacts: the
    same Yul file, the same verdict and gas. VALID on the keccak proof;
    INVALID on a flipped byte and on a poseidon proof replayed under the
    keccak verifier."""
    _write_artifacts(tmp_path, et_evm_artifacts[proved], flip)
    lines = []
    for main, d in ((ref_main, "ref"), (port_main, "port")):
        assert main(["--assets", str(tmp_path / d), "et-verifier",
                     "--shape", "tiny", "--transcript", "keccak",
                     "--check"]) == rc
        lines.append(_replay_line(capsys.readouterr().out))
    assert lines[0] == lines[1]
    assert ("INVALID" in lines[1]) is bool(rc) and "gas" in lines[1]
    same_file(tmp_path, "et-verifier.yul")
    if rc == 0:
        assert port_main(["--assets", str(tmp_path / "port"), "et-verify",
                          "--shape", "tiny", "--transcript", "keccak"]) == 0
        assert "VALID" in capsys.readouterr().out


def test_et_verifier_onchain_rpc_on_the_port_devnet(tmp_path, capsys,
                                                    monkeypatch,
                                                    et_evm_artifacts):
    """``--rpc``: deploy the verifier to the port's ``MockNode`` and
    verify the written proof on-chain through ``eth_call``; a tampered
    proof is rejected by the chain."""
    from protocol_tpu_torch.client.mocknode import MockNode

    monkeypatch.delenv("MNEMONIC", raising=False)
    _write_artifacts(tmp_path, et_evm_artifacts["keccak"])
    assets = ["--assets", str(tmp_path / "port")]
    node = MockNode()
    url = node.start()
    try:
        assert port_main([*assets, "et-verifier", "--shape", "tiny",
                          "--rpc", url]) == 0
        out = capsys.readouterr().out
        assert "on-chain verify" in out and "VALID" in out
        assert "INVALID" not in out and "keccak transcript" in out
        proof = bytearray((tmp_path / "port" / "et-proof.bin").read_bytes())
        proof[100] ^= 1
        (tmp_path / "port" / "et-proof.bin").write_bytes(bytes(proof))
        assert port_main([*assets, "et-verifier", "--shape", "tiny",
                          "--rpc", url]) == 1
        assert "INVALID" in capsys.readouterr().out
    finally:
        node.stop()
