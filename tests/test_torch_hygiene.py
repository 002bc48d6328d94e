"""What holds the port apart from the reference and from the CPU:

- importing every module of ``protocol_tpu_torch`` (and ``chip_smoke``)
  brings in neither ``jax`` nor ``protocol_tpu``;
- an entry point given no device raises where there is no GPU, instead
  of running on the CPU;
- ``chip_smoke.py`` exits non-zero and prints no result without a GPU.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

def test_port_imports_neither_jax_nor_reference():
    """Every module of the package, found by walking it (so a new
    module cannot escape the check), and ``chip_smoke``."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import protocol_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__,\n"
        "                                              pkg.__name__ + '.')]\n"
        "for m in mods + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax'\n"
        "             or k.startswith(('jax.', 'jaxlib'))\n"
        "             or k == 'protocol_tpu' or k.startswith('protocol_tpu.'))\n"
        "print(json.dumps([mods, bad]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    mods, bad = json.loads(proc.stdout.strip().splitlines()[-1])
    assert bad == []
    for m in ("protocol_tpu_torch.ops.routed",
              "protocol_tpu_torch.ops.fieldops",
              "protocol_tpu_torch.ops.kernels.field_kernel",
              "protocol_tpu_torch.ops.secp_batch",
              "protocol_tpu_torch.ops.poseidon_batch",
              "protocol_tpu_torch.client.ingest",
              "protocol_tpu_torch.crypto.secp256k1",
              "protocol_tpu_torch.models.eigentrust",
              "protocol_tpu_torch.utils.trace",
              "protocol_tpu_torch.incremental.engine",
              "protocol_tpu_torch.incremental.device",
              "protocol_tpu_torch.cli.profilecmd",
              "protocol_tpu_torch.client.client",
              "protocol_tpu_torch.client.chain",
              "protocol_tpu_torch.client.eth",
              "protocol_tpu_torch.client.evm",
              "protocol_tpu_torch.client.mocknode",
              "protocol_tpu_torch.client.storage",
              "protocol_tpu_torch.client.circuit_io",
              "protocol_tpu_torch.client.att_station_bytecode",
              "protocol_tpu_torch.models.threshold",
              "protocol_tpu_torch.cli.fs",
              "protocol_tpu_torch.cli.bandada",
              "protocol_tpu_torch.cli.scenariocmd",
              "protocol_tpu_torch.scenarios.topologies",
              "protocol_tpu_torch.scenarios.metrics",
              "protocol_tpu_torch.scenarios.runner",
              "protocol_tpu_torch.utils.checkpoint",
              "protocol_tpu_torch.store.wal",
              "protocol_tpu_torch.store.snapshot",
              "protocol_tpu_torch.store.artifacts",
              "protocol_tpu_torch.store.state_store",
              "protocol_tpu_torch.service.config",
              "protocol_tpu_torch.service.state",
              "protocol_tpu_torch.service.tailer",
              "protocol_tpu_torch.service.refresh",
              "protocol_tpu_torch.service.recorder",
              "protocol_tpu_torch.service.pool",
              "protocol_tpu_torch.service.provers",
              "protocol_tpu_torch.service.replication",
              "protocol_tpu_torch.service.bundle",
              "protocol_tpu_torch.service.http_api",
              "protocol_tpu_torch.service.daemon",
              "protocol_tpu_torch.service.follower",
              "protocol_tpu_torch.zk.fabric",
              "protocol_tpu_torch.native.prover",
              "protocol_tpu_torch.ops.fieldops2",
              "protocol_tpu_torch.ops.ntt_tpu",
              "protocol_tpu_torch.zk.api",
              "protocol_tpu_torch.zk.bn254",
              "protocol_tpu_torch.zk.commit_engine",
              "protocol_tpu_torch.zk.domain",
              "protocol_tpu_torch.zk.ecc_chip",
              "protocol_tpu_torch.zk.ecdsa_chip",
              "protocol_tpu_torch.zk.eigentrust_circuit",
              "protocol_tpu_torch.zk.gadgets",
              "protocol_tpu_torch.zk.integer_chip",
              "protocol_tpu_torch.zk.kzg",
              "protocol_tpu_torch.zk.plonk",
              "protocol_tpu_torch.zk.poseidon_chip",
              "protocol_tpu_torch.zk.prover_fast",
              "protocol_tpu_torch.zk.prover_tpu",
              "protocol_tpu_torch.zk.shards",
              "protocol_tpu_torch.zk.transcript",
              "protocol_tpu_torch.zk.aggregator",
              "protocol_tpu_torch.zk.loader_chip",
              "protocol_tpu_torch.zk.threshold_circuit",
              "protocol_tpu_torch.zk.yul",
              "protocol_tpu_torch.zk.evm",
              "protocol_tpu_torch.ops.msm_device",
              "protocol_tpu_torch.crypto.edwards",
              "protocol_tpu_torch.crypto.eddsa",
              "protocol_tpu_torch.crypto.rescue_prime",
              "protocol_tpu_torch.crypto.merkle",
              "protocol_tpu_torch.crypto.tables.rescue_prime_bn254_5x5",
              "protocol_tpu_torch.zk.eddsa_chip",
              "protocol_tpu_torch.zk.rescue_chip",
              "protocol_tpu_torch.zk.merkle_chip"):
        assert m in mods


def test_port_sources_name_no_reference_import():
    for path in sorted((ROOT / "protocol_tpu_torch").rglob("*.py")):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "jax" not in s, (path, s)
                assert not s.startswith(("import protocol_tpu ",
                                         "from protocol_tpu ",
                                         "from protocol_tpu.",
                                         "import protocol_tpu.")), (path, s)


def test_entry_points_raise_without_gpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from protocol_tpu_torch import backend
    from protocol_tpu_torch.entry import entry
    from protocol_tpu_torch.graph import build_operator
    from protocol_tpu_torch.ops.converge import operator_arrays
    from protocol_tpu_torch.ops.routed import build_routed_operator, routed_arrays

    for cls in (backend.TorchDenseBackend, backend.TorchSparseBackend,
                backend.TorchRoutedBackend):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls()
    src, dst, val = np.array([0, 1, 2]), np.array([1, 2, 0]), np.ones(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        operator_arrays(build_operator(3, src, dst, val))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        routed_arrays(build_routed_operator(3, src, dst, val))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    from protocol_tpu_torch.cli.profilecmd import run_refresh_workload
    from protocol_tpu_torch.incremental import DeltaEngine

    op = build_routed_operator(3, src, dst, val)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeltaEngine.anchor(3, src, dst, val, None, op)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_refresh_workload(n=20)
    from protocol_tpu_torch.service import OpinionGraph, ServiceConfig
    from protocol_tpu_torch.service.refresh import ScoreRefresher

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScoreRefresher(OpinionGraph(), ServiceConfig())
    from protocol_tpu_torch.ops.msm_device import msm_device
    from protocol_tpu_torch.zk import prover_fast as pf
    from protocol_tpu_torch.zk.bn254 import G1_GEN
    from protocol_tpu_torch.zk.commit_engine import CommitEngine

    with pytest.raises(RuntimeError, match="no CUDA device"):
        msm_device([G1_GEN], [1])
    # the commit engine's device seam, given no msm_device
    monkeypatch.setenv("PTPU_MSM_DEVICE", "1")
    eng = CommitEngine(pf.setup_params_fast(3, seed=b"hygiene"))
    eng.submit_coeffs("c", np.ones((4, 4), dtype="<u8"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eng.flush()


def test_field_and_ingest_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from protocol_tpu_torch.client import ingest
    from protocol_tpu_torch.client.attestation import SignedAttestationData
    from protocol_tpu_torch.ops import secp_batch as sb
    from protocol_tpu_torch.ops.fieldops import FieldCtx, field_converge
    from protocol_tpu_torch.ops.poseidon_batch import (
        PoseidonBatch,
        get_poseidon_batch,
    )

    calls = [
        lambda: field_converge(FieldCtx(7), [[0, 1], [1, 0]], [1, 1], 1),
        lambda: get_poseidon_batch(),
        lambda: PoseidonBatch(),
        lambda: sb.recover_batch([1], [1], [0], [1]),
        lambda: sb.recover_submit([1], [1], [0], [1]),
        lambda: next(sb.recover_stream([([1], [1], [0], [1])])),
        lambda: sb.verify_batch([1], [1], [1], [(1, 1)]),
        lambda: next(ingest.hash_recover_pipeline([[[0]]], [([1], [1], [0])])),
        lambda: ingest.attestation_hashes_batch([SignedAttestationData()]),
        lambda: ingest.recover_signers_batch([SignedAttestationData()]),
        lambda: ingest.recover_signers_batch([]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_cli_without_device_fails_cleanly(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from protocol_tpu_torch.cli.main import main

    (tmp_path / "e.csv").write_text("0,1,1\n1,0,1\n")
    assert main(["--assets", str(tmp_path), "sparse-scores", "--edges",
                 "e.csv", "--n", "2"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "sparse-scores.csv").exists()


def test_client_and_scenario_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from protocol_tpu_torch.cli.profilecmd import run_scenario_workload
    from protocol_tpu_torch.client import Client, ClientConfig
    from protocol_tpu_torch.scenarios import run_scenario

    client = Client(ClientConfig(), "test test test test test test test "
                    "test test test test junk", batched_ingest=True)
    src, dst, val = np.array([0, 1]), np.array([1, 0]), np.ones(2)
    calls = [
        lambda: client.calculate_scores_sparse(2, src, dst, val, tol=1e-6),
        lambda: run_scenario("sybil-ring", peers=50),
        lambda: run_scenario_workload(peers=50),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_port_cli_opens_no_file_of_the_reference(tmp_path):
    """The port's CLI runs on its own copy of the demo assets and its own
    sources: with an audit hook on every file open, ``local-scores`` (a
    torch backend on the CPU), ``show`` and ``scenario list`` open
    nothing under ``protocol_tpu/``."""
    import shutil

    assets = tmp_path / "assets"
    shutil.copytree(ROOT / "protocol_tpu_torch" / "cli" / "assets", assets)
    code = (
        "import json, os, sys\n"
        "opened = []\n"
        "def hook(event, args):\n"
        "    if event == 'open' and isinstance(args[0], (str, bytes,\n"
        "                                              os.PathLike)):\n"
        "        opened.append(os.path.realpath(os.fsdecode(args[0])))\n"
        "sys.addaudithook(hook)\n"
        "from protocol_tpu_torch.cli.main import main\n"
        "a = sys.argv[1]\n"
        "rcs = [main(['--assets', a, 'local-scores', '--backend',\n"
        "             'torch-sparse', '--device', 'cpu']),\n"
        "       main(['--assets', a, 'show']),\n"
        "       main(['--assets', a, 'scenario', 'list'])]\n"
        "print(json.dumps([rcs, opened]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, str(assets)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    rcs, opened = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rcs == [0, 0, 0]
    assert any(p.endswith("scores.csv") for p in opened)
    reference = str((ROOT / "protocol_tpu").resolve()) + os.sep
    assert [p for p in opened if p.startswith(reference)] == []
    assert (assets / "scores.csv").read_bytes() == (
        ROOT / "protocol_tpu_torch" / "cli" / "assets" / "scores.csv"
    ).read_bytes()


def test_chip_smoke_refuses_to_run_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:  # a directory holding the script alone
            script.write_text((ROOT / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_lane_perm_refuses_a_device_it_has_no_kernel_for():
    from protocol_tpu_torch.ops.kernels import lane_perm

    x = torch.zeros(2, 128, device="meta")
    idx = torch.zeros(2, 128, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lane_perm(x, idx)


def test_concurrent_builds_share_one_library(tmp_path):
    """Several processes asking for one native library at once (the
    suite runs under several workers) get the same, complete file:
    one compiles under the lock, the others wait and load it."""
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("no g++")
    src = tmp_path / "probe.cpp"
    src.write_text('extern "C" int probe() { return 42; }\n')
    code = (
        "import ctypes, sys\n"
        "from pathlib import Path\n"
        "from protocol_tpu_torch._build import build_shared_library\n"
        "lib = build_shared_library('probe', Path(sys.argv[1]),\n"
        "    ['g++', '-shared', '-fPIC'], build_dir=Path(sys.argv[2]))\n"
        "assert ctypes.CDLL(str(lib)).probe() == 42\n"
        "print(lib)\n")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(src), str(tmp_path / "build")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(6)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(out.strip())
    assert len(set(outs)) == 1
    left = sorted(f.name for f in (tmp_path / "build").iterdir())
    lib = Path(outs[0])  # no temp files; the compiler's log beside it
    assert left == [".probe.lock", lib.with_suffix(".log").name, lib.name]


def test_prover_entry_points_raise_without_gpu():
    """The device prover, ``prove_fast_tpu`` and the profile verb's
    prove workload take the card unless told otherwise: with none they
    raise before any work."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from protocol_tpu_torch.cli.profilecmd import run_prove_workload
    from protocol_tpu_torch.zk import prover_fast as pf
    from protocol_tpu_torch.zk.prover_tpu import DeviceProver

    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceProver(3, 7, [], [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pf.DeviceProverCache().get(object())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_prove_workload(k=3)
    from protocol_tpu_torch.zk.api import generate_et_proof

    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_et_proof(b"", b"", None)
