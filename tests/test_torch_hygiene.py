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

_MODULES = [
    "protocol_tpu_torch",
    "protocol_tpu_torch.graph",
    "protocol_tpu_torch.native",
    "protocol_tpu_torch.ops",
    "protocol_tpu_torch.ops.kernels",
    "protocol_tpu_torch.ops.converge",
    "protocol_tpu_torch.ops.clos",
    "protocol_tpu_torch.ops.routed",
    "protocol_tpu_torch.backend",
    "protocol_tpu_torch.entry",
    "protocol_tpu_torch.cli",
    "protocol_tpu_torch.cli.main",
    "chip_smoke",
]


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax'\n"
        "             or k.startswith(('jax.', 'jaxlib'))\n"
        "             or k == 'protocol_tpu' or k.startswith('protocol_tpu.'))\n"
        "print(json.dumps(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


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


def test_entry_points_raise_without_gpu():
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


def test_cli_without_device_fails_cleanly(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from protocol_tpu_torch.cli.main import main

    (tmp_path / "e.csv").write_text("0,1,1\n1,0,1\n")
    assert main(["--assets", str(tmp_path), "sparse-scores", "--edges",
                 "e.csv", "--n", "2"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "sparse-scores.csv").exists()


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
    assert left == [".probe.lock", Path(outs[0]).name]  # no temp files
