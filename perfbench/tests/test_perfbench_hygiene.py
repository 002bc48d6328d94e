"""Nothing the benchmark runs imports JAX or the JAX package, and the
yardstick (reference, generators) imports nothing of the program. Top
level names are compared whole: ``protocol_tpu_torch`` is not
``protocol_tpu``."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "protocol_tpu"}


def imported_top_levels(path: Path) -> set:
    """Top-level names of every absolute import in a file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.add(node.module.split(".", 1)[0])
    return names


def sources(*parts) -> list:
    files = sorted(BENCH.joinpath(*parts).rglob("*.py"))
    assert files
    return files


def test_no_file_imports_jax_or_the_jax_package():
    for f in sources():
        bad = imported_top_levels(f) & FORBIDDEN
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


def test_yardstick_imports_nothing_of_the_program():
    for part in ("reference", "generators"):
        for f in sources(part):
            bad = imported_top_levels(f) & (FORBIDDEN | {"protocol_tpu_torch"})
            assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


def test_names_are_compared_whole():
    sys.path.insert(0, str(BENCH))
    try:
        import run
    finally:
        sys.path.remove(str(BENCH))
    saved = dict(sys.modules)
    try:
        sys.modules["protocol_tpu_torch_x"] = sys
        assert "protocol_tpu" not in run.forbidden_modules()
        sys.modules["protocol_tpu.ops"] = sys
        assert run.forbidden_modules() == ["protocol_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax():
    """A whole run of a cell on the CPU at a small size, in a fresh
    process: the modules it leaves loaded hold none of the forbidden."""
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from perfbench.harness import cell as cells
from perfbench.harness.runner import run_cell
c = cells.resolve("ba1m.churn")
cfg = dict(c.config, n=2000)
out = run_cell(c, 5, 0.3, True, device="cpu", config=cfg)
sys.path.insert(0, {str(BENCH)!r})
import run
print(json.dumps({{"correct": out["correct"], "bad": run.forbidden_modules(),
                   "torch_port": "protocol_tpu_torch" in sys.modules}}))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "bad": [], "torch_port": True}
