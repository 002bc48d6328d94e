"""The benchmark of the PyTorch and CUDA port, one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA cards.
The cell, its configuration, traffic mix and metrics are found by name
through ``BENCHMARK.json`` (see ``perfbench/harness/cell.py``). The run
sets up, measures for ``--seconds``, checks the answers of the window
against the plain reference in ``perfbench/reference/`` and prints, as
its last line on standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``check``, each compared number
with its limit. The compared numbers are also the last lines on
standard error. Without the cards it exits 2 and prints no result.
"""

from __future__ import annotations

import time

PROCESS_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "protocol_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark may not
    load, compared whole (``protocol_tpu_torch`` is not
    ``protocol_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return proc.stdout.strip().splitlines()[0] if proc.stdout.strip() \
        else "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench.harness import cell as cells

    cell = cells.resolve(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("perfbench: no CUDA device; this benchmark runs only on the "
              "card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA devices, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import protocol_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"perfbench: the program is not in this checkout ({e})",
              file=sys.stderr)
        return 3

    from perfbench.harness.runner import run_cell

    card = power_limit()
    print(json.dumps({"perfbench": "card", "card": card}), flush=True)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   device="cuda", process_t0=PROCESS_T0)
    out["device"]["power_limit"] = card
    for line in out.pop("lines"):
        print(json.dumps(line), flush=True)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    for name, c in out["check"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
