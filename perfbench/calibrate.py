"""The readings that the correctness limits of a cell are set from,
and the control's verdict at the cell's own size.

    python3 perfbench/calibrate.py --workload <cell> --seconds <s> --seeds 1 2 3 ...

For each seed, in one process: the cell's set-up, a window of
``--seconds`` at the cell's own load, and the verdict on its sampled
answers against the float64 reference (the program's readings); then
the control, the entry's ``control`` answers (the reference in the
precision below the configuration's) in the program's place at the same
requests, judged by the same call, ``runner.judge``, with the cell's
limits (the control's readings and its ``correct``, which has to come
out false). One JSON line a seed, then the largest program reading and
the smallest control reading of each number, and whether every program
verdict was true and every control verdict false. The benchmark's own
runs do not run this. Needs the cell's CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from perfbench.harness import cell as cells
    from perfbench.harness.runner import (
        Sample, free_device, judge, prepare, run_window)

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = cells.resolve(args.workload)
    prog_max, ctrl_min, verdicts = {}, {}, []
    for seed in args.seeds:
        ctx, entry, state, _ = prepare(cell, seed, False, "cuda")
        sample = Sample(cell.sample, np.random.default_rng([ctx.seed, 2]))
        reqs = run_window(ctx, entry, state, args.seconds, sample)
        entry.describe(ctx, state, reqs)
        entry.release(ctx, state)
        free_device(ctx.device)
        picks = sample.picks()
        idx = [i for i, _ in picks]
        refs = entry.reference(ctx, state, idx)
        ok, prog = judge(entry, cell.limits, reqs, picks, refs)
        ctrl_picks = list(zip(idx, entry.control(ctx, state, idx)))
        ctrl_ok, ctrl = judge(entry, cell.limits, reqs, ctrl_picks, refs)
        verdicts.append((ok, ctrl_ok))
        for k in prog:
            prog_max[k] = max(prog_max.get(k, 0.0), prog[k])
            ctrl_min[k] = min(ctrl_min.get(k, float("inf")), ctrl[k])
        print(json.dumps({"seed": seed, "requests": len(reqs),
                          "failed": sum(not r["ok"] for r in reqs),
                          "iterations": [r["iterations"] for r in reqs][:50],
                          "picks": idx, "correct": ok, "program": prog,
                          "control_correct": ctrl_ok, "control": ctrl,
                          "limits": cell.limits}), flush=True)
        del ctx, entry, state, refs, picks, ctrl_picks, sample
        free_device(torch.device("cuda"))
    print(json.dumps({"workload": cell.name, "seeds": args.seeds,
                      "program_max": prog_max, "control_min": ctrl_min,
                      "limits": cell.limits,
                      "every_program_correct": all(v[0] for v in verdicts),
                      "every_control_incorrect": not any(v[1]
                                                         for v in verdicts)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
