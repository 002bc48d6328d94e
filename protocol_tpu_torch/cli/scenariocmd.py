"""The ``scenario`` verb: the adversarial harness from the command line.

Three actions over the port's :mod:`scenarios` (``--device`` picks the
torch device of ``run``; the default is the card):

- ``list`` — the topology catalog with every tunable knob and default;
- ``run`` — one seeded {topology × semiring} run, JSON report on
  stdout (and ``--out``); byte-identical across runs of the same seed
  unless ``--timing`` opts into wall-clock fields;
- ``report`` — render a saved run JSON as a human-readable summary.

All output is JSON (list/run) so the smoke script shells out to the
same code path it would import.
"""

from __future__ import annotations

import json
import sys

from ..utils.errors import EigenError


def _dump(obj) -> str:
    return json.dumps(obj, sort_keys=True, indent=2)


def handle_scenario(args, files, config):
    from ..scenarios import list_scenarios, run_scenario

    if args.action == "list":
        print(_dump(list_scenarios()))
        return 0

    if args.action == "report":
        if not args.json:
            raise EigenError("validation_error",
                             "scenario report needs --json PATH")
        # resolve like `run --out`: relative paths live under assets
        # (falling back to the cwd so existing absolute-ish habits keep
        # working) — `run --out r.json` then `report --json r.json`
        # must round-trip
        from pathlib import Path

        path = Path(args.json)
        if not path.is_absolute() and not path.exists():
            path = files.assets / path
        try:
            with open(path) as f:
                report = json.load(f)
        except (OSError, ValueError) as e:
            raise EigenError("file_io_error",
                             f"cannot read report: {e}") from e
        r = report.get("robustness", {})
        disp = r.get("honest_rank_displacement", {})
        top = r.get("attackers_in_top", {})
        print(f"topology {report.get('topology')} "
              f"({report.get('peers')} peers, {report.get('edges')} edges, "
              f"{report.get('attackers')} attackers), "
              f"semiring {report.get('semiring')}, seed "
              f"{report.get('seed')}, engine {report.get('engine')}")
        print(f"  attacker mass capture: "
              f"{r.get('attacker_mass_capture', 0.0):.4f} "
              f"(baseline {r.get('baseline_attacker_mass', 0.0):.4f})")
        print(f"  honest rank displacement: mean {disp.get('mean', 0.0):.2f}, "
              f"max {disp.get('max', 0)}, moved "
              f"{disp.get('moved_fraction', 0.0):.2%}")
        print(f"  attackers in top {top.get('top')}: {top.get('count')}")
        bound = r.get("iteration_bound")
        within = ("n/a (alpha=0: no spectrum-free bound)"
                  if bound is None else
                  f"bound {bound} -> "
                  f"{'WITHIN' if r.get('within_bound') else 'EXCEEDED'}")
        print(f"  iterations: {r.get('iterations')} ({within})")
        return 0

    from .main import cli_device

    device = cli_device(args.device)
    try:
        report = run_scenario(
            args.topology, peers=args.peers,
            attacker_fraction=args.attacker_fraction,
            semiring=args.semiring, seed=args.seed, alpha=args.alpha,
            tol=args.tol, max_iterations=args.max_iterations,
            engine=args.engine, baseline=not args.no_baseline,
            timing=args.timing, device=device)
    except ValueError as e:
        raise EigenError("validation_error", str(e)) from e
    text = _dump(report)
    if args.out:
        from pathlib import Path

        out = Path(args.out)
        if not out.is_absolute():
            out = files.assets / out
        out.write_text(text + "\n")
        print(f"wrote {out}", file=sys.stderr)
    print(text)
    return 0
