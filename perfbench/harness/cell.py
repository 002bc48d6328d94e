"""Finds every piece of a cell by name.

``BENCHMARK.json`` names a cell's configuration, traffic mix and chips,
and the metrics it reports. The pieces live in files named after them:

- ``configs/<config>.json``: the deployment's sizes, the generator of
  its data and its settings (the file ``BENCHMARK.json`` gives for the
  configuration);
- ``generators/<generator>.py``: ``generate(cfg, seed, device)``;
- ``traffic/<mix>.json``: the mix's parameters, and the ``entry`` that
  serves its requests;
- ``entries/<entry>.py``: the system under test: set-up from the seed,
  one request, and the reference's answers and the comparison for the
  check (see ``harness.runner.run_cell``);
- ``metrics/<metric>.py``: ``read(run)``, the metric's value or None;
- ``workloads/<cell>.json``: the cell's correctness limits.

So a configuration, a mix, a cell or a metric is added by adding files
and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, name: str):
    """Import a file by its path, under ``name``: the files are named
    after metrics and cells, whose names may hold dots."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    sample: int
    end_to_end: list   # BENCHMARK.json metric entries this cell reports
    per_layer: list

    @property
    def entry(self) -> str:
        return self.traffic["entry"]


def applies(metric: dict, cell: str, end_to_end: bool) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed in the metric's
    ``workloads``. An end-to-end metric without the key (``setup_s``)
    is every cell's; a per-layer metric has to list its cells."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if end_to_end:
        return True
    raise KeyError(f"per-layer metric {metric['name']!r} lists no "
                   "workloads")


def resolve(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, or of ``bench``, a dict
    of its form (the tests add a held-out cell's entries to it)."""
    if bench is None:
        bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have: "
                       f"{sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    e2e = [m for m in bench["end_to_end"] if applies(m, name, True)]
    per_layer = [m for m in bench["per_layer"] if applies(m, name, False)]
    local = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=load_json(ROOT / cfg_entry["file"]),
        traffic=load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        limits=dict(local["limits"]),
        sample=int(local.get("sample", 6)),
        end_to_end=e2e,
        per_layer=per_layer,
    )


def with_held_out(name: str) -> dict:
    """``BENCHMARK.json`` with the entries of ``held_out/<name>.json``
    added: a cell taken out of the benchmark, kept with its pieces so
    that it can come back as entries alone. A metric that both name
    reports in the cells of both."""
    bench = load_json(ROOT / "BENCHMARK.json")
    extra = load_json(BENCH_DIR / "held_out" / f"{name}.json")
    for key, entries in extra.items():
        have = {e["name"]: e for e in bench[key]}
        for e in entries:
            if e["name"] in have and "workloads" in e:
                have[e["name"]]["workloads"] += e["workloads"]
            else:
                bench[key].append(e)
    return bench


def generator(name: str):
    return load_module(BENCH_DIR / "generators" / f"{name}.py",
                       f"perfbench_generator_{name}")


def entry(name: str):
    return load_module(BENCH_DIR / "entries" / f"{name}.py",
                       f"perfbench_entry_{name}")


def metric_reader(name: str):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py",
                       f"perfbench_metric_{name}").read
