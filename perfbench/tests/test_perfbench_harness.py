"""BENCHMARK.json against the benchmark's contract, every piece found by
name, and the run without a card."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_lines():
    every = ([c["name"] for c in SPEC["configs"]]
             + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    for name in every:
        assert NAME.match(name), name
    assert len({w["name"] for w in SPEC["workloads"]}) == len(SPEC["workloads"])
    assert len({c["name"] for c in SPEC["configs"]}) == len(SPEC["configs"])
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES


def test_end_to_end_bounds():
    names = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in names and 2 <= len(names) <= 16
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m


def reports(cell: str, metric: dict) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_per_layer_metrics_list_their_cells():
    from perfbench.harness import cell as cells

    for m in SPEC["per_layer"]:
        assert m["workloads"], m["name"]
        assert set(m["workloads"]) <= {w["name"] for w in SPEC["workloads"]}
    with pytest.raises(KeyError):
        cells.applies({"name": "x", "moves": "setup_s"}, "ba1m.churn", False)
    assert cells.applies({"name": "setup_s"}, "any.cell", True)


def test_every_cell_resolves_by_name():
    from perfbench.harness import cell as cells

    for w in SPEC["workloads"]:
        check_cell(cells.resolve(w["name"]))


@pytest.mark.parametrize(
    "name", sorted(p.stem for p in (BENCH / "held_out").glob("*.json")))
def test_held_out_cell_comes_back_as_entries(name):
    """A cell taken out of BENCHMARK.json keeps its entries in
    ``held_out/<cell>.json``: added back, they name nothing that
    BENCHMARK.json has, keep the contract's forms, and resolve."""
    from perfbench.harness import cell as cells

    extra = json.loads((BENCH / "held_out" / f"{name}.json").read_text())
    assert [w["name"] for w in extra["workloads"]] == [name]
    for key in ("configs", "workloads"):
        assert not ({e["name"] for e in extra[key]}
                    & {e["name"] for e in SPEC[key]})
    for m in extra["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in extra["per_layer"]:
        assert m["workloads"] == [name] and LINE.match(m["layer"])
    bench = cells.with_held_out(name)
    assert {w["name"] for w in bench["workloads"]} == (
        {w["name"] for w in SPEC["workloads"]} | {name})
    check_cell(cells.resolve(name, bench))


def check_cell(c) -> None:
    from perfbench.harness import cell as cells

    assert (BENCH / "generators" / f"{c.config['generator']}.py").exists()
    assert (BENCH / "entries" / f"{c.entry}.py").exists()
    entry = cells.entry(c.entry)
    for hook in ("setup", "draw", "serve", "release", "describe",
                 "reference", "control", "compare"):
        assert callable(getattr(entry, hook)), (c.entry, hook)
    assert set(c.limits) == {"rel_l1", "max_rel"}
    assert all(v > 0 for v in c.limits.values())
    for m in c.end_to_end + c.per_layer:
        assert callable(cells.metric_reader(m["name"]))
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer




def test_each_config_file_is_one_configs():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("perfbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        for key in c["reduced"]:
            assert key in cfg and key in cfg["source_values"]


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        for cell in m["workloads"]:
            assert reports(cell, e2e[m["moves"]]), (m["name"], cell)
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    for base, names in layers.items():
        assert len(names) == 1, (base, names)


def test_run_without_a_card_exits_non_zero_and_prints_no_metric():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "ba1m.churn",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    assert proc.returncode != 0
    assert "metrics" not in proc.stdout and "correct" not in proc.stdout
    assert "no CUDA device" in proc.stderr


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_metric_files_are_named_after_metrics(cell):
    names = {p.name[:-3] for p in (BENCH / "metrics").glob("*.py")}
    wanted = {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]
              if reports(cell, m)}
    assert wanted <= names
