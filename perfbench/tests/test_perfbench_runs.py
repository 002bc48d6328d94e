"""Whole runs of each cell on the CPU at a small size, past the look for
a card: a sound run is correct, and a run with the timed path broken
underneath is not, once for each fault the cell can have:

- a sweep that returns its state unchanged;
- half of each revision batch left out (the churn cell);
- an answer altered where it is produced (one score off by 5 %).

The cells run on one chip, so there is no exchange between chips to
leave out.
"""

from __future__ import annotations

import numpy as np
import pytest

from perfbench.harness import cell as cells
from perfbench.harness.runner import run_cell

SMALL = {"ba1m.churn": {"n": 2000}, "kron20.scores": {"scale": 11}}
HELD_OUT = {"kron20.scores"}  # out of BENCHMARK.json, kept in held_out/
SECONDS = 0.4


def resolve(name: str) -> cells.Cell:
    return cells.resolve(
        name, cells.with_held_out(name) if name in HELD_OUT else None)


def run(name: str, trace: bool = False, seed: int = 2**31 + 99) -> dict:
    c = resolve(name)
    return run_cell(c, seed, SECONDS, trace, device="cpu",
                    config=dict(c.config, **SMALL[name]))


@pytest.fixture(autouse=True)
def few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(name, trace):
    out = run(name, trace)
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-2:] == ["check", "lines"]
    c = resolve(name)
    want = c.per_layer if trace else c.end_to_end
    assert set(out["metrics"]) <= {m["name"] for m in want}
    if not trace:
        assert set(out["metrics"]) == {m["name"] for m in want}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_unchanged_state_is_caught(name, monkeypatch):
    from protocol_tpu_torch.ops import routed

    monkeypatch.setattr(routed, "spmv_routed", lambda arrs, static, s: s)
    out = run(name)
    assert not out["correct"]


def test_half_batch_left_out_is_caught(monkeypatch):
    from protocol_tpu_torch.incremental.engine import DeltaEngine

    orig = DeltaEngine.apply_deltas

    def half(self, deltas, n=None):
        return orig(self, deltas[: len(deltas) // 2], n)

    monkeypatch.setattr(DeltaEngine, "apply_deltas", half)
    out = run("ba1m.churn")
    assert not out["correct"]
    assert out["check"]["max_rel"]["value"] > out["check"]["max_rel"]["limit"]


def _altered(fn):
    def wrapped(*args, **kwargs):
        out = np.array(fn(*args, **kwargs), copy=True)
        out[len(out) // 3] *= 1.05
        return out
    return wrapped


@pytest.mark.parametrize("name", sorted(SMALL))
def test_altered_answer_is_caught(name, monkeypatch):
    from protocol_tpu_torch.incremental.engine import DeltaEngine
    from protocol_tpu_torch.ops.routed import RoutedOperator

    monkeypatch.setattr(DeltaEngine, "scores_to_nodes",
                        _altered(DeltaEngine.scores_to_nodes))
    monkeypatch.setattr(RoutedOperator, "scores_for_nodes",
                        _altered(RoutedOperator.scores_for_nodes))
    out = run(name)
    assert not out["correct"]


def test_a_failing_request_ends_the_window_and_counts(monkeypatch):
    from protocol_tpu_torch.incremental.engine import DeltaEngine

    calls = {"n": 0}
    orig = DeltaEngine.apply_deltas

    def flaky(self, deltas, n=None):
        calls["n"] += 1
        if calls["n"] > 5:  # set-up's warm-up and two requests pass
            raise RuntimeError("planted")
        return orig(self, deltas, n)

    monkeypatch.setattr(DeltaEngine, "apply_deltas", flaky)
    out = run("ba1m.churn")
    assert not out["correct"]
    assert out["failed"] == 1 and out["attempted"] == 3


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_fails_the_cells_limits(name):
    """The control of ``perfbench/calibrate.py`` at a small size: the
    entry's control answers (the reference in bfloat16) in the
    program's place, on the cell's own traffic, judged by the same
    verdict as the program's answers, come out not correct."""
    from perfbench.harness.runner import Sample, judge, prepare, run_window

    c = resolve(name)
    ctx, entry, state, _ = prepare(c, 7, False, "cpu",
                                   dict(c.config, **SMALL[name]))
    sample = Sample(c.sample, np.random.default_rng([ctx.seed, 2]))
    reqs = run_window(ctx, entry, state, SECONDS, sample)
    entry.release(ctx, state)
    picks = sample.picks()
    idx = [i for i, _ in picks]
    refs = entry.reference(ctx, state, idx)
    ok, prog = judge(entry, c.limits, reqs, picks, refs)
    ctrl_ok, ctrl = judge(entry, c.limits, reqs,
                          list(zip(idx, entry.control(ctx, state, idx))),
                          refs)
    assert ok, prog
    assert not ctrl_ok, ctrl
    assert any(ctrl[k] > c.limits[k] for k in c.limits), ctrl
