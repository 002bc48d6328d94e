"""Reproducible scenario runner — one seeded {topology × semiring} run.

This is the single engine behind the port's ``scenario`` CLI verb and
``chip_smoke.py``'s scenario phase: build a seeded adversarial topology,
converge it through the ConvergeBackend seam under the requested
semiring, converge the attack-free baseline (same graph with every
attacker-incident edge dropped), and score the outcome with
:mod:`.metrics`.

The port of ``protocol_tpu/scenarios/runner.py``: the backends are the
torch ones (``TorchRoutedBackend`` runs the route-stage kernel on every
stage of both routes), built on the caller's ``device`` (None means the
card, and raises without one).

The default report is **byte-identical across runs of the same seed on
the same box**: every field is a pure function of (topology params,
seed, semiring, solver knobs). Wall-clock timing is opt-in
(``timing=True``) and lands in a separate key the CLI excludes by
default, precisely so ``scenario run ... --seed 7`` twice diffs clean.
"""

from __future__ import annotations

import inspect
import time

import numpy as np

from ..utils import trace
from .metrics import robustness_report
from .topologies import TOPOLOGIES, build_topology

SCENARIO_SCHEMA = "ptpu-scenario-v1"

# Above this edge count the gather-SpMV working set outgrows the sparse
# path's sweet spot and the Clos-routed operator (one-time plan build,
# then streaming-bandwidth sweeps) wins; below it the routed plan build
# dominates a one-shot scenario run.
ROUTED_EDGE_THRESHOLD = 20_000_000


def list_scenarios() -> list[dict]:
    """Catalog of topologies: name, one-line description, tunable knobs
    with their defaults (everything ``scenario run`` accepts)."""
    out = []
    for name, builder in sorted(TOPOLOGIES.items()):
        sig = inspect.signature(builder)
        doc = (builder.__doc__ or "").strip().splitlines()[0]
        out.append({
            "topology": name,
            "description": doc,
            "defaults": {p.name: p.default for p in sig.parameters.values()},
        })
    return out


def _resolve_engine(engine: str, n_edges: int) -> str:
    if engine == "auto":
        return "routed" if n_edges >= ROUTED_EDGE_THRESHOLD else "sparse"
    if engine not in ("sparse", "routed"):
        raise ValueError(f"unknown engine {engine!r} "
                         "(have: auto, sparse, routed)")
    return engine


def _make_backend(engine: str, device=None):
    from ..backend import TorchRoutedBackend, TorchSparseBackend

    return (TorchRoutedBackend if engine == "routed"
            else TorchSparseBackend)(device=device)


def run_scenario(topology: str, peers: int = 10_000,
                 attacker_fraction: float = 0.1, semiring=None,
                 seed: int = 0, alpha: float = 0.1, tol: float = 1e-6,
                 max_iterations: int = 100, engine: str = "auto",
                 baseline: bool = True, timing: bool = False,
                 initial_score: float = 1000.0, device=None,
                 **topology_kwargs) -> dict:
    """Run one adversarial scenario end to end and return the report.

    ``baseline=True`` additionally converges the attack-free control —
    the same edge list with every attacker-incident edge removed — so
    the robustness block can measure rank displacement and captured
    mass against what the honest graph alone would have produced.
    Topologies with no attackers (``smallworld``) are their own
    baseline and skip the second converge. ``device`` is the torch
    device of the converges (None: the card).
    """
    from ..ops.converge import resolve_semiring

    sr = resolve_semiring(semiring)
    build_kwargs = dict(peers=peers, seed=seed, **topology_kwargs)
    if topology != "smallworld":
        build_kwargs["attacker_fraction"] = attacker_fraction
    t_build = time.perf_counter()
    graph = build_topology(topology, **build_kwargs)
    build_s = time.perf_counter() - t_build

    n_edges = len(graph.src)
    eng = _resolve_engine(engine, n_edges)
    backend = _make_backend(eng, device)
    valid = np.ones(graph.n, dtype=bool)

    trace.counter("scenario_runs").inc(topology=topology)
    with trace.span("scenario.run", topology=topology, semiring=sr.name,
                    peers=graph.n, edges=n_edges, engine=eng):
        t_run = time.perf_counter()
        scores, iters, delta = backend.converge_edges(
            graph.n, graph.src, graph.dst, graph.val, valid,
            initial_score, max_iterations, tol=tol, alpha=alpha,
            semiring=sr)
        attack_s = time.perf_counter() - t_run

        t_base = time.perf_counter()
        if baseline and graph.n_attackers:
            keep = ~(graph.attacker[graph.src] | graph.attacker[graph.dst])
            base_scores, base_iters, _ = backend.converge_edges(
                graph.n, graph.src[keep], graph.dst[keep],
                graph.val[keep], valid, initial_score, max_iterations,
                tol=tol, alpha=alpha, semiring=sr)
        else:
            base_scores, base_iters = scores, iters
        baseline_s = time.perf_counter() - t_base

    report = {
        "schema": SCENARIO_SCHEMA,
        "topology": topology,
        "peers": int(graph.n),
        "edges": int(n_edges),
        "attackers": int(graph.n_attackers),
        "semiring": sr.name,
        "seed": int(seed),
        "alpha": float(alpha),
        "tol": float(tol),
        "max_iterations": int(max_iterations),
        "engine": eng,
        "params": {k: v for k, v in graph.params.items()},
        "scores": {
            "iterations": int(iters),
            "residual": float(delta),
            "baseline_iterations": int(base_iters),
        },
        "robustness": robustness_report(
            scores, base_scores, graph.attacker, int(iters),
            alpha, tol),
    }
    if timing:
        report["timing_s"] = {
            "build": build_s,
            "attack_converge": attack_s,
            "baseline_converge": baseline_s,
        }
    return report
