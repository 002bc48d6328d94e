"""Batch scoring as ``sparse-scores`` runs it on a graph whose routed
plan is cached: one client, closed loop.

Set-up makes the graph from the seed and builds the routed operator. A
request is one ``TorchRoutedBackend.converge_edges`` of the raw edge
list with that operator, adaptive, from the uniform start; it ends with
node-order scores on the host. The counted edges, which only the
reference reads, are worked out after the window.

Traffic parameters: ``warmup`` (converges in set-up).
"""

from __future__ import annotations

from perfbench.entries import _trust
from perfbench.reference.eigentrust import TrustGraph, stop_rule
from perfbench.reference.eigentrust import compare  # noqa: F401 (the entry's)

describe = _trust.describe
# the program's span around the adaptive loop, read in a traced run
LOOP_SPAN = "converge.edges"


def setup(ctx) -> dict:
    import torch
    from protocol_tpu_torch.backend import TorchRoutedBackend

    graph = _trust.make_graph(ctx)
    op = _trust.build_operator_timed(ctx, graph)
    backend = TorchRoutedBackend(dtype=getattr(torch, ctx.config["dtype"]),
                                 device=ctx.device)
    state = {"graph": graph, "op": op, "backend": backend}
    for _ in range(int(ctx.params["warmup"])):
        serve(ctx, state, draw(ctx, state))
    _trust.reset_launches()
    return state


def draw(ctx, state):
    return None


def serve(ctx, state, request):
    cfg = ctx.config
    n, src, dst, val, valid = state["graph"]
    scores, iters, delta = state["backend"].converge_edges(
        n, src, dst, val, valid, float(cfg["initial_score"]),
        int(cfg["max_iterations"]), tol=float(cfg["tol"]),
        alpha=float(cfg["alpha"]), operator=state["op"])
    return scores, {"iterations": int(iters), "delta": float(delta),
                    "ok": _trust.converged(cfg, iters, delta)}


def release(ctx, state) -> None:
    state.pop("op", None)
    state.pop("backend", None)


def reference(ctx, state, picks, precision: str = "float64") -> list:
    """Every request converges the same graph from the same start, so
    one reference answer serves every pick: float64 to its floor, or
    the control in ``precision`` with the configuration's tolerance."""
    cfg = ctx.config
    n, valid = state["graph"][0], state["graph"][4]
    graph = TrustGraph(n, *_trust.counted_edges(state), valid=valid,
                       alpha=float(cfg["alpha"]), device=ctx.device,
                       precision=precision)
    tol, cap = stop_rule(precision, cfg)
    s, _, _ = graph.fixed_point(float(cfg["initial_score"]), tol, cap)
    return [s for _ in picks]


def control(ctx, state, picks) -> list:
    """The control: the reference in bfloat16 in the program's place."""
    return reference(ctx, state, picks, "bfloat16")
