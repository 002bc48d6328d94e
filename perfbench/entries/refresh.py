"""The trust daemon's refresh loop under churn, one writer.

Set-up makes the graph from the seed and its counted edges, from which
the traffic draws the revised attestations, builds the routed operator,
anchors a ``DeltaEngine`` on it and
runs one cold converge for the first published scores. A request is
one revision batch: ``DeltaEngine.apply_deltas`` and then
``DeltaEngine.converge`` from the published scores, which returns the
next published scores, node order, on the host. The batch is drawn
before the request's clock starts.

Traffic parameters: ``batch`` (revisions a request), ``low``/``high``
(new values), ``warmup`` (refreshes in set-up).
"""

from __future__ import annotations

import time

import numpy as np

from perfbench.entries import _trust
from perfbench.generators.churn import RevisionStream
from perfbench.reference.eigentrust import TrustGraph, stop_rule
from perfbench.reference.eigentrust import compare  # noqa: F401 (the entry's)

describe = _trust.describe
# the program's span around the adaptive loop, read in a traced run
LOOP_SPAN = "converge.edges"


def setup(ctx) -> dict:
    import torch
    from protocol_tpu_torch.incremental.engine import DeltaEngine

    cfg, p = ctx.config, ctx.params
    graph = _trust.make_graph(ctx)
    n, src, dst, val, valid = graph
    state = {"graph": graph}
    edges = _trust.counted_edges(state)
    op = _trust.build_operator_timed(ctx, graph)
    eng = DeltaEngine.anchor(n, src, dst, val, valid, op,
                             dtype=getattr(torch, cfg["dtype"]),
                             alpha=float(cfg["alpha"]), device=ctx.device)
    cold, iters, _ = eng.converge(
        eng.initial_node_scores(float(cfg["initial_score"])),
        int(cfg["max_iterations"]), float(cfg["tol"]))
    ctx.info["cold_iterations"] = int(iters)
    state.update(
        eng=eng, op=op, published=cold, batches=[],
        stream=RevisionStream(*edges, rng=ctx.rng, batch=int(p["batch"]),
                              low=int(p["low"]), high=int(p["high"])))
    for _ in range(int(p["warmup"])):
        serve(ctx, state, draw(ctx, state))
    state["warm"] = len(state["batches"])
    _trust.reset_launches()
    return state


def draw(ctx, state):
    batch = state["stream"].next_batch()
    # kept for the check as one array: a list of tuples a batch would
    # grow the heap that the collector scans inside the window
    state["batches"].append(np.asarray(batch, dtype=np.float64))
    return batch


def serve(ctx, state, batch):
    import torch

    cfg = ctx.config
    eng = state["eng"]
    rec = {}
    with ctx.recorder.phase("apply"):
        t0 = time.perf_counter()
        ok = eng.apply_deltas(batch)
        if ctx.trace:
            if ctx.device.type == "cuda":
                torch.cuda.synchronize(ctx.device)
            rec["apply_s"] = time.perf_counter() - t0
    if not ok:
        raise RuntimeError("the delta engine refused a revision batch "
                           f"({eng.stats.rebuild_reason})")
    scores, iters, delta = eng.converge(state["published"],
                                        int(cfg["max_iterations"]),
                                        float(cfg["tol"]))
    state["published"] = scores
    rec.update(iterations=int(iters), delta=float(delta),
               ok=_trust.converged(cfg, iters, delta))
    return scores, rec


def release(ctx, state) -> None:
    for key in ("eng", "op", "published"):
        state.pop(key, None)


def reference(ctx, state, picks, precision: str = "float64") -> list:
    """Answers of the plain reference at the window's requests
    ``picks`` (ascending): the counted edges of set-up revised by every
    batch up to that request, iterated from the previous answer. In
    float64 to its floor; as the control, in ``precision`` with the
    configuration's tolerance."""
    cfg = ctx.config
    n, valid = state["graph"][0], state["graph"][4]
    # the set-up's counted edges: the stream revised its own copy
    graph = TrustGraph(n, *_trust.counted_edges(state), valid=valid,
                       alpha=float(cfg["alpha"]), device=ctx.device,
                       precision=precision)
    tol, cap = stop_rule(precision, cfg)
    out, done, s = [], 0, None
    for i in picks:
        upto = state["warm"] + i + 1
        for batch in state["batches"][done:upto]:
            graph.revise(batch)
        done = upto
        s, _, _ = graph.fixed_point(float(cfg["initial_score"]), tol, cap,
                                    s0=s)
        out.append(s)
    return out


def control(ctx, state, picks) -> list:
    """The control: the reference in bfloat16 in the program's place."""
    return reference(ctx, state, picks, "bfloat16")
