"""What the EigenTrust converge entries share: the trust graph made from
the seed, the routed operator built on it, the counted edges and the
graph's statistics, and the stop rule of a request. Not an entry
itself.

The state of an entry holds ``graph``, the raw ``(n, src, dst, val,
valid)`` on the host. The counted edges (the reference's
``trust_edges``) are worked out only where they are asked for: in
set-up where the traffic draws from them, else after the window.
"""

from __future__ import annotations

import time

import numpy as np

from perfbench.harness import cell as cells
from perfbench.reference.eigentrust import trust_edges


def make_graph(ctx) -> tuple:
    """The configuration's raw graph from the seed, ``(n, src, dst,
    val, valid)``, every peer valid. The generator's device memory is
    freed and the peak reset, so ``memory_peak_bytes`` is the
    program's."""
    import torch

    cfg = ctx.config
    n, src, dst, val = cells.generator(cfg["generator"]).generate(
        cfg, ctx.seed, ctx.device)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(ctx.device)
    return n, src, dst, val, np.ones(n, dtype=bool)


def counted_edges(state) -> tuple:
    """The reference's counted edges of ``state["graph"]``, worked out
    once."""
    if "edges" not in state:
        state["edges"] = trust_edges(*state["graph"])
    return state["edges"]


def build_operator_timed(ctx, graph):
    """``build_routed_operator`` on the raw graph, timed (``info``'s
    ``plan_build_s``), with the plan's sizes recorded for the readers."""
    from protocol_tpu_torch.ops.routed import build_routed_operator

    t0 = time.perf_counter()
    op = build_routed_operator(*graph)
    ctx.info["plan_build_s"] = time.perf_counter() - t0
    ctx.info.update(edge_e=int(op.edge_e), state_e=int(op.state_e),
                    edge_stages=len(op.edge_stages),
                    state_stages=len(op.state_stages))
    return op


def reset_launches() -> None:
    """Zero the program's B1 launch counter: called at the end of
    set-up, so the window's launches are counted alone."""
    from protocol_tpu_torch.ops.kernels import lane_perm_kernel

    lane_perm_kernel.reset_launches()


def converged(cfg: dict, iters: int, delta: float) -> bool:
    """The adaptive loop stopped on its tolerance (as the program
    compares it, rounded to the configuration's dtype), not on its
    iteration cap."""
    import torch

    tol = float(torch.tensor(float(cfg["tol"]),
                             dtype=getattr(torch, cfg["dtype"])))
    return int(iters) < int(cfg["max_iterations"]) or float(delta) <= tol


def graph_stats(n: int, raw_edges: int, edges: tuple) -> dict:
    src, dst, _ = edges
    out_deg = np.bincount(src, minlength=n)
    in_deg = np.bincount(dst, minlength=n)

    def summary(d):
        return {"mean": float(d.mean()), "p50": float(np.percentile(d, 50)),
                "p99": float(np.percentile(d, 99)), "max": int(d.max())}

    return {
        "n": int(n),
        "edges_raw": int(raw_edges),
        "edges_counted": int(len(src)),
        "out_degree": summary(out_deg),
        "in_degree": summary(in_deg),
        "dangling_share": float(np.mean(out_deg == 0)),
        "isolated_share": float(np.mean((out_deg == 0) & (in_deg == 0))),
    }


def describe(ctx, state, requests) -> dict:
    """After the window: the graph's statistics (into ``info``, where
    the readers find ``n`` and ``edges_counted``) and the window's B1
    launches beside the plan's count for its sweeps."""
    from protocol_tpu_torch.ops.kernels import lane_perm_kernel

    n, src = state["graph"][0], state["graph"][1]
    ctx.info.update(graph_stats(n, len(src), counted_edges(state)))
    iters = sum(r["iterations"] for r in requests)
    return {"iterations": iters,
            "b1_launches": lane_perm_kernel.LAUNCHES["lane_perm"],
            "b1_launches_expected": iters * (ctx.info.get("edge_stages", 0)
                                             + ctx.info.get("state_stages",
                                                            0))}
