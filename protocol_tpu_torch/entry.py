"""The flagship step on torch: twin of ``__graft_entry__.entry()``."""

from __future__ import annotations

import torch

from .device import resolve_device
from .graph import barabasi_albert_edges
from .ops.routed import build_routed_operator, converge_routed_fixed, routed_arrays


def entry(device=None):
    """``(forward, (arrs, s0))``: 20 Clos-routed damped power-iteration
    sweeps (α = 0.1) on the 4096-peer Barabási–Albert graph (m = 6,
    seed 42), float32. ``forward(arrs, s0)`` returns the state-order
    scores after the 20 sweeps."""
    device = resolve_device(device)
    n = 4096
    src, dst, val = barabasi_albert_edges(n, 6, seed=42)
    op = build_routed_operator(n, src, dst, val)
    arrs, static = routed_arrays(op, dtype=torch.float32, alpha=0.1,
                                 device=device)
    s0 = torch.from_numpy(op.initial_scores(1000.0)).to(device)

    def forward(arrs, s0):
        return converge_routed_fixed(arrs, static, s0, 20)

    return forward, (arrs, s0)
