"""Peaks of the card, and the bytes that each roofline share counts.

Peaks are NVIDIA's data sheet for one H100 SXM (80 GB HBM3), dense
rates, at the full 700 W power limit; a share is stated with the card's
power limit beside it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def sweep_min_bytes(info: dict) -> float:
    """The least bytes one power-iteration sweep needs, from the graph
    and not from any layout: each counted edge's 4-byte weight and
    4-byte source index read once, the score vector read once and the
    next one written once (4 bytes a peer each)."""
    return 8.0 * info["edges_counted"] + 8.0 * info["n"]


def b1_bytes_per_sweep(info: dict) -> float:
    """Bytes of kernel B1's launches in one routed sweep: every route
    stage reads each lane's float32 value and its uint8 index once and
    writes the value once (9 bytes a lane; 0.09015 ms at 3.35 TB/s for
    T = 262,144 rows of 128 lanes). The edge route runs
    ``edge_stages`` stages over ``2^edge_e`` lanes, the state route
    ``state_stages`` over ``2^state_e``."""
    lanes = (info["edge_stages"] * (1 << info["edge_e"])
             + info["state_stages"] * (1 << info["state_e"]))
    return 9.0 * lanes


def b1_launches_per_sweep(info: dict) -> int:
    return int(info["edge_stages"] + info["state_stages"])
