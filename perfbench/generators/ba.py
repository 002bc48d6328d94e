"""Barabási–Albert trust graph, frozen.

A copy of ``protocol_tpu_torch.graph.barabasi_albert_edges`` as it
stood when the benchmark was defined, kept here so that a change to the
program cannot change the benchmark's graph. A test holds the two equal
bit for bit at a small size. Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np


def barabasi_albert_edges(n: int, m: int, seed: int = 0, low: int = 1,
                          high: int = 10):
    """Preferential attachment by the repeated-nodes trick, in chunks:
    each new node attaches to ``m`` targets drawn from the endpoint pool
    of all edges so far. Returns ``(src, dst, val)`` with both
    directions attested and integer values uniform in ``[low, high]``
    (float64). Self-loops and duplicates are left in: the trust filter
    drops and merges them."""
    rng = np.random.default_rng(seed)
    seed_nodes = np.arange(m + 1)
    src0 = np.repeat(seed_nodes, m)
    dst0 = np.concatenate([np.delete(seed_nodes, i) for i in range(m + 1)])

    n_edges = len(src0) + (n - (m + 1)) * m
    src = np.empty(n_edges, dtype=np.int64)
    dst = np.empty(n_edges, dtype=np.int64)
    pool = np.empty(2 * n_edges, dtype=np.int64)
    src[: len(src0)] = src0
    dst[: len(dst0)] = dst0
    pool[: len(src0)] = src0
    pool[len(src0): 2 * len(src0)] = dst0
    e_fill, p_fill = len(src0), 2 * len(src0)

    next_node = m + 1
    chunk = max(1024, n // 256)
    while next_node < n:
        count = min(chunk, n - next_node)
        new_nodes = np.arange(next_node, next_node + count)
        targets = pool[rng.integers(0, p_fill, size=(count, m))]
        s = np.repeat(new_nodes, m)
        d = targets.reshape(-1)
        src[e_fill: e_fill + count * m] = s
        dst[e_fill: e_fill + count * m] = d
        pool[p_fill: p_fill + count * m] = s
        pool[p_fill + count * m: p_fill + 2 * count * m] = d
        e_fill += count * m
        p_fill += 2 * count * m
        next_node += count
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    val = rng.integers(low, high + 1, size=len(src)).astype(np.float64)
    return src, dst, val


def generate(cfg: dict, seed: int, device: str):
    """The configuration's graph, ``(n, src, dst, val)``: ``cfg`` holds
    ``n``, ``m``, ``low`` and ``high``. Host work (numpy); ``device`` is
    not used."""
    n = int(cfg["n"])
    return (n, *barabasi_albert_edges(n, int(cfg["m"]), seed=seed,
                                      low=int(cfg["low"]),
                                      high=int(cfg["high"])))
