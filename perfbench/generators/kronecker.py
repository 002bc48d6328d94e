"""The Graph500 Kronecker generator (graph500.org, benchmark
specification, section "Graph Generation"), on a torch device.

It follows the specification's reference code, ``kronecker_generator``:
``M = edgefactor · 2^SCALE`` pairs; at each of SCALE levels one bit of
the row index is drawn as ``rand > A + B`` and one bit of the column as
``rand > (C / (1 − A − B) if the row bit is set else A / (A + B))``;
then the vertex labels are permuted at random and the pairs shuffled.
Each pair ``(u, v)`` is one attestation ``u → v`` with an integer value
uniform in ``[low, high]``. Self-loops and repeated pairs stay in: the
trust filter drops and merges them. Imports nothing of the program.

The draws run on ``device`` (the card, in a few large calls) from a
``torch.Generator`` seeded with the run's seed; the same seed on the
same kind of device gives the same graph.
"""

from __future__ import annotations

import numpy as np
import torch


def kronecker_edges(scale: int, edgefactor: int, a: float, b: float,
                    c: float, seed: int, device="cpu", low: int = 1,
                    high: int = 10, permute: bool = True):
    """``(src, dst, val)`` as host numpy arrays (int64, int64, float64).
    ``permute=False`` leaves out the label permutation and the shuffle
    (the pairs are drawn first either way, so they are the same pairs
    under other labels)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n = 1 << int(scale)
    m = int(edgefactor) * n
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for level in range(int(scale)):
        i_bit = torch.rand(m, generator=gen, device=device,
                           dtype=torch.float64) > ab
        thresh = torch.where(i_bit, c_norm, a_norm)
        j_bit = torch.rand(m, generator=gen, device=device,
                           dtype=torch.float64) > thresh
        src += i_bit.to(torch.int64) << level
        dst += j_bit.to(torch.int64) << level
        del i_bit, j_bit, thresh
    if permute:
        label = torch.randperm(n, generator=gen, device=device)
        order = torch.randperm(m, generator=gen, device=device)
        src = label[src][order]
        dst = label[dst][order]
        del label, order
    val = torch.randint(low, high + 1, (m,), generator=gen, device=device)
    return (src.cpu().numpy(), dst.cpu().numpy(),
            val.cpu().numpy().astype(np.float64))


def generate(cfg: dict, seed: int, device: str):
    """The configuration's graph, ``(n, src, dst, val)``: ``cfg`` holds
    ``scale``, ``edgefactor``, ``a``, ``b``, ``c``, ``low``, ``high``
    and ``permute_vertices``."""
    scale = int(cfg["scale"])
    return (1 << scale, *kronecker_edges(
        scale, int(cfg["edgefactor"]), float(cfg["a"]), float(cfg["b"]),
        float(cfg["c"]), seed, device=device, low=int(cfg["low"]),
        high=int(cfg["high"]), permute=bool(cfg["permute_vertices"])))
