"""Attestation churn: batches of weight revisions of existing edges.

A batch is ``batch`` distinct edges drawn uniformly from the filtered
edge list, each with a new integer value uniform in ``[low, high]``,
given as ``(src, dst, old, new)`` tuples where ``old`` is the edge's
current value. The draw costs O(batch): indices are drawn with
replacement and repeats are drawn again, never a permutation of the
whole edge list. Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np


class RevisionStream:
    """Successive revision batches over one filtered edge list. ``val``
    is copied and kept current, so ``old`` is always the value the edge
    holds after every earlier batch."""

    def __init__(self, src, dst, val, rng: np.random.Generator,
                 batch: int, low: int = 1, high: int = 10):
        if batch > len(src):
            raise ValueError(f"a batch of {batch} is more than the "
                             f"{len(src)} edges")
        self.src = np.asarray(src, dtype=np.int64)
        self.dst = np.asarray(dst, dtype=np.int64)
        self.val = np.array(val, dtype=np.float64)
        self.rng = rng
        self.batch = int(batch)
        self.low = int(low)
        self.high = int(high)

    def draw_indices(self) -> np.ndarray:
        """``batch`` distinct edge indices, in the order first drawn."""
        need = self.batch
        idx = np.zeros(0, dtype=np.int64)
        while len(idx) < need:
            more = self.rng.integers(0, len(self.src), size=need)
            cand = np.concatenate([idx, more])
            _, first = np.unique(cand, return_index=True)
            idx = cand[np.sort(first)][:need]
        return idx

    def next_batch(self) -> list:
        idx = self.draw_indices()
        new = self.rng.integers(self.low, self.high + 1,
                                size=len(idx)).astype(np.float64)
        old = self.val[idx]
        self.val[idx] = new
        return list(zip(self.src[idx].tolist(), self.dst[idx].tolist(),
                        old.tolist(), new.tolist()))
