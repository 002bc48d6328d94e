"""Incremental operator maintenance — edge churn without O(graph) work.

The port of ``protocol_tpu/incremental``. A full routed-operator build
pays the routing-plan compile (minutes at 10M peers); this package sits
between an edge-change log and the converge backends and absorbs churn
in O(dirty) instead:

- :class:`engine.DeltaEngine` — anchors on one full routed build and
  classifies every edge change as **weight revision** (patch the
  bucketed-ELL value buffer in place), **structural insert/remove**
  (a bounded COO overflow tail the matvec folds in), or **row
  dirtying** (re-normalize only the dirty rows through a per-source
  ``inv_row_scale`` vector) — the routing plan itself never changes
  until the tail outgrows its budget;
- :mod:`partial` — the host partial-refresh mode (a copy of the
  reference's): power-iteration sweeps restricted to the dirty
  frontier plus its fan-in, warm-started from the published vector;
- :mod:`device` — the device twin (``device_partial_refresh``, through
  ``ops.converge.partial_sweep_device``), the partially-observed
  ``sampled_refresh`` mode, and ``ladder_refresh``, the sublinear ladder
  ``partial → device_partial → sampled``; the caller's remaining rungs
  are a full converge on the patched operator, then a rebuild.
"""

from .device import (
    device_partial_refresh,
    ladder_refresh,
    sampled_refresh,
)
from .engine import DeltaEngine, DeltaStats, revision_batch
from .partial import PartialResult, as_frontier_array, partial_refresh

__all__ = [
    "DeltaEngine",
    "DeltaStats",
    "PartialResult",
    "as_frontier_array",
    "device_partial_refresh",
    "ladder_refresh",
    "partial_refresh",
    "revision_batch",
    "sampled_refresh",
]
