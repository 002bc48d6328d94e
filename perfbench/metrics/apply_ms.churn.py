"""Mean wall of ``DeltaEngine.apply_deltas`` followed by a CUDA synchronise
(traced run, unprofiled requests)."""

from perfbench.harness import readers


def read(run):
    return readers.apply_ms(run)
