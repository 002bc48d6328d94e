"""95th percentile of every refresh of the window (host clock)."""

from perfbench.harness import readers


def read(run):
    return readers.p95_wall_ms(run)
