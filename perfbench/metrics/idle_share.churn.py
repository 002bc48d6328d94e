"""Share of the profiled window in which no kernel and no copy ran on the
device (union of intervals)."""

from perfbench.harness import readers


def read(run):
    return readers.idle_share(run)
