"""Summed time of the window's refreshes over the refreshes completed (host
clock; the traffic draw is not timed)."""

from perfbench.harness import readers


def read(run):
    return readers.mean_wall_ms(run)
