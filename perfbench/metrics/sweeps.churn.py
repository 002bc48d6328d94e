"""Adaptive-loop iterations per refresh, over the window."""

from perfbench.harness import readers


def read(run):
    return readers.sweeps_per_request(run)
