"""Kernel B1's bytes (harness.roofline.b1_bytes_per_sweep) at 3.35 TB/s
over B1's device time by kernel name (profiled requests)."""

from perfbench.harness import readers


def read(run):
    return readers.b1_roofline(run)
