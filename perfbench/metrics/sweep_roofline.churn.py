"""Least bytes of one sweep (harness.roofline.sweep_min_bytes) at 3.35 TB/s
over the device busy time per sweep inside the ``converge.edges`` spans
(profiled requests)."""

from perfbench.harness import readers


def read(run):
    return readers.sweep_roofline(run)
