"""``converge.edges`` span time over its iterations, host-paced (traced
run, unprofiled requests)."""

from perfbench.harness import readers


def read(run):
    return readers.sweep_ms(run)
