"""Wall time of the window, from the first request's start to the last
one's end, over the converges completed in it (host clock)."""

from perfbench.harness import readers


def read(run):
    return readers.window_ms_per_request(run)
