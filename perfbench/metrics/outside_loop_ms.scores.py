"""Mean of a request's wall minus its ``converge.edges`` span: the
operator's cast and upload, the start vector, the readback and the node
order (traced run, unprofiled requests)."""

from perfbench.harness import readers


def read(run):
    return readers.outside_loop_ms(run)
