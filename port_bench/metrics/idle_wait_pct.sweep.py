"""idle_wait_pct.sweep: the share (%) of the traced window with nothing
on the card while the sweep's consumer waited for its next batch: the
device's idle gaps whose midpoint lies in a ``pipeline.wait`` span of the
driving thread (``harness.program``); nothing untraced, where the program
recorded nothing, or where nothing ran on the card."""
from port_bench.harness import program


def read(run):
    return program.idle_pct_under(run, {"pipeline.wait"})
