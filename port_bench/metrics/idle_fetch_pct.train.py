"""idle_fetch_pct.train: the share (%) of the traced window with nothing
on the card while the trainer fetched its next batch: the device's idle
gaps whose midpoint lies in a ``train.fetch`` span of the driving thread
(its children ``pipeline.wait``, ``pipeline.upload`` and ``train.mask``
lie inside it; ``harness.program``); nothing untraced, where the program
recorded nothing, or where nothing ran on the card."""
from port_bench.harness import program


def read(run):
    return program.idle_pct_under(run, {"train.fetch"})
