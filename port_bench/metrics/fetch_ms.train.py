"""fetch_ms.train: mean milliseconds of fetching one training batch, from
asking the pipeline for it to its pixels and mask on the card: the
program's ``train.fetch`` spans in the traced window
(``harness.program``); nothing untraced, or where the program recorded
none."""
from port_bench.harness import program


def read(run):
    return program.mean_ms(run, "train.fetch")
