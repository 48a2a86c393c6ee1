"""batch_wait_ms.sweep: mean milliseconds the sweep's consumer waited
for its next batch, from the program's ``pipeline.wait`` spans (one a
batch) in the traced window (``harness.program``); nothing untraced, or
where the program recorded none."""
from port_bench.harness import program


def read(run):
    return program.mean_ms(run, "pipeline.wait")
