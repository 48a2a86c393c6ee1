"""read_ms.sweep: mean milliseconds of one reader call on the decode
threads, from the program's own ``pipeline.read`` spans in the traced
window (``harness.program``): the in-program twin of ``decode_ms.sweep``;
nothing untraced, or where the program recorded none."""
from port_bench.harness import program


def read(run):
    return program.mean_ms(run, "pipeline.read")
