"""device_cache_hit_pct.detector: the share (%) of the batches looked up
in the pipeline's device cache that were there, from the program's
``pipeline.device_cache.hit`` and ``.miss`` counters in the traced window
(``harness.program``); nothing untraced, or where none was counted."""
from port_bench.harness import program


def read(run):
    return program.hit_pct(run, "pipeline.device_cache")
