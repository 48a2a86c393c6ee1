"""dw_kernel_pct.detector: the share (%) of the B0 forwards' MBConv blocks
in the traced window whose depthwise stage ran through kernel B3, from
the program's ``b0.dw_kernel.hit`` and ``.miss`` counters
(``harness.program``); nothing untraced, or where neither was counted (a
program without them)."""
from port_bench.harness import program


def read(run):
    return program.hit_pct(run, "b0.dw_kernel")
