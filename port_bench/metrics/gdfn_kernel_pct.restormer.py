"""gdfn_kernel_pct.restormer: the share (%) of the Restormer forwards'
gated FFNs in the traced window whose middle ran through kernel B4, from
the program's ``restormer.gdfn_kernel.hit`` and ``.miss`` counters
(``harness.program``); nothing untraced, or where neither was counted (a
program without them)."""
from port_bench.harness import program


def read(run):
    return program.hit_pct(run, "restormer.gdfn_kernel")
