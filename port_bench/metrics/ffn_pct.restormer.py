"""ffn_pct.restormer: the share (%) of the traced window's busy device
time in operations launched while the driving thread was in a
``restormer.ffn`` span (each block's norm, gated depthwise feed-forward
and residual add), by the launches' correlation ids
(``harness.launches``); nothing untraced, where the program recorded no
spans, or where nothing ran on the card."""
from port_bench.harness import launches


def read(run):
    return launches.share_under(run, "restormer.ffn")
