"""mfu.restormer: the Restormer forwards' operations in the traced window
(``harness.restormer_flops`` at the centre crop, 1,237.7 GFLOP an image
at 512^2, x the images the window completed) over the seconds the device
trace shows the card busy, as a share of the card's peak for the
configuration's dtype (``readers.peak_share``)."""
from port_bench.harness import readers
from port_bench.harness.restormer_flops import restormer_flops


def read(run):
    per_image = restormer_flops(min(run.traffic["side"], 512), run.config)
    return readers.peak_share(run, per_image * run.counts["images"])
