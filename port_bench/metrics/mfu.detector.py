"""mfu.detector: the B0 forwards' operations in the traced window
(``harness.flops.b0_flops`` at the centre crop, 16.0 GFLOP an image at
512^2, x the images the window scored) over the seconds the device trace
shows the card busy, as a share of the card's peak for the
configuration's dtype."""
from port_bench.harness import flops, readers


def read(run):
    per_image = flops.b0_flops(min(run.traffic["side"], 512), run.config)
    return readers.peak_share(run, per_image * run.counts["images"])
