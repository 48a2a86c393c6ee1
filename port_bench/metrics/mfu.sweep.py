"""mfu.sweep: the U-Net forwards' operations in the traced window
(``harness.flops.unet_flops`` at the centre crop, 202.2 GFLOP an image at
512^2, x the images the window completed) over the seconds the device
trace shows the card busy, as a share of the card's peak for the
configuration's dtype."""
from port_bench.harness import flops, readers


def read(run):
    per_image = flops.unet_flops(min(run.traffic["side"], 512), run.config)
    return readers.peak_share(run, per_image * run.counts["images"])
