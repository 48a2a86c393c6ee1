"""mfu.train: the training steps' operations in the traced window, 3 x
the U-Net forward's at the crop (forward, data gradient, weight gradient)
x batch size x steps, over the seconds the device trace shows the card
busy, as a share of the card's peak for the configuration's dtype."""
from port_bench.harness import flops, readers


def read(run):
    per_image = 3 * flops.unet_flops(run.traffic["crop"], run.config)
    return readers.peak_share(run, per_image * run.counts["images"])
