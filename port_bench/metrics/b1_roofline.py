"""b1_roofline: kernel B1's share of its roofline in the traced window:
the summed bounds of its launches (``harness.flops.conv3x3_bound_s``: the
larger of a launch's operations over the dtype's peak and its bytes,
read once and written once, over the bandwidth) over the summed device
time of those launches.  The launches are the trace's B1 kernels
(``fma_kernel``, ``direct_kernel``, ``wgmma_kernel``), one a 3x3 conv of
each full-batch forward in layer order; nothing when there are none, or
when their count is not a whole number of forwards."""
import re

from port_bench.harness import flops

B1 = re.compile(r"\(anonymous namespace\)::(fma|direct|wgmma)_kernel\b")


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    times = [s for name, s in run.trace.kernels if B1.search(name)]
    side = min(run.traffic["side"], 512)
    layers = flops.unet_conv3x3_layers(side, run.config)
    if not times or len(times) % len(layers):
        return None
    bound = flops.unet_b1_bound_s(run.traffic["batch_size"], side,
                                  run.config, run.peaks)
    return 100.0 * bound * (len(times) // len(layers)) / sum(times)
