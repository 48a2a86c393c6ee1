"""b3_roofline: kernel B3's share of its roofline in the traced window:
the summed bounds of its launches over their summed device time.  The
launches are the trace's ``mbconv_dw_kernel`` kernels, one for the
depthwise stage of each of the 16 MBConv blocks of a full-batch B0
forward, in block order; nothing when there are none, or when their count
is not a whole number of forwards.

A launch's bound is its bytes over the card's bandwidth (B3 does at most
about 6 f32 operations a byte, under the ridge): x read once, y written
once, the k*k taps, the 4 vectors of each batch norm (the expand norm's
too, except in stage 0, which has no expand) and the sums written once,
4 bytes each.  The blocks, their widths and their input sizes come from
the configuration's ``stages`` (TensorFlow's SAME: ceil(size / stride)
outputs), at the traffic's batch and centre crop."""
import re

B3 = re.compile(r"\bmbconv_dw_kernel\b")


def blocks(side: int, cfg: dict) -> list:
    """(C, H, k, stride, prologue) of the depthwise stage of every MBConv
    block of one forward on a side x side image, in launch order."""
    size = side if cfg["no_stem_stride"] else -(-side // 2)
    width = cfg["stem_width"] + (cfg["quadratic_width"]
                                 if cfg["quadratic_stem"] else 0)
    out = []
    for t, c, n, s, k in cfg["stages"]:
        for b in range(n):
            stride = s if b == 0 else 1
            out.append((width * t, size, k, stride, t != 1))
            size = -(-size // stride)
            width = c
    return out


def forward_bytes(batch: int, side: int, cfg: dict) -> int:
    """The summed bytes of B3's launches in one forward."""
    total = 0
    for C, H, k, stride, prologue in blocks(side, cfg):
        Ho = -(-H // stride)
        total += 4 * (batch * C * (H * H + Ho * Ho) + k * k * C
                      + (8 if prologue else 4) * C + batch * C)
    return total


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    times = [s for name, s in run.trace.kernels if B3.search(name)]
    side = min(run.traffic["side"], 512)
    n = len(blocks(side, run.config))
    if not times or len(times) % n:
        return None
    bound = forward_bytes(run.traffic["batch_size"], side, run.config) / \
        run.peaks["bytes_per_s"]
    return 100.0 * bound * (len(times) // n) / sum(times)
