"""Operations and bytes of the benchmark's models and of kernel B1, from
the layer shapes in each configuration's file, and the card's published
peaks.

``unet_flops`` is copied from ``wsunet_tpu_torch.bench.unet_flops`` (2 x
the multiply-accumulates of one forward: the 3x3 convs, the 2x2 stride-2
transposed convs and the 1x1 head), so the yardstick stays here whatever
the program does to its copy.  ``b0_flops`` counts the EfficientNet-B0
detector the same way: every conv (stem, expand, depthwise, squeeze-excite,
project, head) and the classifier.  Both take the widths, stages and
switches from the configuration (``configs/<name>.json``), the one source
of the architecture.
"""

# NVIDIA H100 SXM data sheet, dense: f32 outside the tensor cores (TF32 is
# off on every f32 path of the port), bf16 on them, and HBM3 bandwidth.
# Keyed by a part of torch.cuda.get_device_name().
PEAKS = {
    "H100 80GB HBM3": {"float32": 67e12, "bfloat16": 989e12,
                       "bytes_per_s": 3.35e12},
}


def peaks(device_name: str):
    """The peaks of a card by its name, or None for a card not listed
    (then no share of a peak is reported)."""
    for key, value in PEAKS.items():
        if key in device_name:
            return value
    return None


def unet_flops(side: int, cfg: dict) -> int:
    """2 x the multiply-accumulates of one U-Net forward on a side x side
    image: ``cfg["widths"]`` are the encoder's widths, one a level."""
    w = cfg["widths"]
    nsteps = len(w) - 1
    px = [(side >> s) ** 2 for s in range(nsteps + 1)]
    macs = 9 * (cfg["in_channels"] * w[0] + w[0] * w[0]) * px[0] \
        + w[0] * cfg["out_channels"] * px[0]
    for s in range(1, nsteps + 1):
        macs += 9 * (w[s - 1] * w[s] + w[s] * w[s]) * px[s]        # e<s+1>
        macs += w[s] * w[s - 1] * 4 * px[s]                        # up<s>
        macs += 9 * (2 * w[s - 1] * w[s - 1] + w[s - 1] ** 2) * px[s - 1]
    return 2 * macs


def unet_conv3x3_layers(side: int, cfg: dict):
    """(C_in, C_out, H, W) of every 3x3 reflect conv of one U-Net forward,
    in launch order: the encoder's, then the decoder's."""
    w = cfg["widths"]
    nsteps = len(w) - 1
    layers = [(cfg["in_channels"], w[0], side, side),
              (w[0], w[0], side, side)]
    for s in range(1, nsteps + 1):
        h = side >> s
        layers += [(w[s - 1], w[s], h, h), (w[s], w[s], h, h)]
    for s in range(nsteps, 0, -1):
        h = side >> (s - 1)
        layers += [(2 * w[s - 1], w[s - 1], h, h), (w[s - 1], w[s - 1], h, h)]
    return layers


def conv3x3_bound_s(batch: int, cin: int, cout: int, h: int, w: int,
                    elem_bytes: int, flops_per_s: float,
                    bytes_per_s: float) -> float:
    """The least time of one reflect-padded 3x3 conv with bias (a B1
    launch): the larger of its operations over the peak and its bytes
    (input, weights and bias read once, output written once) over the
    bandwidth."""
    flops = 2.0 * batch * h * w * 9 * cin * cout
    nbytes = elem_bytes * (batch * h * w * (cin + cout) + 9 * cin * cout
                           + cout)
    return max(flops / flops_per_s, nbytes / bytes_per_s)


def unet_b1_bound_s(batch: int, side: int, cfg: dict, card: dict) -> float:
    """The summed bounds of the B1 launches of one forward, in the
    configuration's dtype."""
    dtype = cfg["dtype"]
    elem = 4 if dtype == "float32" else 2
    return sum(conv3x3_bound_s(batch, *layer, elem, card[dtype],
                               card["bytes_per_s"])
               for layer in unet_conv3x3_layers(side, cfg))


def b0_flops(side: int, cfg: dict) -> int:
    """2 x the multiply-accumulates of one EfficientNet-B0 forward on a
    side x side image (TensorFlow's SAME padding: ceil(size / stride)
    outputs): ``cfg["stages"]`` are (expand ratio, channels, repeats,
    stride, kernel) a stage, with the stem and head widths, the
    squeeze-excite ratio, the input planes, the stem's stride and
    quadratic channels, and the classes of the configuration."""
    size = side if cfg["no_stem_stride"] else -(-side // 2)
    stem = cfg["stem_width"]
    macs = 9 * cfg["in_channels"] * stem * size * size
    width = stem + (cfg["quadratic_width"] if cfg["quadratic_stem"] else 0)
    for t, c, n, s, k in cfg["stages"]:
        for b in range(n):
            stride = s if b == 0 else 1
            mid = width * t
            if t != 1:
                macs += width * mid * size * size
            size = -(-size // stride)
            macs += k * k * mid * size * size
            se = max(1, int(width * cfg["se_ratio"]))
            macs += 2 * mid * se
            macs += mid * c * size * size
            width = c
    head = cfg["head_width"]
    macs += width * head * size * size + head * cfg["num_classes"]
    return 2 * macs
