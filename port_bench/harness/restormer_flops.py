"""Operations of one Restormer forward, from the configuration's widths
(``configs/restormer_gray.json``): 2 x the multiply-accumulates of every
conv (3x3, depthwise 3x3 and 1x1, the pixel (un)shuffles' convs included)
and of the attention's two batched matmuls, q k^T and attn v, each
(C / heads)^2 x H W a head.  Norms, softmax, GELU, the gate and the
residual adds are not counted (``FlopCounterMode`` counts none of them
either).  At 512^2 the published configuration does 1,237.7 GFLOP an
image: 1,126.6 in convs, 111.1 in the attention's matmuls."""


def _block_macs(c: int, heads: int, expansion: float, px: int) -> int:
    hidden = int(c * expansion)
    attention = (c * 3 * c + 9 * 3 * c + 2 * c * c // heads + c * c) * px
    ffn = (c * 2 * hidden + 9 * 2 * hidden + hidden * c) * px
    return attention + ffn


def restormer_flops(side: int, cfg: dict) -> int:
    """2 x the multiply-accumulates of one forward on a side x side image
    (side a multiple of 8, as the sweep's 512^2 crop is)."""
    dim, blocks, heads = cfg["dim"], cfg["num_blocks"], cfg["heads"]
    f = cfg["ffn_expansion_factor"]
    px = [(side >> level) ** 2 for level in range(4)]
    c = [dim << level for level in range(4)]
    macs = 9 * cfg["inp_channels"] * dim * px[0]                 # patch_embed
    for level in range(4):                                       # encoder
        macs += blocks[level] * _block_macs(c[level], heads[level], f,
                                            px[level])
    for level in range(3):                                       # down
        macs += 9 * c[level] * c[level] // 2 * px[level]
    for level in (3, 2, 1):                                      # up
        macs += 9 * c[level] * 2 * c[level] * px[level]
    macs += 2 * c[2] * c[2] * px[2] + 2 * c[1] * c[1] * px[1]  # reduce_chan
    for level in (2, 1):                                         # decoders
        macs += blocks[level] * _block_macs(c[level], heads[level], f,
                                            px[level])
    macs += (blocks[0] + cfg["num_refinement_blocks"]) * _block_macs(
        c[1], heads[0], f, px[0])                                # level 1
    macs += 9 * c[1] * cfg["out_channels"] * px[0]               # output
    return 2 * macs
