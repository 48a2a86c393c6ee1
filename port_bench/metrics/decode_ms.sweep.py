"""decode_ms.sweep: mean milliseconds of one call of the reader the
benchmark hands the sweep (the program's ``io.imread_gray_u8``), timed
around each call on the decode threads; nothing where nothing was
decoded."""


def read(run):
    n = run.counts.get("decodes", 0)
    return 1e3 * run.counts["decode_s"] / n if n else None
