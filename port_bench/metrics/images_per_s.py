"""images_per_s: images whose answers the window's sweeps completed,
over the window's seconds (host clock)."""


def read(run):
    return run.counts["images"] / run.counts["window_s"]
