"""images_per_s.detector: images the window's detector sweeps scored,
over the window's seconds (host clock)."""


def read(run):
    return run.counts["images"] / run.counts["window_s"]
