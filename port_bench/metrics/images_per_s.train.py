"""images_per_s.train: training images the window's steps took (batch
size x steps), over the window's seconds (host clock)."""


def read(run):
    return run.counts["images"] / run.counts["window_s"]
