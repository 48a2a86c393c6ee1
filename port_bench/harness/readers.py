"""What several metric readers share."""


def idle_pct(run):
    """The share of the traced window, in %, with no operation running on
    the card; nothing in an untraced run."""
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def peak_share(run, flop: float):
    """``flop`` operations, the window's model work, over the seconds in
    which the device trace has an operation running on the card
    (``busy_s``), as a share (%) of the card's peak for the
    configuration's dtype: how well the model's device work uses the card,
    apart from the time the host leaves it idle (``device_idle_pct.*``).
    Nothing in an untraced run, on a card without listed peaks, or where
    nothing ran on the card."""
    if run.trace is None or run.peaks is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * flop / run.trace.busy_s / run.peaks[run.config["dtype"]]
