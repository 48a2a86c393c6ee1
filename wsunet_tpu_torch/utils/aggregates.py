"""Named pandas aggregators for the error-box tables (copy of
``wsunet_tpu/utils/aggregates.py``).

The emitted ``__name__`` strings (``q_50``, ``q_25_iqr``, ...) are
golden-CSV column contracts — pandas uses the aggregator's name as the
output column, and the reference's error-box artifacts
(src/_defs/defs.py:77-92) key on exactly these strings.  The semantics
are the classic box-plot statistics: a plain quantile, and a whisker at
``quantile(n) + sign * IQR`` clamped to the sample range.
"""


def _named(fn, n, suffix=""):
    fn.__name__ = f"q_{round(n * 100)}{suffix}"
    return fn


def quantile(n):
    """Aggregator for the ``n``-th quantile, named ``q_<100n>``."""
    return _named(lambda x: x.quantile(n), n)


def iqr_interval(n, sign=1):
    """Whisker aggregator named ``q_<100n>_iqr``: the ``n``-th quantile
    offset by ``sign`` interquartile ranges, clamped to the observed
    min/max (so a whisker never extends past the data)."""

    def whisker(x):
        q1, q3 = x.quantile(.25), x.quantile(.75)
        return (x.quantile(n) + sign * (q3 - q1)).clip(x.min(), x.max())

    return _named(whisker, n, "_iqr")
