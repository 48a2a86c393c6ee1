"""device_idle_pct.train: the share of the traced window with no
operation running on the card."""
from port_bench.harness.readers import idle_pct as read  # noqa: F401
