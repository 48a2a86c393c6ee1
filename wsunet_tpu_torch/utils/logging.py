"""Stdout logging setup (port of ``wsunet_tpu/utils/logging.py``,
unchanged; parity: reference src/_defs/defs.py:24-34)."""

import logging
import sys


def setup_logger(name: str, level: int = logging.DEBUG) -> logging.Logger:
    """Create a stdout logger with timestamped format.

    Mirrors the reference's ``setup_custom_logger`` behaviour: DEBUG-level
    stream handler on stdout with ``asctime - name - levelname - message``.
    """
    logger = logging.getLogger(name)
    if logger.handlers:  # idempotent
        return logger
    handler = logging.StreamHandler(sys.stdout)
    handler.setLevel(level)
    handler.setFormatter(logging.Formatter(
        fmt="%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
    logger.setLevel(level)
    logger.addHandler(handler)
    return logger
